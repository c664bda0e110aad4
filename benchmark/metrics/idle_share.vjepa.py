"""% of the traced V-JEPA steps in which the card ran nothing."""
from benchmark import readers


def read(readings):
    return readers.idle_share(readings)
