"""% of the card's dense peak that the DINO steps' model operations take over the window."""
from benchmark import readers


def read(readings):
    return readers.model_flops_utilization(readings)
