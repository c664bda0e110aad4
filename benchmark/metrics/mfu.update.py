"""% of the card's dense peak that the update phase's model operations take."""
from benchmark import readers


def read(readings):
    return readers.model_flops_utilization(readings)
