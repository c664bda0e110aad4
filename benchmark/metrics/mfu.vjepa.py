"""% of the card's dense peak that the V-JEPA steps' model operations take over the window, the
operations counted a step at a time from its token counts (``counting_vjepa.py``)."""
from benchmark import readers


def read(readings):
    return readers.model_flops_utilization(readings)
