"""% of its roofline that the packed attention pair reaches in the update loop."""
from benchmark import readers


def read(readings):
    return readers.attention_roofline(readings)
