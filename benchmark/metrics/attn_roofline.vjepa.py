"""% of its roofline that the packed attention pair reaches in the V-JEPA step: the encoders' 16
heads of 64 at 1,568 tokens and the context's length, the predictor's 16 heads of 24, each call's
work counted at its true heads x head size."""
from benchmark import readers


def read(readings):
    return readers.attention_roofline(readings)
