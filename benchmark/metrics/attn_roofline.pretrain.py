"""% of its roofline that the packed attention pair (f32 bodies) reaches in the DINO step."""
from benchmark import readers


def read(readings):
    return readers.attention_roofline(readings)
