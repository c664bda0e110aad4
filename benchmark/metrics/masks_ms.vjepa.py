"""Host ms a step in the program's span ``vjepa.masks`` (both generators' multi-block masks drawn on
the CPU and copied to the card), over the traced steps; nothing where the program has no such span."""
from benchmark import readers


def read(readings):
    return readers.span_ms(readings, "vjepa.masks")
