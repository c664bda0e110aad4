"""Host ms a batch of clips in the loader's next(), from the benchmark's span around it."""
from benchmark import readers


def read(readings):
    return readers.span_ms(readings, "loader")
