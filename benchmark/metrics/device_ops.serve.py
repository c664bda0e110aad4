"""Device operations per request."""
from benchmark import readers


def read(readings):
    return readers.device_ops_per(readings, "requests_traced")
