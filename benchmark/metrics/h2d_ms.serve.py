"""Device ms of host-to-device copies per request (the raw observations)."""
from benchmark import readers


def read(readings):
    return readers.h2d_ms_per(readings, "requests_traced")
