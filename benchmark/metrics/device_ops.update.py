"""Device operations per PPO+MAE minibatch update (the update loop's launches)."""
from benchmark import readers


def read(readings):
    return readers.device_ops_per(readings, "updates_traced")
