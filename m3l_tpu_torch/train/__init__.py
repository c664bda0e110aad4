from .optim import FlatAdam  # noqa: F401
