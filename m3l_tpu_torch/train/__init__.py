from .optim import FlatAdam  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .checkpoint import save_checkpoint, load_checkpoint, latest_checkpoint  # noqa: F401
