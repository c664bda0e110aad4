from .optim import FlatAdam, FlatAdamW, GradientChain  # noqa: F401
from .trainer import Trainer  # noqa: F401
from .checkpoint import save_checkpoint, load_checkpoint, latest_checkpoint  # noqa: F401
from .distributed import get_local_rank, get_world_size, initialize_distributed, is_main_process, slurm_requeue  # noqa: F401
