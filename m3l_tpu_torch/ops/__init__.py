from .patches import patchify, unpatchify  # noqa: F401
from .posenc import sincos_2d  # noqa: F401
