from .vtt import VTT, PatchEmbed, VTTConfig  # noqa: F401
from .vtmae import VTMAE  # noqa: F401
