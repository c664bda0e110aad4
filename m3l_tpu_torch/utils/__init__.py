from .device import f32_numerics, resolve_device  # noqa: F401
from .obs import vt_load  # noqa: F401
