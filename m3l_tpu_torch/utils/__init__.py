from .device import f32_numerics, resolve_device  # noqa: F401
from .obs import vt_load  # noqa: F401
from .misc import AverageMeter, create_ndgrid, quaternion_multiply, quaternion_apply, quaternion_conjugate, axis_angle_to_quaternion, quaternion_to_axis_angle  # noqa: F401
