from .factory import make_env  # noqa: F401
from .fake import FakeInsertionEnv  # noqa: F401
from .spaces import Box, Dict  # noqa: F401
from .shm_vec import SharedMemoryVecEnv  # noqa: F401
from .vec import SubprocVecEnv, SyncVecEnv, make_vec_env  # noqa: F401
from .touch_press import TouchPressEnv  # noqa: F401
from .wrappers import AddTactile, FrameStack, RenderImageObservation, ResizeDict  # noqa: F401
