from .masking import ModalMask, gather_tokens, random_modal_masking, restore_tokens  # noqa: F401
from .patches import patchify, unpatchify  # noqa: F401
from .posenc import sincos_2d, sincos_nd  # noqa: F401
