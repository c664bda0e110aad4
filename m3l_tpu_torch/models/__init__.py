from .vtt import VTT, PatchEmbed, VTTConfig  # noqa: F401
from .vtmae import VTMAE  # noqa: F401
from .multimodal_vtt import MultimodalVTT  # noqa: F401
from .multimodal_transformer import MultimodalMAEDecoder, MultimodalTransformer  # noqa: F401
from .baselines import AlexNetEncoder, ResNet18Encoder  # noqa: F401
from .vtmae_cnn import VTMAECnn  # noqa: F401
from .dinov2_interop import (  # noqa: F401
    DINOv2Backbone,
    DINOv2LinearSegHead,
    dinov2_vits14,
    load_torch_dinov2_state,
    load_torch_linear_seg_head,
)
