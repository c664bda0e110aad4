from .vtt import VTT, PatchEmbed, VTTConfig  # noqa: F401
from .vtmae import VTMAE  # noqa: F401
from .multimodal_vtt import MultimodalVTT  # noqa: F401
from .multimodal_transformer import MultimodalMAEDecoder, MultimodalTransformer  # noqa: F401
from .baselines import AlexNetEncoder, ResNet18Encoder  # noqa: F401
