from .schedulers import warmup_cosine_schedule, cosine_wd_schedule, linear_schedule, teacher_temp_schedule  # noqa: F401
from .module import SSLModule, WDSplitAdamW, as_float_image, default_wd_split_optimizer, wd_mask  # noqa: F401
from .decoders import DecoderViT, MaskDecoderViT, MaskedQueryDecoderViT  # noqa: F401
from .mae import MAEModule  # noqa: F401
