from .schedulers import warmup_cosine_schedule, cosine_wd_schedule, linear_schedule, teacher_temp_schedule  # noqa: F401
from .masks import sample_block_masks, sample_block_masks_constrained, random_tube_masks  # noqa: F401
from .ema import ema_update  # noqa: F401
from .losses import (  # noqa: F401
    dino_cross_entropy,
    ibot_patch_loss,
    ibot_patch_loss_all_pairs,
    koleo_loss,
    sinkhorn_knopp_teacher,
    softmax_center_teacher,
    update_center,
)
from .module import SSLModule, WDSplitAdamW, as_float_image, default_wd_split_optimizer, wd_mask  # noqa: F401
from .decoders import DecoderViT, MaskDecoderViT, MaskedQueryDecoderViT  # noqa: F401
from .mae import MAEModule  # noqa: F401
from .dino import DINOModule  # noqa: F401
from .dinov2 import DINOv2Module  # noqa: F401
from .ijepa import IJEPAModule  # noqa: F401
