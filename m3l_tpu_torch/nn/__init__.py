from .early_cnn import EarlyCNN  # noqa: F401
from .flash_attention import flash_attention_qkv, flash_attention_qkv_reference  # noqa: F401
from .transformer import Attention, FeedForward, Transformer  # noqa: F401
from .gumbel_vq import GumbelVectorQuantizer  # noqa: F401
