from .attentive_pooler import AttentiveClassifier, AttentivePooler  # noqa: F401
from .probes import ForceLinearProbe, GraspLinearProbe, PoseLinearProbe, SlipForceProbe, SlipProbe, TextileLinearProbe  # noqa: F401
from .sl_module import EncoderWrapper, SLModuleBase, load_encoder_from_checkpoint  # noqa: F401
from .modules import ForceSLModule, GraspSLModule, PoseSLModule, SlipSLModule, TextileSLModule, smooth_l1, weighted_ce  # noqa: F401
