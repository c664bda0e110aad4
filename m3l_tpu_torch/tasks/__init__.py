from .attentive_pooler import AttentiveClassifier, AttentivePooler  # noqa: F401
from .probes import ForceLinearProbe, GraspLinearProbe, PoseLinearProbe, SlipForceProbe, SlipProbe, TextileLinearProbe  # noqa: F401
from .sl_module import EncoderWrapper, SLModuleBase, load_encoder_from_checkpoint  # noqa: F401
from .modules import ForceSLModule, GraspSLModule, PoseSLModule, SlipSLModule, TextileSLModule, smooth_l1, weighted_ce  # noqa: F401
from .forcefield import ForceFieldDecoder, ForceFieldModule, photometric_loss, ssim, warp  # noqa: F401
from .forcefield_geometry import (  # noqa: F401
    GeometricForceFieldModule,
    PoseDecoder,
    PoseEstimator,
    backproject_depth,
    compute_sl_force,
    digit_intrinsics,
    disp_to_depth,
    grid_sample,
    plot_quiver,
    plot_quiver_img,
    project_3d,
    rot_from_axisangle,
    transformation_from_parameters,
)
