from .buffer import RolloutBuffer  # noqa: F401
from .gae import compute_gae  # noqa: F401
from .policy import MLP, ActorCritic, MAEFeatures  # noqa: F401
from .ppo_mae import PPOMAE  # noqa: F401
from .replay import DeviceReplayBuffer, ReplayBuffer  # noqa: F401
from .sac_mae import SACMAE  # noqa: F401
from .sac_policy import Actor, Critic, QNet, SACActorCritic  # noqa: F401
from .vecnorm import RewardNormalizer, RunningMeanStd  # noqa: F401
from .frozen_features import FrozenEncoderFeatures  # noqa: F401
from .dino_fusion_features import DinoCatMAEFeatures  # noqa: F401
