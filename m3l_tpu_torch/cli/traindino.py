"""PPO over frozen DINOv2 features on the card (counterpart of ``m3l_tpu/cli/traindino.py``, the
reference's ``trainDINO.py``): the training CLI's flags at n_envs 64, frame stack 1, dim 384 and
rollout 32768, plus ``--dinov2_weights`` and ``--device`` (default ``cuda``).

A frozen ViT-S/14 with 4 registers (``models/dinov2_interop.py``) maps every 70 x 70 crop (the
image and each tactile map, per stacked frame) to its CLS feature; a depth-1 transformer and a
mean pool make the policy's features (``rl/frozen_features.py``); PPO trains without MAE updates.
Weights come from a local ``.pth`` (``--dinov2_weights``; a bare state dict or one under ``model``
or ``state_dict``); without it the backbone keeps its seeded random init. Nothing is downloaded.

Example (tiny smoke run on the CPU):
    python -m m3l_tpu_torch.cli.traindino --env FakeInsertion --n_envs 2 --rollout_length 32 \\
        --batch_size 16 --total_timesteps 64 --subproc False --device cpu
"""
from __future__ import annotations

import torch

from ..models.dinov2_interop import dinov2_vits14, load_dinov2_checkpoint
from ..rl import PPOMAE, ActorCritic, FrozenEncoderFeatures
from .train import build_parser as _base_parser
from .train import learn_from_config


def build_parser():
    parser = _base_parser()
    parser.set_defaults(n_envs=64, frame_stack=1, dim_embedding=384, rollout_length=32768)
    parser.add_argument("--dinov2_weights", type=str, default=None, help="local torch .pth with DINOv2 ViT-S/14 weights")
    return parser


def build_dino(config, dtype):
    """The frozen ViT-S/14 on 70 x 70 crops, from ``config.dinov2_weights`` when given."""
    dino = dinov2_vits14(num_register_tokens=4, img_size=(70, 70), dtype=dtype)
    if config.dinov2_weights:
        n = load_dinov2_checkpoint(dino, config.dinov2_weights)
        print(f"[traindino] loaded {n:,} params from {config.dinov2_weights}")
    else:
        print("[traindino] WARNING: no --dinov2_weights given; frozen encoder is randomly initialized")
    return dino


def build_model(config, env) -> PPOMAE:
    """Weights are drawn from torch's global generator, seeded with ``config.seed``."""
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    torch.manual_seed(config.seed)
    features = FrozenEncoderFeatures(build_dino(config, dtype), config.dim_embedding, frame_stack=config.frame_stack,
                                     crop_size=70, dtype=dtype)
    policy = ActorCritic(features, config.dim_embedding, env.action_space.shape[0], dtype=dtype)
    return PPOMAE(
        policy, env,
        learning_rate=config.lr_ppo,
        n_steps=config.rollout_length // config.n_envs,
        batch_size=config.batch_size,
        n_epochs=config.ppo_epochs,
        train_mae=False,
        norm_reward=config.norm_reward,
        frame_stack=config.frame_stack,
        seed=config.seed,
        verbose=config.verbose,
        device=config.device,
    )


def main(argv: list[str] | None = None) -> PPOMAE:
    return learn_from_config(build_parser().parse_args(argv), build_model)


if __name__ == "__main__":
    main()
