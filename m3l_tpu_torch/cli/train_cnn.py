"""PPO + the CNN-variant MAE on the card (counterpart of ``m3l_tpu/cli/train_cnn.py``, the
reference's ``train _cnn.py``): the training CLI's flags at n_envs 1, plus ``--device`` (default
``cuda``). The MAE has one EarlyCNN tower per tactile sensor, and the policy's rollout features
are its raw conv tokens (``models/vtmae_cnn.py``).

Example (tiny smoke run on the CPU):
    python -m m3l_tpu_torch.cli.train_cnn --env FakeInsertion --n_envs 2 --rollout_length 32 \\
        --batch_size 16 --dim_embedding 64 --total_timesteps 64 --subproc False --device cpu
"""
from __future__ import annotations

import torch

from ..models import VTT, VTTConfig
from ..models.vtmae_cnn import VTMAECnn
from ..rl import PPOMAE, ActorCritic, MAEFeatures
from .train import build_parser as _base_parser
from .train import learn_from_config


def build_parser():
    parser = _base_parser()
    parser.set_defaults(n_envs=1)
    return parser


def build_model(config, env) -> PPOMAE:
    """Weights are drawn from torch's global generator, seeded with ``config.seed``."""
    num_tactiles = 2 if config.state_type in ("vision_and_touch", "touch") else 0
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    torch.manual_seed(config.seed)
    vtt = VTT(
        VTTConfig(dim=config.dim_embedding, depth=4, heads=4, mlp_dim=config.dim_embedding * 2, num_tactiles=num_tactiles,
                  frame_stack=config.frame_stack),
        dtype=dtype,
    )
    mae = VTMAECnn(
        vtt, masking_ratio=config.masking_ratio, decoder_dim=config.dim_embedding, decoder_depth=3, decoder_heads=4,
        use_sincosmod_encodings=config.use_sincosmod_encodings, dtype=dtype,
    )
    features = MAEFeatures(mae, config.dim_embedding, vision_only_control=config.vision_only_control,
                           frame_stack=config.frame_stack, dtype=dtype)
    policy = ActorCritic(features, config.dim_embedding, env.action_space.shape[0], dtype=dtype)
    return PPOMAE(
        policy, env,
        learning_rate=config.lr_ppo,
        n_steps=config.rollout_length // config.n_envs,
        batch_size=config.batch_size,
        n_epochs=config.ppo_epochs,
        mae_batch_size=config.mae_batch_size,
        separate_optimizer=config.separate_optimizer,
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
