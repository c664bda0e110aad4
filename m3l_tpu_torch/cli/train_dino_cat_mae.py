"""PPO + MAE features fused with a frozen DINO feature, on the card (counterpart of
``m3l_tpu/cli/train_dino_cat_mae.py``, the reference's ``train_dino_cat_mae.py``): the training
CLI's flags at dim 384, mask ratio 0.8 and the patch-embedding MAE (``--early_conv_masking
False``), plus ``--dinov2_weights``, ``--tactile_only_mae`` and ``--device`` (default ``cuda``).

The VTT takes a 70 x 70 image and 70 x 70 tactile maps at patch 14 (25 tokens each), and the envs
render at those sizes. The frozen ViT-S/14 maps the middle stacked frame to its CLS feature, and
``rl/dino_fusion_features.py`` fuses it with the MAE's pooled features; PPO and the MAE train
jointly (or apart with ``--separate_optimizer True``). ``--tactile_only_mae True`` is the
reference's ``train_dino_tac_mae.py`` variant (``cli/train_dino_tac_mae.py``). Nothing is
downloaded: without ``--dinov2_weights`` the backbone keeps its seeded random init.

Example (tiny smoke run on the CPU):
    python -m m3l_tpu_torch.cli.train_dino_cat_mae --env FakeInsertion --n_envs 2 --frame_stack 2 \\
        --rollout_length 32 --batch_size 16 --mae_batch_size 8 --dim_embedding 64 --total_timesteps 64 \\
        --subproc False --device cpu
"""
from __future__ import annotations

import torch

from ..models import VTMAE, VTT, VTTConfig
from ..models.dinov2_interop import dinov2_vits14, load_dinov2_checkpoint
from ..rl import PPOMAE, ActorCritic, DinoCatMAEFeatures
from .train import build_parser as _base_parser
from .train import learn_from_config, str2bool

SIZE = 70  # image and tactile maps, 5 x 5 patches of 14


def build_parser():
    parser = _base_parser()
    # the early-conv token grids do not align with the 70 / 14 patch grid: the patch embedding is the default
    parser.set_defaults(dim_embedding=384, masking_ratio=0.8, early_conv_masking=False)
    parser.add_argument("--dinov2_weights", type=str, default=None)
    parser.add_argument("--tactile_only_mae", type=str2bool, default=False)
    return parser


def build_model(config, env) -> PPOMAE:
    """Weights are drawn from torch's global generator, seeded with ``config.seed``."""
    num_tactiles = 2 if config.state_type in ("vision_and_touch", "touch") else 0
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    torch.manual_seed(config.seed)
    vtt = VTT(
        VTTConfig(
            image_size=(SIZE, SIZE), tactile_size=(SIZE, SIZE), image_patch_size=14, tactile_patch_size=14,
            dim=config.dim_embedding, depth=4, heads=4, mlp_dim=config.dim_embedding * 2,
            num_tactiles=num_tactiles, frame_stack=config.frame_stack,
        ),
        dtype=dtype,
    )
    mae = VTMAE(
        vtt, masking_ratio=config.masking_ratio, decoder_dim=config.dim_embedding, decoder_depth=3, decoder_heads=4,
        early_conv_masking=config.early_conv_masking, use_sincosmod_encodings=config.use_sincosmod_encodings, dtype=dtype,
    )
    dino = dinov2_vits14(num_register_tokens=4, img_size=(SIZE, SIZE), dtype=dtype)
    if config.dinov2_weights:
        load_dinov2_checkpoint(dino, config.dinov2_weights)
    features = DinoCatMAEFeatures(
        mae, dino, config.dim_embedding, vision_only_control=config.vision_only_control,
        tactile_only_mae=config.tactile_only_mae, frame_stack=config.frame_stack, dtype=dtype,
    )
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
    return learn_from_config(build_parser().parse_args(argv), build_model, image_size=SIZE, tactile_size=SIZE)


if __name__ == "__main__":
    main()
