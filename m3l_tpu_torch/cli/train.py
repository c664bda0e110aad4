"""PPO+MAE training entry point on the card (counterpart of ``m3l_tpu/cli/train.py``), with the
same flags and one more: ``--device`` (default ``cuda``; the JAX package picks its backend
instead). Multi-device training (``--mesh_devices``, ``--mesh_mp`` other than 1) is not ported
yet and raises, as does ``--device cuda`` without a card; both are checked before any env or
model is built. ``--compute_dtype float32`` trains with TF32 off (``utils.device.f32_numerics``).

Example (tiny smoke run on the CPU, no MuJoCo assets needed):
    python -m m3l_tpu_torch.cli.train --env FakeInsertion --n_envs 2 \\
        --total_timesteps 1024 --rollout_length 256 --dim_embedding 64 --device cpu
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..envs import make_env, make_vec_env
from ..models import VTMAE, VTT, VTTConfig
from ..rl import PPOMAE, ActorCritic, MAEFeatures
from ..train.checkpoint import step_checkpoints
from ..utils.device import f32_numerics, resolve_device


def str2bool(v: str) -> bool:
    if v.lower() == "true":
        return True
    if v.lower() == "false":
        return False
    raise ValueError(f"boolean argument should be either True or False (got {v})")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("M3L-torch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--resume_from", type=str, default=None,
        help=(
            "checkpoint to restore before learn() (parameters, optimizer states, reward normalizer, "
            "num_timesteps), or 'auto' for the newest model_*_steps.ckpt under "
            "<tensorboard_dir>/checkpoints, falling back to older ones that fail to load"
        ),
    )
    parser.add_argument("--save_freq", type=int, default=int(1e5))
    parser.add_argument("--eval_every", type=int, default=int(2e5))
    parser.add_argument("--total_timesteps", type=int, default=int(3e6))
    parser.add_argument("--wandb_dir", type=str, default="./wandb/")
    parser.add_argument("--wandb_id", type=str, default=None)
    parser.add_argument("--wandb_entity", type=str, default=None)
    # Environment.
    parser.add_argument(
        "--env", type=str, default="tactile_envs/Insertion-v0",
        help="FakeInsertion (the only ported family); tactile_envs/Insertion-v0 | Door | HandManipulate*-v1 | MuJoCoPixels/<id> raise",
    )
    parser.add_argument("--n_envs", type=int, default=8)
    parser.add_argument("--state_type", type=str, default="vision_and_touch", choices=["vision", "touch", "vision_and_touch"])
    parser.add_argument("--norm_reward", type=str2bool, default=True)
    parser.add_argument("--use_latch", type=str2bool, default=True)
    parser.add_argument("--camera_idx", type=int, default=0, choices=[0, 1, 2, 3])
    parser.add_argument("--frame_stack", type=int, default=4)
    parser.add_argument("--no_rotation", type=str2bool, default=True)
    # MAE.
    parser.add_argument("--representation", type=str2bool, default=True)
    parser.add_argument("--early_conv_masking", type=str2bool, default=True)
    parser.add_argument("--dim_embedding", type=int, default=256)
    parser.add_argument("--use_sincosmod_encodings", type=str2bool, default=True)
    parser.add_argument("--masking_ratio", type=float, default=0.95)
    parser.add_argument("--mae_batch_size", type=int, default=32)
    parser.add_argument("--train_mae_every", type=int, default=1)
    # PPO.
    parser.add_argument("--rollout_length", type=int, default=32768)
    parser.add_argument("--ppo_epochs", type=int, default=10)
    parser.add_argument("--lr_ppo", type=float, default=1e-4)
    parser.add_argument("--vision_only_control", type=str2bool, default=False)
    parser.add_argument("--batch_size", type=int, default=512)
    # PPO-MAE.
    parser.add_argument("--separate_optimizer", type=str2bool, default=False)
    # Port-specific.
    parser.add_argument(
        "--allow_fake", type=str2bool, default=False,
        help="substitute FakeInsertionEnv for the tactile_envs and robosuite families, which are not ported (off by default)",
    )
    parser.add_argument("--compute_dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    parser.add_argument("--subproc", type=str2bool, default=True)
    parser.add_argument("--mesh_devices", type=int, default=1, help="multi-device training is not ported yet: 1 only")
    parser.add_argument("--mesh_mp", type=int, default=1, help="tensor parallelism is not ported yet: 1 only")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to train on (cuda, or cpu for tests)")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--tensorboard_dir", type=str, default=None, help="enable TensorBoard logging and checkpoints")
    return parser


def check_config(config) -> torch.device:
    """The flags this port cannot honour raise here, before anything is built; returns the
    device."""
    if config.mesh_devices != 1 or config.mesh_mp != 1:
        raise ValueError(
            f"--mesh_devices {config.mesh_devices} --mesh_mp {config.mesh_mp}: multi-device training is not ported yet; use 1 and 1"
        )
    return resolve_device(config.device)


def build_model(config, env) -> PPOMAE:
    """VTT -> VTMAE -> MAEFeatures -> ActorCritic -> PPOMAE, wired as the JAX CLI wires them.
    Weights are drawn from torch's global generator, seeded with ``config.seed``."""
    num_tactiles = 0
    if config.state_type in ("vision_and_touch", "touch"):
        num_tactiles = 2
        if config.env.startswith(("HandManipulate", "MuJoCoPixels/")):
            num_tactiles = 1
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    torch.manual_seed(config.seed)
    vtt = VTT(
        VTTConfig(
            image_size=(64, 64), tactile_size=(32, 32), image_patch_size=8, tactile_patch_size=4,
            dim=config.dim_embedding, depth=4, heads=4, mlp_dim=config.dim_embedding * 2,
            num_tactiles=num_tactiles, frame_stack=config.frame_stack,
        ),
        dtype=dtype,
    )
    mae = VTMAE(
        vtt, masking_ratio=config.masking_ratio, decoder_dim=config.dim_embedding, decoder_depth=3, decoder_heads=4,
        early_conv_masking=config.early_conv_masking, use_sincosmod_encodings=config.use_sincosmod_encodings, dtype=dtype,
    )
    features = MAEFeatures(
        mae, config.dim_embedding, vision_only_control=config.vision_only_control, frame_stack=config.frame_stack, dtype=dtype
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
        # --representation False: the reference's plain-PPO branch, the same policy without MAE updates
        train_mae=config.representation,
        norm_reward=config.norm_reward,
        frame_stack=config.frame_stack,
        seed=config.seed,
        verbose=config.verbose,
        device=config.device,
    )


def resume(model: PPOMAE, resume_from: str, tensorboard_dir: str | None) -> bool:
    """Restore ``resume_from``, or with 'auto' the newest usable step checkpoint; a checkpoint
    that fails to load is reported and the next older one tried. Returns whether one loaded."""
    if resume_from == "auto":
        candidates = step_checkpoints(os.path.join(tensorboard_dir or ".", "checkpoints"))
    else:
        candidates = [resume_from]
    for path in candidates:
        try:
            model.load(str(path))
        except Exception as exc:  # noqa: BLE001 -- a torn or foreign file raises anything; try the next one
            print(f"[resume] failed to restore {path}: {exc!r}")
            continue
        print(f"[resume] restored {path}; continuing from num_timesteps={model.num_timesteps}")
        return True
    print("[resume] no usable checkpoint; starting fresh")
    return False


def main(argv: list[str] | None = None) -> PPOMAE:
    config = build_parser().parse_args(argv)
    check_config(config)
    f32_numerics(config.compute_dtype)
    np.random.seed(config.seed)
    env_fns = [
        make_env(config.env, i, config.seed, config.state_type, frame_stack=config.frame_stack, allow_fake=config.allow_fake)
        for i in range(config.n_envs)
    ]
    env = make_vec_env(env_fns, subproc=config.subproc)
    logger = None
    try:
        model = build_model(config, env)
        if config.resume_from:
            resume(model, config.resume_from, config.tensorboard_dir)
        callback = None
        if config.tensorboard_dir:
            from ..rl.callbacks import CallbackList, CheckpointCallback, TensorboardCallback
            from ..utils.loggers import TensorBoardLogger

            logger = TensorBoardLogger(config.tensorboard_dir)
            callback = CallbackList([
                TensorboardCallback(logger),
                CheckpointCallback(config.save_freq, os.path.join(config.tensorboard_dir, "checkpoints")),
            ])
        model.learn(total_timesteps=config.total_timesteps, callback=callback)
    finally:
        env.close()
        if logger is not None:
            logger.close()
    return model


if __name__ == "__main__":
    main()
