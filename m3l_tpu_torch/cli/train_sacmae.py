"""SAC+MAE training entry point on the card (counterpart of ``m3l_tpu/cli/train_sacmae.py``), with
the same flags and defaults and one more: ``--device`` (default ``cuda``). ``--mesh_devices N
--mesh_mp M`` trains on a dp x mp mesh of N ranks as the PPO CLI does (``cli/train.py``): rank 0
owns the envs, logs and saves; the flags, and ``--device cuda`` without a card, are checked
before any env or model is built (``cli.train.check_config``). Only ``Fake*`` envs are built
(``--allow_fake`` lets the fake stand in for the unported families), as in the PPO CLI.

Example (tiny run on the CPU):
    python -m m3l_tpu_torch.cli.train_sacmae --env FakeInsertion --total_timesteps 64 \\
        --learning_starts 16 --batch_size 16 --mae_batch_size 8 --dim_embedding 64 \\
        --subproc False --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..envs import make_env, make_vec_env
from ..models import VTMAE, VTT, VTTConfig
from ..rl import SACMAE, MAEFeatures, SACActorCritic
from ..train.mesh import env_spec, is_main
from .train import build_mesh, callbacks, check_config, mesh_widths, run_meshed, str2bool


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("M3L-torch-SAC")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save_freq", type=int, default=int(1e5))
    parser.add_argument("--eval_every", type=int, default=int(2e5))
    parser.add_argument("--total_timesteps", type=int, default=int(3e6))
    parser.add_argument("--wandb_dir", type=str, default="./wandb/")
    parser.add_argument("--wandb_id", type=str, default=None)
    parser.add_argument("--wandb_entity", type=str, default=None)
    parser.add_argument(
        "--env", type=str, default="tactile_envs/Insertion-v0",
        help="FakeInsertion or MuJoCoPixels/TouchPress-v0 (needs mujoco; one tactile sensor); tactile_envs/Insertion-v0 | Door | "
             "HandManipulate*-v1 | other MuJoCoPixels/<id> raise",
    )
    parser.add_argument("--n_envs", type=int, default=1)  # the reference's SAC is single-env by default
    parser.add_argument("--state_type", type=str, default="vision_and_touch", choices=["vision", "touch", "vision_and_touch"])
    parser.add_argument("--norm_reward", type=str2bool, default=True)
    parser.add_argument("--use_latch", type=str2bool, default=True)
    parser.add_argument("--camera_idx", type=int, default=0, choices=[0, 1, 2, 3])
    parser.add_argument("--frame_stack", type=int, default=4)
    parser.add_argument("--no_rotation", type=str2bool, default=True)
    # MAE
    parser.add_argument("--representation", type=str2bool, default=True)
    parser.add_argument("--early_conv_masking", type=str2bool, default=True)
    parser.add_argument("--dim_embedding", type=int, default=256)
    parser.add_argument("--use_sincosmod_encodings", type=str2bool, default=True)
    parser.add_argument("--masking_ratio", type=float, default=0.95)
    parser.add_argument("--mae_batch_size", type=int, default=256)
    parser.add_argument("--train_mae_every", type=int, default=1)
    # SAC
    parser.add_argument("--learning_rate", type=float, default=3e-4)
    parser.add_argument("--buffer_size", type=int, default=1000000)
    parser.add_argument("--learning_starts", type=int, default=10000)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--tau", type=float, default=0.005)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--train_freq", type=int, default=1)
    parser.add_argument("--gradient_steps", type=int, default=1)
    parser.add_argument("--ent_coef", type=str, default="auto")
    parser.add_argument("--target_update_interval", type=int, default=1, help="accepted and never read, as in the JAX package")
    parser.add_argument("--target_entropy", type=str, default="auto")
    parser.add_argument("--vision_only_control", type=str2bool, default=False)
    # SAC-MAE
    parser.add_argument("--separate_optimizer", type=str2bool, default=True)
    # Port-specific
    parser.add_argument(
        "--allow_fake", type=str2bool, default=False,
        help="substitute FakeInsertionEnv for the tactile_envs and robosuite families, which are not ported (off by default)",
    )
    parser.add_argument("--compute_dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"])
    parser.add_argument("--device_buffer", type=str2bool, default=False, help="keep the replay ring in device memory (no per-gradient-step host-to-device batch copy)")
    parser.add_argument("--timeout_capacity", type=int, default=4096, help="device-buffer truncated-episode side-ring slots; raise for large rings with short episodes")
    parser.add_argument("--subproc", type=str2bool, default=True)
    parser.add_argument(
        "--mesh_devices", type=int, default=1,
        help="train on a mesh of N ranks over torch.distributed (nccl with a card each, gloo on a shared card or the CPU); 0 = every visible card, 1 = one process",
    )
    parser.add_argument("--mesh_mp", type=int, default=1, help="Megatron-style tensor-parallel degree within the mesh (mesh = dp x mp)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to train on (cuda, or cpu for tests)")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--tensorboard_dir", type=str, default=None, help="enable TensorBoard logging and checkpoints")
    return parser


def build_model(config, env, mesh=None) -> SACMAE:
    """VTT (depth 4, 4 heads, mlp 2 * dim) -> VTMAE (decoder depth 3, 4 heads) -> MAEFeatures ->
    SACActorCritic -> SACMAE, wired as the JAX CLI wires them. Weights are drawn from torch's
    global generator, seeded with ``config.seed`` (every rank of a ``mesh`` the same)."""
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
    policy = SACActorCritic(features, config.dim_embedding, env.action_space.shape[0], dtype=dtype)
    try:
        ent_coef = float(config.ent_coef)
    except (TypeError, ValueError):
        ent_coef = config.ent_coef
    return SACMAE(
        policy, env,
        learning_rate=config.learning_rate,
        buffer_size=config.buffer_size,
        learning_starts=config.learning_starts,
        batch_size=config.batch_size,
        tau=config.tau,
        gamma=config.gamma,
        train_freq=config.train_freq,
        gradient_steps=config.gradient_steps,
        ent_coef=ent_coef,
        target_update_interval=config.target_update_interval,
        target_entropy=config.target_entropy if config.target_entropy == "auto" else float(config.target_entropy),
        mae_batch_size=config.mae_batch_size,
        separate_optimizer=config.separate_optimizer,
        norm_reward=config.norm_reward,
        device_buffer=config.device_buffer,
        timeout_capacity=config.timeout_capacity,
        frame_stack=config.frame_stack,
        seed=config.seed,
        verbose=config.verbose,
        device=config.device,
        mesh=mesh,
    )


def main(argv: list[str] | None = None) -> SACMAE:
    """Train from the command line; returns the model (on a mesh started here, rank 0's
    ``cli.train.summary``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    config = build_parser().parse_args(argv)
    check_config(config, mesh_widths(config))
    if (config.mesh_devices, config.mesh_mp) != (1, 1):
        return run_meshed(_main, argv, config)
    return _main(argv)


def _main(argv) -> SACMAE:
    config = build_parser().parse_args(argv)
    mesh = build_mesh(config)
    main_rank = is_main(mesh)
    if mesh is not None and main_rank and config.verbose:
        print(f"[mesh] {mesh}")
    np.random.seed(config.seed)
    env = None
    if main_rank:  # rank 0 owns the envs
        env_fns = [
            make_env(config.env, i, config.seed, config.state_type, frame_stack=config.frame_stack, allow_fake=config.allow_fake)
            for i in range(config.n_envs)
        ]
        env = make_vec_env(env_fns, subproc=config.subproc)
    logger = None
    try:
        model = build_model(config, env_spec(env, mesh), mesh)
        callback, logger = callbacks(config, mesh, save_replay_buffer=True)
        model.learn(total_timesteps=config.total_timesteps, callback=callback)
    finally:
        if env is not None:
            env.close()
        if logger is not None:
            logger.close()
    return model


if __name__ == "__main__":
    main()
