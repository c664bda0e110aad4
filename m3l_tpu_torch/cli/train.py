"""PPO+MAE training entry point on the card (counterpart of ``m3l_tpu/cli/train.py``), with the
same flags and one more: ``--device`` (default ``cuda``; the JAX package picks its backend
instead). ``--compute_dtype float32`` trains with TF32 off (``utils.device.f32_numerics``).

``--mesh_devices N --mesh_mp M`` trains on a dp x mp mesh of N ranks (``train/mesh.py``; N 0 is
every visible card): ``main`` runs itself on N processes (:func:`~..train.mesh.launch`, or the
group of ``torchrun``), each rank builds the same model with the mesh, rank 0 owns the envs and
alone logs, writes TensorBoard and saves checkpoints (in the single-process format). The result
is the single-process run's on the global batch. The backend is nccl when every rank has a card
of its own, gloo when ranks share a card or run on the CPU. The flags are checked before any env
or model is built (N divisible by M, M dividing the heads and the MLP widths), as is ``--device
cuda`` without a card.

Example (tiny smoke run on the CPU, no MuJoCo assets needed; add ``--mesh_devices 4 --mesh_mp 2``
for a mesh of four CPU ranks):
    python -m m3l_tpu_torch.cli.train --env FakeInsertion --n_envs 2 \\
        --total_timesteps 1024 --rollout_length 256 --dim_embedding 64 --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..envs import make_env, make_vec_env
from ..models import VTMAE, VTT, VTTConfig
from ..rl import PPOMAE, ActorCritic, MAEFeatures
from ..train.checkpoint import step_checkpoints
from ..train.mesh import env_spec, is_main, launch, make_mesh
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
        help="FakeInsertion or MuJoCoPixels/TouchPress-v0 (needs mujoco; one tactile sensor); tactile_envs/Insertion-v0 | Door | "
             "HandManipulate*-v1 | other MuJoCoPixels/<id> raise",
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
    parser.add_argument(
        "--mesh_devices", type=int, default=1,
        help="train on a mesh of N ranks over torch.distributed (nccl with a card each, gloo on a shared card or the CPU); 0 = every visible card, 1 = one process",
    )
    parser.add_argument("--mesh_mp", type=int, default=1, help="Megatron-style tensor-parallel degree within the mesh (mesh = dp x mp)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to train on (cuda, or cpu for tests)")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--tensorboard_dir", type=str, default=None, help="enable TensorBoard logging and checkpoints")
    return parser


def mesh_devices(config) -> int:
    """The mesh's rank count: ``--mesh_devices``, 0 meaning every visible card."""
    if config.mesh_devices == 0:
        if torch.device(config.device).type != "cuda":
            raise ValueError("--mesh_devices 0 counts the visible cards: give the number of ranks for --device cpu")
        return torch.cuda.device_count()
    return config.mesh_devices


def check_config(config, mesh_widths: tuple[int, ...] | None = None) -> torch.device:
    """The flags this port cannot honour raise here, before anything is built; returns the
    device. ``mesh_widths`` are the head counts and MLP widths ``--mesh_mp`` must divide; an
    entry point that passes none takes no mesh."""
    device = resolve_device(config.device)
    if (config.mesh_devices, config.mesh_mp) != (1, 1):
        if mesh_widths is None:
            raise ValueError("--mesh_devices/--mesh_mp: this entry point trains on one process; meshes run in cli.train, "
                             "cli.train_sacmae and the SSL Trainer")
        n, mp = mesh_devices(config), config.mesh_mp
        if n < 1 or mp < 1 or n % mp:
            raise ValueError(f"--mesh_devices {n} --mesh_mp {mp}: the mesh needs mp to divide the rank count")
        bad = [w for w in mesh_widths if w % mp]
        if bad:
            raise ValueError(f"--mesh_mp {mp} does not divide the model's heads and MLP widths {mesh_widths}")
    return device


def mesh_widths(config) -> tuple[int, ...]:
    """The heads and MLP widths of the CLIs' VTT, decoder and post transformer, which mp must divide."""
    return (4, config.dim_embedding * 2, config.dim_embedding * 4)


def build_mesh(config):
    """The counterpart of the JAX CLI's ``build_mesh``: None for ``--mesh_devices 1 --mesh_mp 1``
    (nothing changes), else this rank's dp x mp :class:`~..train.mesh.Mesh` (the process group
    must be running: :func:`main` starts it)."""
    if (config.mesh_devices, config.mesh_mp) == (1, 1):
        return None
    return make_mesh(mesh_devices(config), mp=config.mesh_mp, device=config.device)


def build_model(config, env, mesh=None) -> PPOMAE:
    """VTT -> VTMAE -> MAEFeatures -> ActorCritic -> PPOMAE, wired as the JAX CLI wires them.
    Weights are drawn from torch's global generator, seeded with ``config.seed`` (every rank of a
    ``mesh`` draws the same and keeps its shards)."""
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
        mesh=mesh,
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


def learn_from_config(config, build, image_size: int = 64, tactile_size: int = 32) -> PPOMAE:
    """The variant CLIs' run (``cli/traindino.py``, ``train_dino_cat_mae.py``, ``train_cnn.py``): the
    flags checked, the numerics set, ``config.n_envs`` envs at these sizes, ``build(config, env)``'s
    model learning ``config.total_timesteps``, the envs closed. No callbacks and no resume, as in
    their JAX counterparts. Returns the model."""
    check_config(config)
    f32_numerics(config.compute_dtype)
    np.random.seed(config.seed)
    env_fns = [
        make_env(config.env, i, config.seed, config.state_type, frame_stack=config.frame_stack, image_size=image_size,
                 tactile_size=tactile_size, allow_fake=config.allow_fake)
        for i in range(config.n_envs)
    ]
    env = make_vec_env(env_fns, subproc=config.subproc)
    try:
        model = build(config, env)
        model.learn(total_timesteps=config.total_timesteps)
    finally:
        env.close()
    return model


def run_meshed(main, argv, config):
    """``main(argv)`` on the mesh's ranks: this rank's result inside a running process group,
    else rank 0's :func:`summary` from the ranks :func:`~..train.mesh.launch` starts."""
    if dist.is_initialized():
        return main(argv)
    return launch(summary, main, argv, world=mesh_devices(config), device=config.device)[0]


def summary(main, argv) -> dict:
    """What a spawned rank hands back of ``main(argv)``'s model: its step count and last metrics."""
    model = main(argv)
    return {"num_timesteps": model.num_timesteps, "last_metrics": dict(getattr(model, "last_metrics", {}) or {})}


def callbacks(config, mesh, save_replay_buffer: bool = False):
    """TensorBoard and checkpoints under ``--tensorboard_dir`` (None without it): the logger on
    rank 0 alone, the checkpoint callback on every rank (a save gathers the shards; rank 0
    writes). Returns (callback, logger)."""
    if not config.tensorboard_dir:
        return None, None
    from ..rl.callbacks import CallbackList, CheckpointCallback, TensorboardCallback
    from ..utils.loggers import TensorBoardLogger

    cbs = [CheckpointCallback(config.save_freq, os.path.join(config.tensorboard_dir, "checkpoints"), save_replay_buffer=save_replay_buffer)]
    logger = None
    if is_main(mesh):
        logger = TensorBoardLogger(config.tensorboard_dir)
        cbs.insert(0, TensorboardCallback(logger))
    return CallbackList(cbs), logger


def main(argv: list[str] | None = None) -> PPOMAE:
    """Train from the command line; returns the model (on a mesh started here, rank 0's
    :func:`summary`)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    config = build_parser().parse_args(argv)
    check_config(config, mesh_widths(config))
    if (config.mesh_devices, config.mesh_mp) != (1, 1):
        return run_meshed(_main, argv, config)
    return _main(argv)


def _main(argv) -> PPOMAE:
    config = build_parser().parse_args(argv)
    f32_numerics(config.compute_dtype)
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
        if config.resume_from:
            resume(model, config.resume_from, config.tensorboard_dir)
        callback, logger = callbacks(config, mesh)
        model.learn(total_timesteps=config.total_timesteps, callback=callback)
    finally:
        if env is not None:
            env.close()
        if logger is not None:
            logger.close()
    return model


if __name__ == "__main__":
    main()
