"""What the ranks of a mesh run under :func:`.mesh.launch`, and the single-process twins they are
held against.

``spawn`` pickles a rank's function by module and name, so these live in the package. Each
``*_case`` function makes the model of a case (a dict of plain values, numpy arrays and full
single-process state dicts) with or without a mesh, so the same code gives the mesh run and the
single-process run it must equal. Each ``*_rank`` function is one rank: it builds the mesh,
runs the case, checks that the parameters every rank replicates are bit-identical (and each
shard across its dp group), and returns what the caller compares: the metrics, and on rank 0
the gathered state in the single-process layout.
"""
from __future__ import annotations

import copy
import statistics
import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import BWD_BODY_LAUNCHES, FWD_BODY_LAUNCHES, LAUNCHES, reset_launches
from ..models import VTMAE, VTT, VTTConfig
from ..nn import flash_attention as fa
from ..ops.masking import mask_from_indices
from ..rl import PPOMAE, SACMAE, MAEFeatures, SACActorCritic
from ..serve import build_policy
from ..utils.device import f32_numerics
from .mesh import EnvSpec, gather_like, make_mesh, shard_module, shard_spec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AttentionLog:
    """Counts the packed attention calls of a run by (direction, batch, heads), and by (direction,
    batch, tokens, heads, head dim) in :attr:`shapes`: the kernels' wrappers on the card, their
    plain versions on the CPU (the operators look both up at each call). On the card it also keeps
    the run's kernel launches and the bodies that served them (the counters of
    ``m3l_tpu_torch.kernels``, this process's)."""

    def __init__(self, device: torch.device):
        self.calls: Counter = Counter()
        self.shapes: Counter = Counter()
        cuda = device.type == "cuda"
        self._names = ("_launch", "_launch_bwd") if cuda else ("_fwd_plain", "_bwd_plain")
        self._saved = {}

    @property
    def counts(self) -> dict:
        """{"launches", "fwd_bodies", "bwd_bodies"}: the run's counts (zero on the CPU)."""
        return {k: dict(c) for k, c in zip(("launches", "fwd_bodies", "bwd_bodies"), (LAUNCHES, FWD_BODY_LAUNCHES, BWD_BODY_LAUNCHES))}

    def __enter__(self):
        reset_launches()
        for name, kind in zip(self._names, ("fwd", "bwd")):
            inner = getattr(fa, name)
            self._saved[name] = inner

            def wrapped(qkv, *args, _inner=inner, _kind=kind):
                heads = args[1] if _kind == "bwd" else args[0]
                self.calls[(_kind, qkv.shape[0], heads)] += 1
                self.shapes[(_kind, qkv.shape[0], qkv.shape[1], heads, qkv.shape[2] // (3 * heads))] += 1
                return _inner(qkv, *args)

            setattr(fa, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, inner in self._saved.items():
            setattr(fa, name, inner)


def load_case(case):
    """A case dict, or the path of one saved with ``torch.save`` (a large case goes to the ranks
    as a file, not through their start-up pipe); its numerics applied to this process: TF32 off for
    an f32 case, and ``bf16_reduced_precision_reduction`` where the case sets it."""
    case = torch.load(case, weights_only=False) if isinstance(case, str) else case
    if case.get("dtype") == "float32":
        f32_numerics("float32")
    if "bf16_reduced_precision_reduction" in case:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = case["bf16_reduced_precision_reduction"]
    return case


def jobs_rank(jobs: list) -> list:
    """Run ``jobs`` ([(function, args), ...], each function of this module) in order on this rank;
    returns [(result, seconds), ...]. One group of processes serves several cases."""
    out = []
    for fn, args in jobs:
        t0 = time.perf_counter()
        result = fn(*args)
        out.append((result, time.perf_counter() - t0))
    return out


def layers_rank(n_devices: int, mp: int, device: str = "cpu") -> dict:
    """Each Megatron pair as one layer, sharded over mp against its full twin on the same input and
    output gradient: {layer: {"out", "grad_in", "grad_w"}} errors relative to the largest value
    (the ranks' partial outputs summed by g, the input gradient by f, each weight gradient gathered)."""
    from torch import nn

    from ..nn import transformer as rl_layers
    from ..nn import vit_layers

    mesh = make_mesh(n_devices, mp=mp, device=device)
    torch.manual_seed(0)
    layers = {  # the attribute names the rules look for
        "attention": ("attn", rl_layers.Attention(64, 4, 16), 1),
        "feedforward": ("ff", rl_layers.FeedForward(64, 128), 1),
        "vit_attention": ("attn", vit_layers.Attention(64, 4), 1),
        "mlp": ("mlp", vit_layers.Mlp(64, 128), 1),
        "swiglu": ("mlp", vit_layers.SwiGLUFFN(64, 144), 1),
        "cross_attention": ("xattn", vit_layers.CrossAttention(64, 4), 2),
    }
    out = {}
    for name, (attr, full, n_in) in layers.items():
        full = full.to(mesh.device)
        holder = nn.Module()
        setattr(holder, attr, full)
        twin = shard_module(copy.deepcopy(holder), mesh)
        xs = [torch.randn(2, 5 + i, 64, device=mesh.device) for i in range(n_in)]
        g = torch.randn(2, 5, 64, device=mesh.device)
        errs = {}
        results = []
        for module in (holder, twin):
            ins = [x.clone().requires_grad_(True) for x in xs]
            y = getattr(module, attr)(*ins)
            y.backward(g)
            grads = {n: gather_like(p.grad, p, mesh) for n, p in module.named_parameters()}
            results.append((y.detach(), [x.grad for x in ins], grads))
        (y0, gi0, gw0), (y1, gi1, gw1) = results

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

        errs["out"] = rel(y1, y0)
        errs["grad_in"] = max(rel(a, b) for a, b in zip(gi1, gi0))
        errs["grad_w"] = max(rel(gw1[n], gw0[n]) for n in gw0)
        out[name] = errs
    return out


def timed(obj, method: str, device: torch.device) -> list:
    """Wrap ``obj.method`` to append each call's milliseconds (the card synchronised before and
    after) to the returned list."""
    inner, out = getattr(obj, method), []

    def run(*args, **kwargs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        result = inner(*args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.append((time.perf_counter() - t0) * 1e3)
        return result

    setattr(obj, method, run)
    return out


def allreduce_rank(n_devices: int, sizes_mb: list, device: str, repeats: int = 3) -> dict:
    """Milliseconds of one f32 all-reduce over every rank of the group, by size in MB (the median of
    ``repeats`` after one warm-up; the device synchronised before and after): what the flat
    gradient's dp reduction and Megatron's f and g cost on this backend."""
    mesh = make_mesh(n_devices, device=device)
    out = {}
    for mb in sizes_mb:
        t = torch.ones(int(mb * 2**20) // 4, device=mesh.device)
        times = []
        for _ in range(repeats + 1):
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            dist.all_reduce(t)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[mb] = sorted(times[1:])[len(times[1:]) // 2]
    return out


def replication_check(module: torch.nn.Module, mesh) -> bool:
    """True if this rank's replicated parameters equal rank 0's bit for bit, and each sharded one
    the first rank of its dp group's (collective)."""
    rep = [p.detach().reshape(-1) for p in module.parameters() if shard_spec(p) is None]
    shards = [p.detach().reshape(-1) for p in module.parameters() if shard_spec(p) is not None]
    ok = True
    for flat, src, group, size in ((rep, 0, None, mesh.world), (shards, mesh.mp_index, mesh.dp_group, mesh.dp)):
        if not flat or size == 1:
            continue
        mine = torch.cat(flat).float()
        ref = mine.clone()
        dist.broadcast(ref, src=src, group=group)
        ok = ok and torch.equal(mine, ref)
    return ok


def _obs_space(case: dict):
    from ..envs import make_env

    env = make_env("FakeInsertion", 0, frame_stack=case["vtt"]["frame_stack"])()
    try:
        return env.observation_space, env.action_space
    finally:
        env.close()


# --------------------------------------------------------------------------------------------- #
# PPO+MAE
# --------------------------------------------------------------------------------------------- #
def ppo_case(case: dict, mesh=None, device: str | torch.device = "cpu") -> PPOMAE:
    """The case's PPOMAE: its policy config and full initial weights, its PPOMAE options, its
    rollout in the buffer (every rank the whole of it) and its last observation."""
    dtype = DTYPES[case["dtype"]]
    policy = build_policy(VTTConfig(**case["vtt"]), decoder_depth=case["decoder_depth"], decoder_heads=case["decoder_heads"],
                          dtype=dtype, device="cpu")
    policy.load_state_dict(case["init"])
    obs_space, action_space = _obs_space(case)
    env = EnvSpec(case["n_envs"], obs_space, action_space)
    model = PPOMAE(policy, env, n_steps=case["n_steps"], frame_stack=case["vtt"]["frame_stack"], device=device, mesh=mesh, **case["kw"])
    buf = model.buffer
    for k, v in case["buffer"].items():
        if k == "obs":
            for kk, vv in v.items():
                buf.obs[kk][...] = vv
        else:
            getattr(buf, k)[...] = v
    buf.pos = buf.n_steps
    model._last_obs = case["last_obs"]
    model._last_episode_starts = case["last_episode_starts"].copy()
    return model


def ppo_rank(case: dict, n_devices: int, mp: int, device: str, warm_up: bool = False) -> dict:
    """One rank of a PPO+MAE ``train()`` (or, with ``case["phase"]``, a ``train_phase`` on the
    given data, permutation and masks) on a dp x mp mesh; records the attention calls. With
    ``warm_up``, a ``train()`` of a throwaway copy runs first, so the timed updates are not the
    process's first (those pay the card's start: library handles, autotuning)."""
    case = load_case(case)
    mesh = make_mesh(n_devices, mp=mp, device=device)
    if warm_up:
        ppo_case(case, mesh, mesh.device).train()
    model = ppo_case(case, mesh, mesh.device)
    update_ms = timed(model, "minibatch_update", mesh.device)
    step_ms = timed(model.optimizer, "step", mesh.device)  # the optimizer step holds the gradient's dp reduction
    with AttentionLog(mesh.device) as log:
        if "phase" in case:
            metrics = model.train_phase(*ppo_phase_args(case["phase"], mesh.device))
        else:
            metrics = model.train()
    out = {"metrics": metrics, "state": model.state_dict()}  # gathered: collective
    out.update(replicated=replication_check(model.policy, mesh), attention=dict(log.calls), shapes=dict(log.shapes), mesh=repr(mesh),
               update_ms=update_ms, optimizer_ms=step_ms, **log.counts)
    if not mesh.is_main:
        out.pop("state")
    return out


def sharing_rank(case, n_devices: int, device: str, top: int = 10) -> dict:
    """Where the dp 2 update's time goes when both ranks share one card. Each rank of a 2-rank group
    times ``minibatch_update`` (median ms) of the case's single-process PPOMAE in ``train()``, one
    rank at a time while the other waits at a barrier: ``first_ms`` in the process's first
    ``train()``, then ``alone_ms`` in its second; ``together_ms`` with both ranks at once and no
    collective between them. Then its dp 2 mesh model after one warm-up ``train()``: ``mesh_ms``,
    and a ``train()`` traced by ``torch.profiler`` (``traced_mesh_ms``): the device kernels'
    milliseconds per update (``mesh_device_ms``) and the host operators that took the most time of
    their own (``host_top``: ms and calls per update)."""
    from torch.profiler import ProfilerActivity, profile

    case = load_case(case)
    mesh = make_mesh(n_devices, device=device)
    sync = (lambda: torch.cuda.synchronize(mesh.device)) if mesh.device.type == "cuda" else (lambda: None)
    plain = ppo_case(case, None, mesh.device)
    times = timed(plain, "minibatch_update", mesh.device)
    out = {}
    for r in range(mesh.world):  # one rank at a time: its first train(), then its second
        dist.barrier()
        if mesh.rank == r:
            plain.train()
            sync()
            out["first_ms"] = statistics.median(times)
            del times[:]
            plain.train()
            sync()
            out["alone_ms"] = statistics.median(times)
        dist.barrier()
    del times[:]
    dist.barrier()
    plain.train()
    sync()
    out["together_ms"] = statistics.median(times)
    meshed = ppo_case(case, mesh, mesh.device)
    times = timed(meshed, "minibatch_update", mesh.device)
    meshed.train()
    del times[:]
    meshed.train()
    out["mesh_ms"] = statistics.median(times)
    del times[:]
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if mesh.device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        meshed.train()
        sync()
    n = len(times)
    out["traced_mesh_ms"] = statistics.median(times)
    out["mesh_device_ms"] = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    out["host_top"] = [dict(name=e.key[:80], self_ms=e.self_cpu_time_total / 1e3 / n, calls=e.count / n) for e in rows]
    return out


def ppo_phase_args(phase: dict, device) -> tuple:
    """``train_phase``'s arguments from numpy: the data, rewards, episode starts, last values, last
    dones, the permutation rows and one mask per row (masked and kept indices)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    data = {"obs": {k: t(v) for k, v in phase["data"]["obs"].items()}, **{k: t(phase["data"][k]) for k in ("actions", "values", "log_probs")}}
    masks = [mask_from_indices(t(m), t(k)) for m, k in phase["masks"]]
    return (data, t(phase["rewards"]), t(phase["starts"]), t(phase["last_values"]), t(phase["last_dones"]), t(phase["idx"]), masks)


# --------------------------------------------------------------------------------------------- #
# SAC+MAE
# --------------------------------------------------------------------------------------------- #
def sac_policy(case: dict) -> SACActorCritic:
    dtype = DTYPES[case["dtype"]]
    cfg = VTTConfig(**case["vtt"])
    mae = VTMAE(VTT(cfg, dtype=dtype), decoder_dim=cfg.dim, masking_ratio=0.95, decoder_depth=case["decoder_depth"],
                decoder_heads=case["decoder_heads"], early_conv_masking=True, dtype=dtype)
    return SACActorCritic(MAEFeatures(mae, cfg.dim, frame_stack=cfg.frame_stack, dtype=dtype), cfg.dim, 3, dtype=dtype)


def sac_case(case: dict, mesh=None, device: str | torch.device = "cpu") -> SACMAE:
    """The case's SACMAE with its full initial weights and its transitions in the replay ring."""
    policy = sac_policy(case)
    policy.load_state_dict(case["init"])
    obs_space, action_space = _obs_space(case)
    model = SACMAE(policy, EnvSpec(case["n_envs"], obs_space, action_space), frame_stack=case["vtt"]["frame_stack"], device=device,
                   mesh=mesh, **case["kw"])
    for obs, actions, rewards, dones, infos in case["transitions"]:
        model.buffer.add(obs, actions, rewards, dones, infos)
    model.num_timesteps = case["n_envs"] * len(case["transitions"])
    return model


def sac_update_args(update: dict, device) -> tuple:
    """``SACMAE.update``'s global arguments from numpy: the batch, one mask per MAE chunk and the
    two noises."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    batch = {k: {kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict) else t(v) for k, v in update["batch"].items()}
    masks = [mask_from_indices(t(m), t(k)) for m, k in update["masks"]]
    return batch, masks, t(update["noise_pi"]), t(update["noise_next"])


def sac_rank(case: dict, n_devices: int, mp: int, device: str, warm_up: bool = False) -> dict:
    """One rank of SAC ``train_steps(case["steps"])`` (or, with ``case["update"]``, one
    ``update`` on the given global batch and randomness) on a dp x mp mesh; ``warm_up`` as
    :func:`ppo_rank`'s."""
    case = load_case(case)
    mesh = make_mesh(n_devices, mp=mp, device=device)
    if warm_up:
        sac_case(case, mesh, mesh.device).train_steps(case["steps"])
    model = sac_case(case, mesh, mesh.device)
    update_ms = timed(model, "update", mesh.device)
    with AttentionLog(mesh.device) as log:
        if "update" in case:
            metrics = {k: float(v) for k, v in model.update(*sac_update_args(case["update"], mesh.device)).items()}
        else:
            metrics = model.train_steps(case["steps"])
    out = {"metrics": metrics, "state": model.state_dict()}  # gathered: collective
    out.update(replicated=replication_check(model.policy, mesh), attention=dict(log.calls), shapes=dict(log.shapes), update_ms=update_ms,
               **log.counts)
    if not mesh.is_main:
        out.pop("state")
    return out


# --------------------------------------------------------------------------------------------- #
# the SSL Trainer's MAE
# --------------------------------------------------------------------------------------------- #
def mae_case(case: dict, mesh=None):
    """The case's MAEModule (a ViT encoder and its decoder) with its full initial weights, its
    masking noise injected: the global noise of each step, this rank's rows under a mesh."""
    from ..models.vit import VisionTransformer
    from ..ssl import MAEModule

    if "config" in case:  # a config of the pretraining CLI, with its overrides
        from ..utils.config import instantiate, load_config

        cfg = load_config(case["config"], list(case.get("overrides", ())))
        module = instantiate(cfg["model"]["algorithm"])(instantiate(cfg["model"]["encoder"]))
    else:
        dtype = DTYPES[case["dtype"]]
        module = MAEModule(VisionTransformer(**case["vit"], dtype=dtype), **case["mae"], dtype=dtype)
    module.load_state_dict(case["init"])
    noises = [torch.from_numpy(n) for n in case["noises"]]

    def sample_noise(batch, generator):
        noise = noises.pop(0).to(module.decoder.mask_token.device)
        return noise if mesh is None else noise[mesh.rows(noise.shape[0])]

    module.sample_noise = sample_noise
    return module


def mae_fit(case: dict, mesh=None, device: str | torch.device = "cpu", record: bool = True):
    """One ``Trainer.fit`` of the case's module over its batches; returns (history, module, the
    optimizer's AdamW state after each step, gathered to the single-process layout; none without
    ``record``)."""
    from .trainer import Trainer

    module = mae_case(case, mesh)
    trainer = Trainer(max_epochs=case["epochs"], verbose=0, mesh=mesh, device=device, ckpt_dir=case.get("ckpt_dir"))
    step_ms = timed(trainer, "train_step", torch.device(device))
    moments, step = [], trainer.train_step

    def recorded_step(module, optimizer, batch):
        out = step(module, optimizer, batch)
        state = optimizer.state_dict()["adamw"]["state"]  # collective under a mesh
        moments.append({i: {k: v.detach().clone() for k, v in st.items()} for i, st in state.items()})
        return out

    if record:
        trainer.train_step = recorded_step
    history = trainer.fit(module, [{"image": b} for b in case["batches"]])
    history[-1]["step_ms"] = step_ms
    return history, module, moments


def mae_readings(module, steps_per_epoch: int, epochs: int, moments: list, state: dict, ref_moments: list, ref_state: dict) -> dict:
    """A mesh MAE run (its AdamW state after each step and its parameters, gathered) against the
    single process's, for ``module``'s optimizer: ``moment_rel``, the largest distance of a
    parameter's first or second moment after any step from the single process's, over the norm of
    the single process's, and ``param_per_lr``, the largest parameter difference in base lr; each
    with the parameter (``moment_worst``, ``param_worst``) that gave it."""
    names = _names(module)
    order = [names[id(p)] for g in module.configure_optimizer(steps_per_epoch, epochs).adamw.param_groups for p in g["params"]]
    dev = next(iter(state.values())).device  # the mesh run's: on the card where it ran there
    moment_rel, moment_worst = 0.0, None
    for mine, theirs in zip(moments, ref_moments):
        for i, name in enumerate(order):
            for k in ("exp_avg", "exp_avg_sq"):
                a, b = mine[i][k].to(dev), theirs[i][k].to(dev)
                rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                if rel > moment_rel:
                    moment_rel, moment_worst = rel, f"{name} {k}"
    lr = module.base_lr
    diffs = {n: (state[n] - w.to(dev)).abs().max().item() / lr for n, w in ref_state.items()}
    param_worst = max(diffs, key=diffs.get)
    return {"moment_rel": moment_rel, "moment_worst": moment_worst, "param_per_lr": diffs[param_worst], "param_worst": param_worst}


def _names(module) -> dict:
    return {id(p): n for n, p in module.named_parameters()}


def mae_rank(case: dict, n_devices: int, mp: int, device: str, reference: str | None = None, warm_up: bool = False) -> dict:
    """One rank of the case's MAE Trainer run on a dp x mp mesh. Rank 0 returns the gathered
    parameters and AdamW moments of every step, or, given the single process's (``reference``, a
    saved {"moments", "state"}), only :func:`mae_readings` against them (the moments of a large
    model are too many bytes to send back). ``warm_up`` as :func:`ppo_rank`'s."""
    case = load_case(case)
    mesh = make_mesh(n_devices, mp=mp, device=device)
    if warm_up:
        mae_fit(dict(case, ckpt_dir=None), mesh, mesh.device, record=False)
    with AttentionLog(mesh.device) as log:
        history, module, moments = mae_fit(case, mesh, mesh.device)
    state = {k: gather_like(v.detach(), v, mesh) for k, v in module.named_parameters()}
    out = {"history": history, "replicated": replication_check(module, mesh), "attention": dict(log.calls), "shapes": dict(log.shapes),
           **log.counts}
    if mesh.is_main and reference is None:
        out.update(state=state, moments=moments)
    elif mesh.is_main:
        ref = torch.load(reference, map_location="cpu", weights_only=False)
        out["readings"] = mae_readings(module, len(case["batches"]), case["epochs"], moments, state, ref["moments"], ref["state"])
    return out


# --------------------------------------------------------------------------------------------- #
# the CLIs inside a running group
# --------------------------------------------------------------------------------------------- #
def cli_rank(cli: str, argv: list, save_path: str | None = None, obs: dict | None = None) -> dict:
    """``m3l_tpu_torch.cli.<cli>.main(argv)`` as one rank of the running group (it joins the group);
    then, with ``save_path``, the model saved there (rank 0 writes the single-process format), and
    with ``obs``, the model's deterministic actions for it (collective)."""
    import importlib

    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    with AttentionLog(torch.device(device)) as log:
        model = importlib.import_module(f"m3l_tpu_torch.cli.{cli}").main(argv)
    if save_path is not None:
        model.save(save_path)
    out = {"num_timesteps": model.num_timesteps, "metrics": dict(model.last_metrics), "mesh": repr(model.mesh),
           "attention": dict(log.calls), "shapes": dict(log.shapes), **log.counts}
    if obs is not None:
        out["actions"] = model.predict(obs)
    return out
