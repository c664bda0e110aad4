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

from ..kernels import BWD_BODY_LAUNCHES, FWD_BODY_LAUNCHES, LAUNCHES, MASKED_LAUNCHES, reset_launches
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
        """{"launches", "fwd_bodies", "bwd_bodies", "masked"}: the run's counts (zero on the CPU)."""
        names = ("launches", "fwd_bodies", "bwd_bodies", "masked")
        return {k: dict(c) for k, c in zip(names, (LAUNCHES, FWD_BODY_LAUNCHES, BWD_BODY_LAUNCHES, MASKED_LAUNCHES))}

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


def slip_force_shard_rank(n_devices: int, mp: int, device: str = "cpu") -> dict:
    """SlipForceProbe sharded over mp against its full twin on the same tokens, force and output
    gradient: the class and width of each of its layers after ``shard_module`` ({name: (class,
    in_features, out_features)}), and the errors of the output and of the gradients of the tokens,
    the force and every weight (gathered), relative to the largest value."""
    from ..tasks import SlipForceProbe

    mesh = make_mesh(n_devices, mp=mp, device=device)
    torch.manual_seed(0)
    full = SlipForceProbe(32, num_heads=2).to(mesh.device)
    twin = shard_module(copy.deepcopy(full), mesh)
    tokens, force, g = torch.randn(4, 6, 32, device=mesh.device), torch.randn(4, 3, device=mesh.device), torch.randn(4, 2, device=mesh.device)
    results = []
    for module in (full, twin):
        ins = [tokens.clone().requires_grad_(True), force.clone().requires_grad_(True)]
        y = module(*ins)
        y.backward(g)
        results.append((y.detach(), [x.grad for x in ins], {n: gather_like(p.grad, p, mesh) for n, p in module.named_parameters()}))
    (y0, gi0, gw0), (y1, gi1, gw1) = results
    layers = {n: (type(m).__name__, m.in_features, m.out_features) for n, m in twin.named_children() if n in ("force_proj", "fc1", "fc2")}
    return {"layers": layers, "out": _rel(y1, y0), "grad_in": max(_rel(a, b) for a, b in zip(gi1, gi0)),
            "grad_w": max(_rel(gw1[n], gw0[n]) for n in gw0)}


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
    """True if this rank's replicated parameters and buffers equal rank 0's bit for bit, and each
    sharded parameter the first rank of its dp group's (collective)."""
    rep = [p.detach().reshape(-1) for p in module.parameters() if shard_spec(p) is None]
    rep += [b.detach().reshape(-1) for b in module.buffers() if b.is_floating_point()]
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
# the SSL Trainer's families
# --------------------------------------------------------------------------------------------- #
SSL_FAMILIES = {"mae": "MAEModule", "dino": "DINOModule", "dinov2": "DINOv2Module", "ijepa": "IJEPAModule", "vjepa": "VJEPAModule",
                "vtdino": "VTDINOModule"}


def ssl_module(case: dict):
    """The case's SSL module (f32) with its full initial weights (``init``; its own where that is
    None): from a pretraining config and its
    overrides (``config``, ``overrides``), or from ``family`` (a key of SSL_FAMILIES) and the keyword
    arguments of its ``encoder`` (a ViT, for VTDINO the multimodal VTT), its ``module`` and, for the
    JEPAs, its ``predictor``. The module draws its masks (noise, for MAE) with the Trainer's
    generator, or takes each step's global ones from the case (``masks``, ``noises``), keeping this
    rank's rows under a mesh."""
    from .. import ssl
    from ..models import MultimodalVTT
    from ..models.vit import VisionTransformer, vit_predictor

    if "config" in case:  # a config of the pretraining CLI, with its overrides
        from ..utils.config import instantiate, load_config

        cfg = load_config(case["config"], list(case.get("overrides", ())))
        module = instantiate(cfg["model"]["algorithm"])(instantiate(cfg["model"]["encoder"]))
    else:
        cls = getattr(ssl, SSL_FAMILIES[case["family"]])
        encoder = (MultimodalVTT if case["family"] == "vtdino" else VisionTransformer)(**case["encoder"])
        if "predictor" in case:
            module = cls(encoder, vit_predictor(encoder.embed_dim, **case["predictor"]), **case["module"])
        else:
            module = cls(encoder, **case["module"])
    if case.get("init") is not None:
        module.load_state_dict(case["init"])
    device = lambda: next(module.parameters()).device  # noqa: E731 -- where the Trainer moved it
    if "noises" in case:
        noises = [torch.from_numpy(n) for n in case["noises"]]
        module.sample_noise = lambda batch, generator: module.own_rows(noises.pop(0).to(device()))
    if "masks" in case:  # each step's global masks: a tuple of arrays, or one array
        masks = list(case["masks"])

        def sample_masks(generator, batch):
            m = masks.pop(0)
            return tuple(torch.from_numpy(a).to(device()) for a in m) if isinstance(m, tuple) else torch.from_numpy(m).to(device())

        module.sample_masks = sample_masks
    return module


def ssl_fit(case: dict, mesh=None, device: str | torch.device = "cpu", record: bool = True, build=None):
    """One ``Trainer.fit`` of the case's module (``build(case)``, :func:`ssl_module` by default) over
    its batches; returns (history, module, the global loss and logged scalars of every step, the
    optimizer's AdamW state after each step, gathered to the single-process layout; no moments
    without ``record``)."""
    from .trainer import Trainer

    module = (build or ssl_module)(case)
    trainer = Trainer(max_epochs=case["epochs"], verbose=0, mesh=mesh, device=device, ckpt_dir=case.get("ckpt_dir"))
    step_ms = timed(trainer, "train_step", torch.device(device))
    steps, moments, step = [], [], trainer.train_step

    def recorded_step(module, optimizer, batch):
        loss, scalars = step(module, optimizer, batch)
        steps.append({"loss": float(loss), **{k: float(v) for k, v in scalars.items()}})
        if record:
            state = optimizer.state_dict()["adamw"]["state"]  # collective under a mesh
            moments.append({i: {k: v.detach().clone() for k, v in st.items()} for i, st in state.items()})
        return loss, scalars

    trainer.train_step = recorded_step
    history = trainer.fit(module, case["batches"])
    history[-1]["step_ms"] = step_ms
    return history, module, steps, moments


def _groups(module) -> dict:
    """{name: "trainable" | "teacher" | "buffer"} over the module's state dict."""
    trainable = module.trainable_parameters()
    out = {n: "trainable" if n in trainable else "teacher" for n, _ in module.named_parameters()}
    return out | {n: "buffer" for n, _ in module.named_buffers()}


def _worst(values: dict) -> tuple[float, str | None]:
    """The largest of ``values`` ({name: reading}) and its name; (0, None) for none."""
    worst = max(values, key=values.get) if values else None
    return (values[worst] if worst else 0.0), worst


def _key_part(name: str, n: int) -> slice | None:
    """The key's elements of a packed attention bias of ``n``: the middle third of a [q | k | v]
    ``qkv.bias``, the first half of a cross-attention's [k | v] ``kv.bias``; None for another."""
    if name.endswith("qkv.bias"):
        return slice(n // 3, 2 * n // 3)
    if name.endswith(".kv.bias"):
        return slice(0, n // 2)
    return None


def ssl_readings(module, steps_per_epoch: int, epochs: int, moments: list, state: dict, ref_moments: list, ref_state: dict,
                 init: dict | None = None) -> dict:
    """A mesh run of an SSL module (its AdamW state after each recorded step and its full state
    dict, gathered) against the single process's, for ``module``'s optimizer: ``moment_rel``, the
    largest distance of a parameter's first or second moment after any recorded step from the single
    process's, over the norm of the single process's; ``param_per_lr``, the largest difference of a
    trained parameter in base lr; given the initial state ``init``, ``update_rel``, the largest
    distance of a trained parameter from the single process's over the norm of the single process's
    update of it; ``teacher_per_lr``, of an EMA teacher's (0 without one); ``center_abs``, the largest
    absolute difference of a buffer (the DINO centers); each with the tensor that gave it, under
    the reading's key plus ``_worst``. The key part of a packed attention bias (:func:`_key_part`)
    is read apart, as ``key_bias_per_lr`` (student or teacher): a key bias adds one constant to each
    query's scores, which the softmax cancels, so its gradient is zero but for f32 noise, and Adam,
    dividing that noise by its own size, moves it by up to lr a step in either run."""
    groups = _groups(module)
    names = {id(p): n for n, p in module.named_parameters()}
    order = [names[id(p)] for g in module.configure_optimizer(steps_per_epoch, epochs).adamw.param_groups for p in g["params"]]
    dev = next(iter(state.values())).device  # the mesh run's: on the card where it ran there
    moment_rel = {}
    for mine, theirs in zip(moments, ref_moments):
        for i, name in enumerate(order):
            for k in ("exp_avg", "exp_avg_sq"):
                a, b = mine[i][k].to(dev), theirs[i][k].to(dev)
                moment_rel[f"{name} {k}"] = max(moment_rel.get(f"{name} {k}", 0.0), ((a - b).norm() / b.norm().clamp_min(1e-30)).item())
    lr = module.base_lr
    diffs = {"trainable": {}, "teacher": {}, "buffer": {}}
    key_bias, update_rel = {}, {}
    for n, w in ref_state.items():
        group, w = groups[n], w.to(dev).float()
        diff = (state[n].float() - w).abs()
        moved = (w - init[n].to(dev).float()).abs() if init is not None and group == "trainable" else None
        key = _key_part(n, diff.shape[0]) if group != "buffer" else None
        if key is not None:
            key_bias[n] = diff[key].max().item() / lr
            rest = torch.ones(diff.shape[0], dtype=torch.bool, device=diff.device)
            rest[key] = False
            diff, moved = (None if t is None else t[rest] for t in (diff, moved))
        diffs[group][n] = diff.max().item() / (1.0 if group == "buffer" else lr)
        if moved is not None:
            update_rel[n] = (diff.norm() / moved.norm().clamp_min(1e-30)).item()
    out = {}
    for key, values in (("moment_rel", moment_rel), ("param_per_lr", diffs["trainable"]), ("update_rel", update_rel),
                        ("teacher_per_lr", diffs["teacher"]), ("center_abs", diffs["buffer"]), ("key_bias_per_lr", key_bias)):
        out[key], out[f"{key}_worst"] = _worst(values)
    return out


def ssl_rank(case: dict, n_devices: int, mp: int, device: str, reference: str | None = None, warm_up: bool = False, build=None) -> dict:
    """One rank of the case's SSL Trainer run on a dp x mp mesh (the module from ``build``, as in
    :func:`ssl_fit`). Every rank returns each step's global loss and scalars, whether its replicated
    parameters and buffers equal rank 0's, and its attention calls; rank 0 also the gathered state
    dict and AdamW moments, or, given the single process's (``reference``, a saved {"moments",
    "state"}), only :func:`ssl_readings` against them (the moments of a large model are too many
    bytes to send back). ``warm_up`` as :func:`ppo_rank`'s."""
    from .mesh import gather_state

    case = load_case(case)
    mesh = make_mesh(n_devices, mp=mp, device=device)
    if warm_up:
        ssl_fit(dict(case, ckpt_dir=None), mesh, mesh.device, record=False, build=build)
    with AttentionLog(mesh.device) as log:
        history, module, steps, moments = ssl_fit(case, mesh, mesh.device, build=build)
    state = gather_state(module, mesh)  # collective; None off rank 0
    out = {"history": history, "steps": steps, "replicated": replication_check(module, mesh), "attention": dict(log.calls),
           "shapes": dict(log.shapes), **log.counts}
    if mesh.is_main and reference is None:
        out.update(state=state, moments=moments)
    elif mesh.is_main:
        ref = torch.load(reference, map_location="cpu", weights_only=False)
        out["readings"] = ssl_readings(module, len(case["batches"]), case["epochs"], moments, state, ref["moments"], ref["state"], case["init"])
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def ssl_losses_rank(n_devices: int, mp: int, device: str, seed: int = 0) -> dict:
    """The batch statistics of the SSL losses on a dp x mp mesh, each from this rank's rows of a
    global batch (the same on every rank, from ``seed``) against the same function on the whole
    global batch: {check: {"mesh": error, "local": error}}, errors relative to the largest value.
    "mesh" is the function with the mesh (a loss: the dp sum of the ranks' shares; a gradient:
    this rank's rows of it); "local" the same function without the mesh on this rank's rows alone
    (a loss: the dp sum of its value / dp), which a mesh run must not compute."""
    import copy as copy_module

    from .. import ssl
    from ..models.vit import VisionTransformer, vit_predictor
    from ..ssl import losses

    mesh = make_mesh(n_devices, mp=mp, device=device)
    g = torch.Generator().manual_seed(seed)
    dev = mesh.device
    rand = lambda *shape: torch.randn(*shape, generator=g).to(dev)  # noqa: E731
    rows = mesh.rows(8)
    mine = lambda t, axis=0: t.narrow(axis, rows.start, rows.stop - rows.start)  # noqa: E731
    dp_total = lambda t: mesh.all_reduce_dp(t.detach().clone().reshape(1))[0]  # noqa: E731
    out = {}

    def check(name, mesh_value, local_value, global_value):
        out[name] = {"mesh": _rel(mesh_value, global_value), "local": _rel(local_value, global_value)}

    center = rand(1, 16)
    for kind, t in (("cls", rand(8, 16)), ("patch", rand(8, 5, 16))):
        check(f"update_center {kind}", losses.update_center(center.reshape((1,) * (t.dim() - 1) + (16,)), mine(t), mesh=mesh),
              losses.update_center(center.reshape((1,) * (t.dim() - 1) + (16,)), mine(t)),
              losses.update_center(center.reshape((1,) * (t.dim() - 1) + (16,)), t))
    logits = rand(8, 16)
    check("sinkhorn_knopp cls", losses.sinkhorn_knopp_teacher(mine(logits), 0.1, mesh=mesh),
          losses.sinkhorn_knopp_teacher(mine(logits), 0.1), mine(losses.sinkhorn_knopp_teacher(logits, 0.1)))
    patches, keep = rand(8 * 5, 16), (torch.rand(8 * 5, generator=g) < 0.4).to(dev)
    keep[::5] = True
    ibot = lambda p, k, m=None: losses.sinkhorn_knopp_teacher(p, 0.1, n_samples=k.sum(), sample_mask=k, mesh=m)  # noqa: E731
    part = slice(rows.start * 5, rows.stop * 5)
    check("sinkhorn_knopp patches", ibot(patches[part], keep[part], mesh), ibot(patches[part], keep[part]), ibot(patches, keep)[part])
    s, tp = rand(2, 8, 5, 16), torch.softmax(rand(2, 8, 5, 16), -1)
    km = torch.rand(2, 8, 5, generator=g).to(dev) < torch.linspace(0.1, 0.9, 8, device=dev)[None, :, None]
    check("ibot_patch_loss_all_pairs", dp_total(losses.ibot_patch_loss_all_pairs(mine(s, 1), mine(tp, 1), mine(km, 1), mesh=mesh)),
          dp_total(losses.ibot_patch_loss_all_pairs(mine(s, 1), mine(tp, 1), mine(km, 1)) / mesh.dp),
          losses.ibot_patch_loss_all_pairs(s, tp, km).reshape(1)[0])
    x = rand(8, 12)
    grads = {}
    for key, fn in (("global", lambda v: losses.koleo_loss(v)), ("mesh", lambda v: losses.koleo_loss(v, mesh=mesh)),
                    ("local", lambda v: losses.koleo_loss(v) / mesh.dp)):
        v = (x if key == "global" else mine(x)).clone().requires_grad_(True)
        value = fn(v)
        value.backward()
        grads[key] = (value.detach() if key == "global" else dp_total(value), v.grad if key != "global" else mine(v.grad))
    check("koleo_loss", grads["mesh"][0], grads["local"][0], grads["global"][0])
    check("koleo_loss gradient", grads["mesh"][1], grads["local"][1], grads["global"][1])

    vit = dict(img_size=(16, 16), patch_size=4, in_chans=3, embed_dim=16, depth=1, num_heads=2, pos_embed_fn="sinusoidal")
    images = torch.rand(8, 16, 16, 3, generator=g).to(dev)
    torch.manual_seed(seed)
    ijepa = ssl.IJEPAModule(VisionTransformer(**vit), vit_predictor(16, patch_size=4, img_size=(16, 16), in_chans=3, embed_dim=16, depth=1,
                                                                    num_heads=2, num_mask_tokens=4)).to(dev)
    # target blocks of one size share every sample's weight; a count that differs by sample tells a
    # global normaliser from a rank's
    targets = (torch.rand(4, 8, 16, generator=g) < torch.linspace(0.1, 0.6, 8)[None, :, None]).to(dev)
    targets[:, :, 0] = True
    ctx = ssl.ijepa.cut_context((torch.rand(8, 16, generator=g) < 0.9).to(dev), targets)
    with torch.no_grad():
        want = ijepa.forward_loss(images, ctx, targets)
        local = dp_total(ijepa.forward_loss(mine(images), mine(ctx), mine(targets, 1)) / mesh.dp)
        ijepa.mesh = mesh
        check("ijepa smooth-L1 normaliser", dp_total(ijepa.forward_loss(mine(images), mine(ctx), mine(targets, 1))), local, want)

    for centering in ("centering", "sinkhorn_knopp"):
        torch.manual_seed(seed)
        dino = ssl.DINOv2Module(VisionTransformer(**vit, num_register_tokens=1), centering=centering, dino_out_dim=16, dino_hidden_dim=16,
                                dino_bottleneck_dim=8, num_local_masks=2, with_reconstruction_probe=False).to(dev)
        dino.center.normal_(generator=torch.Generator(device=dev).manual_seed(seed))
        gm, lm = dino.sample_masks(torch.Generator(device=dev).manual_seed(seed + 1), 8)
        runs = {}
        for key in ("global", "local", "mesh"):
            m = copy_module.deepcopy(dino)
            m.mesh = mesh if key == "mesh" else None
            with torch.no_grad():
                if key == "global":
                    loss, aux = m.forward_loss(images, gm, lm, 0.05)
                else:
                    loss, aux = m.forward_loss(mine(images), mine(gm, 1), mine(lm, 1), 0.05)
                    loss = dp_total(loss if key == "mesh" else loss / mesh.dp)
                m.on_train_batch_end(aux, 0)
            runs[key] = (loss, torch.cat([m.center.reshape(-1), m.ibot_center.reshape(-1)]))
        check(f"dinov2 {centering} loss", runs["mesh"][0], runs["local"][0], runs["global"][0])
        if centering == "centering":
            check("dinov2 centering centers", runs["mesh"][1], runs["local"][1], runs["global"][1])
    return out


# --------------------------------------------------------------------------------------------- #
# the downstream task modules on the SSL Trainer
# --------------------------------------------------------------------------------------------- #
def task_module(case: dict):
    """The case's downstream task module (f32) with its full initial weights (``init``; its own
    where that is None): the ViT ``encoder`` (a config block with its ``_target_``) under a
    ``probe`` in an SL ``module``, or under a force-field ``decoder`` (ForceFieldDecoder's keyword
    arguments) in ForceFieldModule or GeometricForceFieldModule; ``probe`` and ``module`` are (a
    class of ``tasks``, its keyword arguments)."""
    from .. import tasks
    from ..utils.config import instantiate

    encoder = instantiate(case["encoder"])
    name, kw = case["module"]
    if "probe" in case:
        probe, probe_kw = case["probe"]
        module = getattr(tasks, name)(encoder, getattr(tasks, probe)(encoder.embed_dim, **probe_kw), **kw)
    else:
        module = getattr(tasks, name)(tasks.ForceFieldDecoder(encoder, **case["decoder"]), **kw)
    if case.get("init") is not None:
        module.load_state_dict(case["init"])
    return module


def task_fit(case: dict, mesh=None, device: str | torch.device = "cpu", record: bool = True):
    """:func:`ssl_fit` of the case's task module (:func:`task_module`)."""
    return ssl_fit(case, mesh, device, record, build=task_module)


def task_rank(case: dict, n_devices: int, mp: int, device: str, reference: str | None = None, warm_up: bool = False) -> dict:
    """:func:`ssl_rank` of the case's task module (:func:`task_module`)."""
    return ssl_rank(case, n_devices, mp, device, reference, warm_up, build=task_module)


def task_stats_rank(n_devices: int, mp: int, device: str, seed: int = 0) -> dict:
    """The task modules' batch statistics on a dp x mp mesh, as :func:`ssl_losses_rank` holds the
    SSL losses': {check: {"mesh": error, "local": error}}, from this rank's rows of a global batch of
    8 against the global batch. ``weighted_ce`` with class weights (the ranks' labels weigh
    differently) and its gradient; the force probe's ``rmse_{x,y,z}`` (ForceSLModule over an
    identity encoder and a linear head) and the geometric force field's SL ``rmse_f{x,y,z}``
    (``sl_force_terms``), whose targets grow in size from row to row so each rank's RMSE differs."""
    from torch import nn

    from .. import tasks
    from ..models.vit import VisionTransformer
    from ..ssl.losses import dp_sum
    from ..tasks.modules import weighted_ce

    mesh = make_mesh(n_devices, mp=mp, device=device)
    g = torch.Generator().manual_seed(seed)
    dev = mesh.device
    rand = lambda *shape: torch.randn(*shape, generator=g).to(dev)  # noqa: E731
    rows = mesh.rows(8)
    mine = lambda t: t[rows]  # noqa: E731
    dp_total = lambda t: dp_sum(t.detach().clone().reshape(1), mesh)[0]  # noqa: E731
    out = {}

    def check(name, mesh_value, local_value, global_value):
        out[name] = {"mesh": _rel(mesh_value, global_value), "local": _rel(local_value, global_value)}

    weights = torch.tensor([1.0, 4.0, 0.5], device=dev)
    labels = torch.tensor([1, 1, 1, 0, 2, 0, 0, 2], device=dev)  # weight sums 13 and 3 over the two halves
    logits = rand(8, 3)
    grads = {}
    for key in ("global", "mesh", "local"):
        x = (logits if key == "global" else mine(logits)).clone().requires_grad_(True)
        lab = labels if key == "global" else mine(labels)
        value = weighted_ce(x, lab, weights, mesh if key == "mesh" else None)
        value = value / mesh.dp if key == "local" else value
        value.backward()
        grads[key] = (value.detach() if key == "global" else dp_total(value), mine(x.grad) if key == "global" else x.grad)
    check("weighted_ce", grads["mesh"][0], grads["local"][0], grads["global"][0])
    check("weighted_ce gradient", grads["mesh"][1], grads["local"][1], grads["global"][1])

    torch.manual_seed(seed)
    force = tasks.ForceSLModule(nn.Identity(), nn.Linear(6, 3)).to(dev)
    spread = torch.linspace(0.2, 3.0, 8, device=dev)[:, None]
    batch = {"image": rand(8, 6), "force": rand(8, 3).sign() * spread, "force_scale": torch.full((8, 3), 2.0, device=dev)}
    with torch.no_grad():
        want = force.training_loss(batch, None, 0)[1]
        local = force.training_loss({k: mine(v) for k, v in batch.items()}, None, 0)[1]
        force.use_mesh(mesh)
        got = force.training_loss({k: mine(v) for k, v in batch.items()}, None, 0)[1]
    for a in "xyz":
        check(f"rmse_{a}", dp_total(got[f"rmse_{a}"]), dp_total(local[f"rmse_{a}"] / mesh.dp), want[f"rmse_{a}"])

    torch.manual_seed(seed)
    vit = VisionTransformer(img_size=(16, 16), patch_size=4, in_chans=6, embed_dim=16, depth=1, num_heads=2, pos_embed_fn="sinusoidal")
    geo = tasks.GeometricForceFieldModule(tasks.ForceFieldDecoder(vit, hooks=(0,), fusion_ch=8), with_sl_supervision=True).to(dev)
    disp, shear = torch.rand(8, 16, 16, 1, generator=g).to(dev), rand(8, 16, 16, 2) * spread[:, :, None, None]
    target = rand(8, 3).sign() * spread
    with torch.no_grad():
        want = geo.sl_force_terms(disp, shear, target)[1]
        local = geo.sl_force_terms(mine(disp), mine(shear), mine(target))[1]
        geo.use_mesh(mesh)
        got = geo.sl_force_terms(mine(disp), mine(shear), mine(target))[1]
    for a in "xyz":
        check(f"rmse_f{a}", dp_total(got[f"rmse_f{a}"]), dp_total(local[f"rmse_f{a}"] / mesh.dp), want[f"rmse_f{a}"])
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
