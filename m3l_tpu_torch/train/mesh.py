"""Multi-device training on ``torch.distributed`` (counterpart of ``m3l_tpu/train/mesh.py``).

The JAX mesh is GSPMD under one controller: one process drives a dp x mp ``Mesh``, the kernels
that match ``_TP_RULES`` are split over ``mp``, everything else is replicated, batches are split
over ``dp``, and XLA inserts the collectives. A JAX mesh run therefore computes the
single-device result on the global batch; only the order of the reductions changes. The port
keeps that contract in multi-process SPMD: one process per rank, each seeing only its own rows,
so every batch statistic takes an explicit collective.

* :class:`Mesh` / :func:`make_mesh`: rank r sits at (dp index r // mp, mp index r % mp), as JAX
  reshapes its devices to (n // mp, mp). The mp group holds the ranks that share a batch shard,
  the dp group the ranks that hold the same parameter shard. The backend is a fixed rule, not a
  fallback: nccl when every rank has a card of its own, gloo when ranks share a card or run on
  the CPU (nccl refuses two ranks on one device).
* :func:`launch`: ``world`` processes through ``torch.multiprocessing`` (``spawn``) that
  rendezvous through a ``file://`` path in a temporary directory; under ``torchrun`` (or inside
  a group already started) it joins that group instead.
* :func:`shard_module`: Megatron's tensor parallelism over the rule pairs of ``_TP_RULES``
  (``to_qkv``/``to_out``, ``attn/qkv``/``attn/proj``, ``xattn/q``, ``xattn/kv``/``xattn/proj``,
  ``fc1``/``fc2`` of the MLPs and of the slip-with-force probe, ``w12``/``w3``). A
  column-parallel layer keeps the output columns of its share of the heads (of the hidden
  units), biases with them, behind ``f`` (identity forward,
  all-reduce backward); a row-parallel layer keeps the matching input columns and adds its
  (replicated) bias once, after ``g`` (all-reduce forward, identity backward). The packed qkv
  is [3][H][Dh], so rank j's ``to_qkv`` rows are, for each of q, k and v, those of heads
  [j H/mp, (j+1) H/mp); ``xattn/kv`` ([2][H][Dh]) and ``w12`` ([x1 | x2]) take their halves
  the same way. Each rank's attention layer then runs the packed kernel on H/mp heads. JAX's
  ``P(None, "mp")`` is a contiguous cut that GSPMD reshards behind the scenes: the same function
  on a different physical shard.
* :func:`put_batch`: this rank's rows of every leaf's leading axis. :func:`gather_state`: the
  full state dict on rank 0 (buffers, such as the DINO centers, are replicated and pass as they
  are). :func:`gather_dp`: the dp group's rows of a batch tensor on each rank, differentiably (the
  KoLeo loss's neighbours). Every collective is an ``all_reduce`` or a ``broadcast``, the two
  that gloo also runs on CUDA tensors, so one code path serves nccl, gloo on the CPU and gloo on
  a shared card (a gather is the all-reduce of a zero-filled full buffer).

Gradients: each rank computes its share of the global loss (a mean over the batch becomes this
rank's rows' sum over the global count), and the optimizers (``train/optim.py``) sum the
gradients over the dp group in one all-reduce of the flat gradient; under mp the replicated
part is then taken from the mp group's first rank, so every rank applies the same bits. The
modules are not wrapped in ``DistributedDataParallel``: it hooks ``forward``, and the port
trains through other methods.
"""
from __future__ import annotations

import io
import os
import queue as queue_module
import re
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..nn import transformer as rl_layers
from ..nn import vit_layers
from ..nn.layers import Linear

# JAX's rules (m3l_tpu/train/mesh.py _TP_RULES) on the nnx parameter paths that
# utils/convert.py load_jax_params maps: column-parallel into the hidden dim, row-parallel out.
_TP_RULES: list[tuple[re.Pattern, str]] = [
    (re.compile(r"to_qkv.*kernel"), "column"),
    (re.compile(r"to_out.*kernel"), "row"),
    (re.compile(r"(^|/)(attn|xattn|cross)/(qkv|q|kv)/kernel"), "column"),
    (re.compile(r"(^|/)(attn|xattn|cross)/proj/kernel"), "row"),
    (re.compile(r"\bfc1\b.*kernel"), "column"),
    (re.compile(r"\bfc2\b.*kernel"), "row"),
    (re.compile(r"(^|/)w12/kernel"), "column"),
    (re.compile(r"(^|/)w3/kernel"), "row"),
]

# The Megatron pairs: module class -> (column layers with their packed parts, row layer, the
# attribute that counts heads or hidden units, which mp must divide).
_PAIRS = {
    rl_layers.Attention: ((("to_qkv", 3),), "to_out", "heads"),
    rl_layers.FeedForward: ((("fc1", 1),), "fc2", None),
    vit_layers.Attention: ((("qkv", 3),), "proj", "num_heads"),
    vit_layers.CrossAttention: ((("q", 1), ("kv", 2)), "proj", "num_heads"),
    vit_layers.Mlp: ((("fc1", 1),), "fc2", None),
    vit_layers.SwiGLUFFN: ((("w12", 2),), "w3", "hidden"),
}


def _pairs() -> dict:
    """:data:`_PAIRS` and the slip-with-force probe's ``fc1`` / ``fc2`` (its input, the pooled token
    beside the projected force, is replicated). The probe is imported here, not at the top: the
    task package imports ``ssl``, which imports this module."""
    from ..tasks.probes import SlipForceProbe

    return {**_PAIRS, SlipForceProbe: ((("fc1", 1),), "fc2", None)}


def jax_path(name: str) -> str:
    """The nnx path of a Linear weight's torch name (``a.b.weight`` -> ``a/b/kernel``), as
    ``load_jax_params`` maps it."""
    *path, leaf = name.split(".")
    return "/".join([*path, "kernel" if leaf == "weight" else leaf])


def tp_rule(path: str) -> str | None:
    """"column", "row" or None: JAX's rule for the 2-D kernel at nnx ``path``."""
    for pattern, kind in _TP_RULES:
        if pattern.search(path):
            return kind
    return None


# --------------------------------------------------------------------------------------------- #
# the mesh
# --------------------------------------------------------------------------------------------- #
def backend_for(world: int, device: str | torch.device) -> str:
    """The fixed rule: nccl when ``device`` is cuda and every rank has a card of its own on this
    host, gloo when ranks share a card or run on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


@dataclass(eq=False)
class Mesh:
    """This rank's place in a dp x mp mesh: the sizes, its (dp, mp) indices, the process
    subgroups (None where a group has one rank), the backend and the device."""

    world: int
    dp: int
    mp: int
    rank: int
    dp_index: int
    mp_index: int
    dp_group: Any
    mp_group: Any
    backend: str
    device: torch.device

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, mp={self.mp}, rank {self.rank} at dp {self.dp_index} mp {self.mp_index}, "
                f"backend={self.backend}, device={self.device})")

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _reduce(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        if size > 1:
            dist.all_reduce(t, group=group)
        return t

    def all_reduce_dp(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the dp group."""
        return self._reduce(t, self.dp_group, self.dp)

    def all_reduce_mp(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the mp group."""
        return self._reduce(t, self.mp_group, self.mp)

    def global_mean(self, shares: torch.Tensor) -> torch.Tensor:
        """The global value of per-rank shares (a loss share, a metric share): summed over every
        rank and divided by mp, so all ranks hold the same bits (a gate read from them cannot
        disagree)."""
        t = shares.detach().float().clone()
        if self.world > 1:
            dist.all_reduce(t)
        return t / self.mp

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``: [d n/dp, (d+1) n/dp)."""
        if n % self.dp:
            raise ValueError(f"batch {n} does not divide over dp={self.dp}")
        b = n // self.dp
        return slice(self.dp_index * b, (self.dp_index + 1) * b)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (any picklable value) on every rank."""
        if self.world == 1:
            return obj
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, device=self.device if self.backend == "nccl" else None)
        return box[0]


def make_mesh(n_devices: int | None = None, mp: int = 1, *, device: str | torch.device = "cuda") -> Mesh:
    """The dp x mp mesh over the ranks of the running process group (``n_devices`` defaults to
    its size and must equal it). Without a group, one rank starts its own (a 1-rank mesh through
    the same code); more ranks need :func:`launch` or ``torchrun``. Rank r runs on
    ``cuda:(r % device_count)``. The backend is :func:`backend_for`'s, or the running group's."""
    dev = torch.device(device)
    if n_devices is not None and n_devices % mp:
        raise ValueError(f"{n_devices} devices not divisible by mp={mp}")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"make_mesh: {n_devices} devices need {n_devices} processes: start them with launch() or torchrun")
        tmp = tempfile.mkdtemp(prefix="m3l_mesh_")
        dist.init_process_group(backend_for(1, dev), init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
    world, rank = dist.get_world_size(), dist.get_rank()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices but the process group has {world} ranks")
    if world % mp:
        raise ValueError(f"{world} devices not divisible by mp={mp}")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dp = n_devices // mp
    # every rank creates every subgroup, in the same order (new_group is collective)
    dp_groups = [dist.new_group([i * mp + j for i in range(dp)]) if dp > 1 else None for j in range(mp)]
    mp_groups = [dist.new_group([i * mp + j for j in range(mp)]) if mp > 1 else None for i in range(dp)]
    i, j = divmod(rank, mp)
    return Mesh(world, dp, mp, rank, i, j, dp_groups[j], mp_groups[i], dist.get_backend(), dev)


def launch(fn: Callable, *args, world: int, device: str | torch.device = "cuda", timeout: float | None = None) -> list:
    """``fn(*args)`` on ``world`` ranks of one process group; returns the ranks' results in rank
    order (each moved to the CPU through ``torch.save``), or, where this process already is a rank
    (inside a started group, or under ``torchrun``), ``[fn(*args)]`` of this rank alone. ``fn`` must
    be importable by name (it lives in a module, not a test file). The first rank's exception is
    raised here with its traceback; the other ranks are then stopped."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"launch: world {world} inside a process group of {dist.get_world_size()} ranks")
        return [fn(*args)]
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # under torchrun: join its group
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"launch: world {world} under torchrun's WORLD_SIZE {os.environ['WORLD_SIZE']}")
        dist.init_process_group(backend_for(world, device), init_method="env://")
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()
    ctx = torch.multiprocessing.get_context("spawn")
    results: dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="m3l_launch_") as tmp:
        inbox = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main, args=(r, world, f"file://{tmp}/rendezvous", backend_for(world, device), str(device), fn, args, inbox))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    rank, ok, payload = inbox.get(timeout=1.0)
                except queue_module.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                    if dead:
                        raise RuntimeError(f"launch: rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no result")
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(f"launch: {world} ranks did not finish within {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"launch: rank {rank} failed:\n{payload}")
                results[rank] = torch.load(io.BytesIO(payload), map_location="cpu", weights_only=False)
            for p in procs:
                p.join()
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join()
    return [results[r] for r in range(world)]


def _rank_main(rank: int, world: int, init_method: str, backend: str, device: str, fn: Callable, args: tuple, outbox) -> None:
    """One rank of :func:`launch`: join the group, run ``fn``, post its result or traceback."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)  # ranks on one host's cores would oversubscribe them
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        result = fn(*args)
        buf = io.BytesIO()
        torch.save(result, buf)
        outbox.put((rank, True, buf.getvalue()))
    except Exception:  # noqa: BLE001 -- every failure goes back to the caller, which raises it
        outbox.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class EnvSpec:
    """What a rank without the envs knows of rank 0's: their count and spaces."""

    def __init__(self, num_envs: int, observation_space, action_space):
        self.num_envs, self.observation_space, self.action_space = num_envs, observation_space, action_space

    def close(self) -> None:
        pass


def is_main(mesh: Mesh | None) -> bool:
    """Whether this process is rank 0 (or runs without a mesh): the one that owns the envs, logs
    and writes checkpoints."""
    return mesh is None or mesh.is_main


def on_main(mesh: Mesh | None, fn: Callable):
    """``fn()`` run on rank 0 and its result on every rank (collective); ``fn()`` without a mesh."""
    if mesh is None:
        return fn()
    return mesh.broadcast_object(fn() if mesh.is_main else None)


def env_spec(env, mesh: Mesh | None):
    """``env`` itself on rank 0 (and without a mesh); on the other ranks an :class:`EnvSpec` of
    rank 0's (collective). Rank 0 owns the envs, as JAX's single controller does."""
    if mesh is None:
        return env
    spec = mesh.broadcast_object((env.num_envs, env.observation_space, env.action_space) if mesh.is_main else None)
    return env if mesh.is_main else EnvSpec(*spec)


# --------------------------------------------------------------------------------------------- #
# Megatron's f and g, and the sharded layers
# --------------------------------------------------------------------------------------------- #
def _sum_over_mp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mp-group sum of ``x``, taken in f32 and returned in ``x``'s dtype."""
    y = x.float().contiguous().clone()
    return mesh.all_reduce_mp(y).to(x.dtype)


class _CopyToMP(torch.autograd.Function):
    """Megatron's f: identity forward, the mp-group all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_mp(g, ctx.mesh), None


class _ReduceFromMP(torch.autograd.Function):
    """Megatron's g: the mp-group all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_over_mp(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDP(torch.autograd.Function):
    """The dp group's rows of ``x`` in one (B_global, ...) tensor: forward, this rank's rows written
    into a zero-filled buffer and the buffer all-reduced over dp; backward, the gradient buffer
    all-reduced over dp and this rank's rows of it kept."""

    @staticmethod
    def forward(ctx, x, mesh):
        rows = mesh.rows(x.shape[0] * mesh.dp)
        full = x.new_zeros((x.shape[0] * mesh.dp, *x.shape[1:]))
        full[rows] = x
        ctx.mesh, ctx.rows = mesh, rows
        return mesh.all_reduce_dp(full)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_dp(g.contiguous().clone())[ctx.rows], None


def gather_dp(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every dp rank's rows of ``x`` (this rank's (B / dp, ...) share of a global batch), in the
    global batch's order, on each rank (collective over the dp group; ``x`` itself without one).
    Differentiable: a rank's gradient for its rows is the sum of every rank's gradient for them, so
    with the optimizers' dp sum of the parameter gradients the total is the global loss's. A
    gather is the all-reduce of a zero-filled buffer, as gloo on CUDA runs no ``all_gather``."""
    if mesh is None or mesh.dp == 1:
        return x
    return _GatherDP.apply(x, mesh)


def _take_shard(full: torch.Tensor, axis: int, parts: int, mp: int, j: int) -> torch.Tensor:
    """Rank j's share of ``full`` along ``axis``, cut as [parts][mp][chunk]."""
    return full.unflatten(axis, (parts, mp, -1)).select(axis + 1, j).flatten(axis, axis + 1).contiguous()


def _place_shard(local: torch.Tensor, axis: int, parts: int, mp: int, j: int) -> torch.Tensor:
    """A zero tensor of the full shape with rank j's share ``local`` in its place."""
    shape = list(local.shape)
    shape[axis] *= mp
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    full.unflatten(axis, (parts, mp, -1)).select(axis + 1, j).copy_(local.unflatten(axis, (parts, -1)))
    return full


class _ShardedLinear(Linear):
    """A Linear holding rank ``mesh.mp_index``'s share of a full Linear's weight (and bias); each
    sharded parameter carries its cut as ``_mesh_shard = (axis, parts)``."""

    def __init__(self, full: Linear, mesh: Mesh, parts: int, column: bool):
        nn.Module.__init__(self)
        j, mp = mesh.mp_index, mesh.mp
        with torch.no_grad():
            weight = _take_shard(full.weight, 0 if column else 1, parts, mp, j)
            bias = None if full.bias is None else (_take_shard(full.bias, 0, parts, mp, j) if column else full.bias.clone())
        self.in_features, self.out_features = weight.shape[1], weight.shape[0]
        self.compute_dtype = full.compute_dtype
        # a frozen layer (an EMA teacher's) stays frozen
        self.weight = nn.Parameter(weight, requires_grad=full.weight.requires_grad)
        self.weight._mesh_shard = (0 if column else 1, parts)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=full.bias.requires_grad)
        if bias is not None and column:
            self.bias._mesh_shard = (0, parts)
        self.mesh = mesh


class ColumnParallelLinear(_ShardedLinear):
    def __init__(self, full: Linear, mesh: Mesh, parts: int = 1):
        super().__init__(full, mesh, parts, column=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_CopyToMP.apply(x, self.mesh))


class RowParallelLinear(_ShardedLinear):
    def __init__(self, full: Linear, mesh: Mesh):
        super().__init__(full, mesh, 1, column=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = _ReduceFromMP.apply(F.linear(x.to(dt), self.weight.to(dt)).float(), self.mesh)
        return (y if self.bias is None else y + self.bias).to(dt)


def shard_spec(p: torch.Tensor) -> tuple[int, int] | None:
    """(axis, parts) of a sharded parameter, None for a replicated one."""
    return getattr(p, "_mesh_shard", None)


def rule_matches(module: nn.Module) -> dict[str, str]:
    """{Linear name: "column" | "row"} for every Linear of ``module`` whose weight JAX's rules
    shard."""
    out = {}
    for name, sub in module.named_modules():
        if isinstance(sub, nn.Linear):
            kind = tp_rule(jax_path(f"{name}.weight"))
            if kind is not None:
                out[name] = kind
    return out


def shard_module(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace, in place, every rule pair of ``module`` with this rank's shards of its full
    weights (see the module docstring); a no-op for mp 1. Raises, before it changes anything,
    for a rule match outside a pair and where mp does not divide a pair's heads or hidden
    width. Call it before the optimizers are built."""
    if mesh.mp == 1:
        return module
    matches = rule_matches(module)
    pairs = _pairs()
    plan, covered = [], set()
    for name, sub in module.named_modules():
        spec = pairs.get(type(sub))
        if spec is None:
            continue
        columns, row, count_attr = spec
        prefix = f"{name}." if name else ""
        kinds = {f"{prefix}{c}": "column" for c, _ in columns} | {f"{prefix}{row}": "row"}
        present = {n: matches.get(n) for n in kinds}
        if not any(present.values()):
            continue
        if present != kinds:
            raise ValueError(f"shard_module: {name or type(sub).__name__} matches the rules only in part ({present}); not a Megatron pair")
        width = getattr(sub, count_attr) if count_attr else getattr(sub, columns[0][0]).out_features
        if width % mesh.mp:
            raise ValueError(f"shard_module: mp={mesh.mp} does not divide {name}'s {count_attr or 'hidden width'} {width}")
        covered.update(kinds)
        plan.append((sub, columns, row, count_attr))
    stray = sorted(set(matches) - covered)
    if stray:
        raise ValueError(f"shard_module: {stray} match the tensor-parallel rules but are not part of a Megatron pair")
    for sub, columns, row, count_attr in plan:
        for c, parts in columns:
            setattr(sub, c, ColumnParallelLinear(getattr(sub, c), mesh, parts))
        setattr(sub, row, RowParallelLinear(getattr(sub, row), mesh))
        if count_attr:
            setattr(sub, count_attr, getattr(sub, count_attr) // mesh.mp)
    return module


# --------------------------------------------------------------------------------------------- #
# batches, gradients and state
# --------------------------------------------------------------------------------------------- #
def tree_map(fn: Callable, tree):
    """``fn`` on every tensor or array leaf of nested dicts, lists, tuples and named tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def put_batch(tree, mesh: Mesh | None):
    """This rank's rows of every leaf's leading (batch) axis; every leaf's batch must divide by
    dp (GSPMD refuses a batch it cannot split evenly)."""
    if mesh is None or mesh.dp == 1:
        return tree
    return tree_map(lambda x: x[mesh.rows(x.shape[0])], tree)


def sharded_mask(params: list[torch.Tensor]) -> torch.Tensor | None:
    """A bool mask over the flat concatenation of ``params``: True at sharded elements (None if
    none is sharded)."""
    if not any(shard_spec(p) for p in params):
        return None
    return torch.cat([torch.full((p.numel(),), shard_spec(p) is not None, device=p.device) for p in params])


def reduce_flat_grad(g: torch.Tensor, mesh: Mesh, mask: torch.Tensor | None) -> torch.Tensor:
    """The dp-group sum of the flat gradient ``g``, in place, in one all-reduce; under mp the
    replicated elements (``mask`` False) are then rank mp 0's, so every rank holds the same bits."""
    mesh.all_reduce_dp(g)
    if mesh.mp > 1:
        rep = g[~mask] if mask is not None else g.clone()
        if mesh.mp_group is not None:
            dist.broadcast(rep, src=mesh.rank - mesh.mp_index, group=mesh.mp_group)
        if mask is not None:
            g[~mask] = rep
        else:
            g.copy_(rep)
    return g


def sum_of_squares(g: torch.Tensor, mesh: Mesh | None, mask: torch.Tensor | None) -> torch.Tensor:
    """The global sum of squares of a flat gradient: the replicated part's, plus the mp-group sum
    of the sharded part's."""
    if mesh is None or mask is None:
        return torch.sum(torch.square(g))
    sharded = torch.sum(torch.square(g[mask])).reshape(1)
    return torch.sum(torch.square(g[~mask])) + mesh.all_reduce_mp(sharded)[0]


def _gather(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    if spec is None:
        return t.detach()
    axis, parts = spec
    return mesh.all_reduce_mp(_place_shard(t.detach(), axis, parts, mesh.mp, mesh.mp_index))


def gather_like(t: torch.Tensor, p: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``t``, shaped and sharded as parameter ``p`` (a moment, an accumulated gradient), gathered
    to the full shape (collective)."""
    return t if mesh is None else _gather(t, shard_spec(p), mesh)


def shard_like(t: torch.Tensor, p: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's share of a full-shape ``t`` sharded as parameter ``p``."""
    spec = None if mesh is None else shard_spec(p)
    return t if spec is None else _take_shard(t, spec[0], spec[1], mesh.mp, mesh.mp_index)


def gather_state(module: nn.Module, mesh: Mesh | None) -> dict | None:
    """The full, unsharded state dict of ``module``: on rank 0; None on the others (collective:
    every rank calls it)."""
    sd = module.state_dict()
    if mesh is None:
        return sd
    params = dict(module.named_parameters())
    full = {k: _gather(v, shard_spec(params[k]) if k in params else None, mesh) for k, v in sd.items()}
    return full if mesh.is_main else None


def shard_state(full: dict, module: nn.Module, mesh: Mesh | None) -> dict:
    """This rank's shares of a full (single-process) state dict, for ``module.load_state_dict``."""
    if mesh is None:
        return full
    params = dict(module.named_parameters())
    out = {}
    for k, v in full.items():
        spec = shard_spec(params[k]) if k in params else None
        out[k] = v if spec is None else _take_shard(v, spec[0], spec[1], mesh.mp, mesh.mp_index)
    return out


def gather_flat(flat: torch.Tensor, params: list[torch.Tensor], mesh: Mesh | None) -> torch.Tensor:
    """A flat per-element vector over ``params`` (an optimizer moment), each parameter's slice
    gathered to its full shape: the single-process layout (collective)."""
    if mesh is None or mesh.mp == 1:
        return flat
    out, off = [], 0
    for p in params:
        out.append(_gather(flat[off : off + p.numel()].view_as(p), shard_spec(p), mesh).reshape(-1))
        off += p.numel()
    return torch.cat(out)


def shard_flat(full: torch.Tensor, params: list[torch.Tensor], mesh: Mesh | None) -> torch.Tensor:
    """The inverse of :func:`gather_flat`: this rank's elements of a single-process flat vector."""
    if mesh is None or mesh.mp == 1:
        return full
    out, off = [], 0
    for p in params:
        spec = shard_spec(p)
        shape = list(p.shape)
        if spec is not None:
            shape[spec[0]] *= mesh.mp
        n = 1
        for s in shape:
            n *= s
        piece = full[off : off + n].reshape(shape)
        out.append((piece if spec is None else _take_shard(piece, spec[0], spec[1], mesh.mp, mesh.mp_index)).reshape(-1))
        off += n
    if off != full.numel():
        raise ValueError(f"shard_flat: {full.numel()} values for parameters of {off}")
    return torch.cat(out)
