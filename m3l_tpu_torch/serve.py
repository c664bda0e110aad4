"""Serving: the flagship PPO+MAE policy as an in-process action server on the card, and as a
``torch.export`` artifact.

Counterpart of ``m3l_tpu/serve.py``: raw environment observations (uint8 image (B, fs, H, W, 3),
float tactile (B, fs, 6, h, w)) go in, actions come out. ``vt_load`` packing, feature extraction
and the policy heads all run on the device; the image crosses to the device as uint8. The
deterministic path serves the Gaussian mean; optional action bounds clip the result
(``PPOMAE.predict`` parity, ``m3l_tpu/rl/ppo_mae.py:436-442``).

* :class:`PolicyServer` runs the policy module in process; its stochastic path samples from a
  caller's ``torch.Generator``. On the card its deterministic path serves each request signature
  (the obs keys with each array's shape and dtype, whether bounds are set, and the math settings
  that pick the kernels) as one CUDA graph replay: the first request of a signature runs eagerly
  and captures the forward, later ones copy their obs into the graph's input buffers and replay
  it. The same kernels run on the same numbers, so the actions are bit-equal to the eager path's.
  In-place weight updates (``load_state_dict``, ``copy_``) keep their addresses and reach the
  graphs as they are; a weight whose storage moved (``.to()``, ``p.data = ...``, a replaced
  parameter, buffer or module) drops every graph, and each signature is captured again.
* :func:`export_policy` and :func:`export_encoder` trace the same computation with
  ``torch.export`` into an ``ExportedProgram`` (raw obs in, actions or features out), its
  weights baked in; :func:`save_artifact` / :func:`load_artifact` write and read it as a
  ``.pt2`` file. Run it with ``load_artifact(path).module()(obs)``.

Where the artifact's contract differs from JAX's StableHLO one:

* Shapes are static: one artifact per (batch, observation space) signature, as in JAX.
* The device replaces JAX's ``platforms``: a program is exported on one device (where the
  policy and the example inputs are placed) and runs there. One exported on the CPU runs on the
  card after ``load_artifact(path, device="cuda")`` (``torch.export.passes.move_to_device_pass``).
* The stochastic artifact takes ``(obs, noise)``, ``noise`` standard normal of shape
  (B, action_dim), where JAX's takes ``(obs, key)``: randomness is passed in, never sampled, and
  :meth:`PolicyServer.sample` draws exactly this noise from its generator.
* The attention runs as the ``m3l::flash_attention_qkv`` operator
  (``m3l_tpu_torch/nn/flash_attention.py``), one node a layer, which launches the CUDA kernel on
  the card and runs the plain version on the CPU. So the serving process needs the port's
  operators registered: :func:`load_artifact` imports that module first, which builds the
  kernels at their first launch. JAX's artifact needs no ``m3l_tpu`` code at all.
"""
from __future__ import annotations

import copy
import warnings
from itertools import chain
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .models import VTMAE, VTT, VTTConfig
from .rl import ActorCritic, MAEFeatures
from .utils import trace
from .utils.device import resolve_device

__all__ = [
    "build_policy",
    "random_obs",
    "PolicyServer",
    "export_fn",
    "export_policy",
    "export_encoder",
    "save_artifact",
    "load_artifact",
    "example_obs_for",
]


def build_policy(
    config: VTTConfig | None = None,
    *,
    action_dim: int = 3,
    decoder_depth: int = 3,
    decoder_heads: int = 4,
    early_conv_masking: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> ActorCritic:
    """VTT -> VTMAE -> MAEFeatures -> ActorCritic, wired as ``m3l_tpu/cli/train.py`` ``build_model``.

    ``config=None`` is the CLI's default encoder: dim 256, depth 4, 4 heads x 64, mlp 512, two
    tactile sensors, frame stack 4. The decoder has the encoder's width and the CLI's mask ratio
    0.95 (neither changes serving, which runs no decoder). Weights are drawn from torch's global
    generator on the CPU (seed it with ``torch.manual_seed``), kept float32, and moved to
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    c = config if config is not None else VTTConfig(frame_stack=4)
    mae = VTMAE(
        VTT(c, dtype=dtype),
        decoder_dim=c.dim,
        masking_ratio=0.95,
        decoder_depth=decoder_depth,
        decoder_heads=decoder_heads,
        early_conv_masking=early_conv_masking,
        dtype=dtype,
    )
    feats = MAEFeatures(mae, c.dim, frame_stack=c.frame_stack, dtype=dtype)
    return ActorCritic(feats, c.dim, action_dim, dtype=dtype).to(dev)


def random_obs(rng: np.random.Generator, batch: int, frame_stack: int = 4, image_size: int = 64, tactile_size: int = 32) -> dict:
    """Raw obs of the default encoder's env (or of one at other sizes), drawn from ``rng``: uint8
    image (B, fs, 64, 64, 3) and tactile in [-1, 1] (B, fs, 6, 32, 32) for two sensors. For timing
    and checks."""
    return {
        "image": rng.integers(0, 256, (batch, frame_stack, image_size, image_size, 3), dtype=np.uint8),
        "tactile": rng.uniform(-1, 1, (batch, frame_stack, 6, tactile_size, tactile_size)).astype(np.float32),
    }


MAX_GRAPHS = 4  # request signatures a PolicyServer holds graphs for; later ones are served eagerly


def _request_signature(obs: dict, bounded: bool) -> tuple | None:
    """What a request's CUDA graph is keyed by: each obs key with its array's shape and dtype,
    whether the actions are clipped, and the math settings that pick the kernels (TF32 in cuBLAS
    and cuDNN, cuBLAS's reduced-precision bf16 sums). None where an obs value is neither a numpy
    array nor a tensor."""
    arrays = []
    for k in sorted(obs):
        v = obs[k]
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            return None
        arrays.append((k, tuple(v.shape), str(v.dtype)))
    matmul = torch.backends.cuda.matmul
    return tuple(arrays), bounded, matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32


class _WeightStorage:
    """Where a module's weights lay when it was read: the identity of every parameter, buffer and
    submodule in the module's tree and the address of every parameter's and buffer's data.
    :meth:`moved` reads them again, iterating in C over the dicts and tensors found here (the
    flagship policy's 122 dicts and 148 tensors). In-place updates (``load_state_dict``,
    ``copy_``) move nothing; ``.to()``, ``p.data = ...`` and a replaced or added parameter, buffer
    or submodule do. The data, tensors and modules read are held, so no address or identity of
    them is reused meanwhile."""

    def __init__(self, module: nn.Module):
        self._modules = list(module.modules())
        self._dicts = [d for m in self._modules for d in (m._parameters, m._buffers, m._modules) if d]
        self._tensors = [t for m in self._modules for d in (m._parameters, m._buffers) for t in d.values() if t is not None]
        self._held = [t.detach() for t in self._tensors]
        self._key = self._read()

    def _read(self) -> tuple[list[int], list[int]]:
        return list(map(id, chain.from_iterable(map(dict.values, self._dicts)))), list(map(torch.Tensor.data_ptr, self._tensors))

    def moved(self) -> bool:
        return self._read() != self._key


class _ServingGraphs:
    """The CUDA graphs of one policy's forward, by request signature: at most :data:`MAX_GRAPHS` of
    them, all captured on the weights where :class:`_WeightStorage` found them, and all dropped once
    the weights moved (:meth:`stale`). A signature whose capture failed stays eager for good."""

    def __init__(self, policy: nn.Module):
        self.policy = policy
        self.graphs: dict = {}
        self.failed: set = set()
        self.weights: _WeightStorage | None = None

    def get(self, key):
        return self.graphs.get(key)

    def stale(self) -> bool:
        """Whether the weights moved since the graphs were captured; if so, every graph is dropped."""
        if self.weights is None or not self.weights.moved():
            return False
        self.graphs.clear()
        self.weights = None
        return True

    def admits(self, key) -> bool:
        """Whether a request of signature ``key``, which has no graph, should capture one."""
        return key is not None and key not in self.failed and len(self.graphs) < MAX_GRAPHS

    def add(self, key, graph) -> None:
        self.stale()  # graphs of weights that moved since are dropped before this one joins them
        if self.weights is None:
            self.weights = _WeightStorage(self.policy)
        self.graphs[key] = graph


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: dict  # the static obs tensors on the card the graph reads, by obs key
    actions: torch.Tensor  # the static clipped actions it writes

    def load(self, obs: dict) -> dict:
        """Copies a request's raw obs into the graph's input tensors, and returns them."""
        for k, static in self.inputs.items():
            static.copy_(_host(obs[k]))
        return self.inputs


class PolicyServer:
    """Maps raw numpy observations to numpy actions with ``policy`` on its own device.

    Each request is span ``serve.request`` (``utils/trace.py``; its ident is the count of requests
    served before it), with the children ``serve.h2d`` (the obs to the device), ``serve.forward``
    (the policy's launches) and ``serve.readback`` (the clip and the copy back, where the host
    waits for the device).

    On a CUDA device, :meth:`__call__` keeps one CUDA graph per request signature
    (:func:`_request_signature`; :data:`MAX_GRAPHS` of them, :class:`_ServingGraphs`). A signature's
    first request runs eagerly on the side stream the graph is captured on (the warm-up
    ``torch.cuda.graphs`` asks for), then its forward and clip are captured on a copy of that
    request's obs on the device, in span ``serve.capture`` inside ``serve.forward``. A later request
    copies its obs into that copy (``serve.h2d``), replays the graph (``serve.forward``) and copies the
    actions back (``serve.readback``). While the card runs a replay, the host checks that every
    parameter, buffer and submodule of the policy lies where it lay at the capture
    (:class:`_WeightStorage`); where one moved, the replay's answer is dropped with every graph,
    and the request is served as its signature's first. A signature whose capture fails (a
    forward that reads the device from the host) is served eagerly for good, with one warning.

    ``graph_captures``, ``graph_replays`` and ``eager_requests`` (every request served without a
    replay, :meth:`sample`'s too) count like ``requests``; ``capture_failures`` counts the failed
    captures. On the CPU every request is eager. The launch counters of ``kernels`` count where the
    wrappers launch: a signature's first request adds its eager forward and the capture's recorded
    launches, a replay adds nothing (``kernels.device_kernels`` reads a replay's kernels)."""

    def __init__(self, policy: ActorCritic, action_low=None, action_high=None):
        self.policy = policy.eval()
        self.device = policy.log_std.device
        self.requests = 0
        self.eager_requests = self.graph_captures = self.graph_replays = self.capture_failures = 0
        self.bounds = None
        if action_low is not None and action_high is not None:
            self.bounds = tuple(torch.as_tensor(b, dtype=torch.float32, device=self.device) for b in (action_low, action_high))
        self._graphs = _ServingGraphs(self.policy)
        self._stream = None  # the side stream graphs are captured on, made at the first capture

    def to_device(self, obs: dict) -> dict:
        """Raw obs arrays (or tensors) -> tensors on the policy's device, dtypes unchanged (uint8
        stays uint8)."""
        return _on(self.device, obs)

    def _clamped(self, actions: torch.Tensor) -> torch.Tensor:
        return actions if self.bounds is None else torch.clamp(actions, *self.bounds)

    def _clip(self, actions: torch.Tensor) -> np.ndarray:
        return self._clamped(actions).cpu().numpy()

    def _request(self):
        self.requests += 1
        return trace.span("serve.request", self.requests - 1)

    def __call__(self, obs: dict) -> np.ndarray:
        """Deterministic actions: the Gaussian mean, clipped to the bounds."""
        with self._request(), torch.inference_mode():
            key = _request_signature(obs, self.bounds is not None) if self.device.type == "cuda" else None
            graph = self._graphs.get(key)
            with trace.span("serve.h2d"):
                x = self.to_device(obs) if graph is None else graph.load(obs)
            with trace.span("serve.forward"):
                if graph is not None:
                    graph.graph.replay()
                    if self._graphs.stale():  # read while the card replays; a stale answer is not served
                        graph = None
                if graph is not None:
                    self.graph_replays += 1
                else:
                    self.eager_requests += 1
                    mean = self._forward_and_capture(key, x) if self._graphs.admits(key) else self.policy._dist_params(x)[0]
            with trace.span("serve.readback"):
                return self._clip(mean) if graph is None else graph.actions.cpu().numpy()

    def _forward_and_capture(self, key, x: dict) -> torch.Tensor:
        """The eager forward of a signature's first request on the capture stream, then the capture
        of the forward and the clip on a copy of ``x``, which becomes the graph's input tensors (``x``
        may hold the caller's own tensors, which later requests must not overwrite)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side, main = self._stream, torch.cuda.current_stream(self.device)
        inputs = {k: v.clone() for k, v in x.items()}
        side.wait_stream(main)
        with torch.cuda.stream(side):
            mean, _, _ = self.policy._dist_params(x)
        main.wait_stream(side)
        with trace.span("serve.capture"):
            self._capture(key, inputs, side)
        return mean

    def _capture(self, key, x: dict, side: torch.cuda.Stream) -> None:
        graph = torch.cuda.CUDAGraph()
        try:
            # the outer stream context restores the caller's stream should the capture's end raise
            with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
                actions = self._clamped(self.policy._dist_params(x)[0])
        except RuntimeError as err:  # the forward did something a graph cannot hold (a host read)
            self._graphs.failed.add(key)
            self.capture_failures += 1
            if self.capture_failures == 1:
                warnings.warn(f"PolicyServer: a CUDA graph capture failed, so this signature is served eagerly: {err}", RuntimeWarning)
            return
        self._graphs.add(key, _Graph(graph, x, actions))
        self.graph_captures += 1

    def sample(self, obs: dict, generator: torch.Generator) -> np.ndarray:
        """Stochastic actions drawn with ``generator`` (on the policy's device), clipped; always
        eager."""
        with self._request(), torch.inference_mode():
            self.eager_requests += 1
            with trace.span("serve.h2d"):
                x = self.to_device(obs)
            with trace.span("serve.forward"):
                actions, _, _ = self.policy.step(x, generator)
            with trace.span("serve.readback"):
                return self._clip(actions)


def _host(v):
    """A raw obs array as a contiguous host tensor (a tensor as it is)."""
    return torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)


def _on(device: torch.device, obs: dict) -> dict:
    """Raw obs arrays or tensors -> tensors on ``device``, dtypes unchanged."""
    return {k: _host(v).to(device) for k, v in obs.items()}


def _placed(module: nn.Module, device) -> tuple[nn.Module, torch.device]:
    """``module`` in eval mode on ``device`` (default: where its parameters are), as a copy if it
    lies elsewhere: the caller's module is not moved."""
    here = next(module.parameters()).device
    dev = here if device is None else torch.device(device)
    return (module if dev == here else copy.deepcopy(module).to(dev)).eval(), dev


def export_fn(fn: nn.Module, example_args: tuple) -> torch.export.ExportedProgram:
    """``torch.export.export`` of the module ``fn`` at the example arguments' signature: static
    shapes, one program per signature, on the device where the arguments and ``fn`` lie."""
    return torch.export.export(fn, tuple(example_args), strict=False)


class _ServedPolicy(nn.Module):
    """Raw obs (and, to sample, standard-normal noise) -> actions, clipped to the bounds: what
    :class:`PolicyServer` computes."""

    def __init__(self, policy: ActorCritic, bounds):
        super().__init__()
        self.policy = policy
        self.bounds = bounds is not None
        if self.bounds:
            self.register_buffer("low", bounds[0])
            self.register_buffer("high", bounds[1])

    def forward(self, obs: dict, noise: torch.Tensor | None = None) -> torch.Tensor:
        mean, log_std, _ = self.policy._dist_params(obs)
        actions = mean if noise is None else mean + torch.exp(log_std) * noise  # ActorCritic.step's sample
        return torch.clamp(actions, self.low, self.high) if self.bounds else actions


def export_policy(
    policy: ActorCritic,
    example_obs: dict,
    *,
    deterministic: bool = True,
    action_low=None,
    action_high=None,
    device: str | torch.device | None = None,
) -> torch.export.ExportedProgram:
    """Export an ActorCritic as an action server: raw obs (numpy or tensors, the shapes and dtypes
    of ``example_obs``) -> actions, with ``vt_load``, the features, the heads and the optional
    final clip inside the program and the weights baked in. ``deterministic`` serves the Gaussian
    mean; otherwise the program takes ``(obs, noise)``, ``noise`` standard normal (B, action_dim)
    f32, and returns mean + exp(log_std) * noise. Exported on ``device`` (default: the policy's)."""
    policy, dev = _placed(policy, device)
    bounds = None
    if action_low is not None and action_high is not None:
        bounds = tuple(torch.as_tensor(np.asarray(b), dtype=torch.float32, device=dev) for b in (action_low, action_high))
    obs = _on(dev, example_obs)
    args = (obs,)
    if not deterministic:
        batch = next(iter(obs.values())).shape[0]
        args = (obs, torch.zeros((batch, policy.action_dim), dtype=torch.float32, device=dev))
    return export_fn(_ServedPolicy(policy, bounds).eval(), args)


def export_encoder(features: nn.Module, example_obs: dict, device: str | torch.device | None = None) -> torch.export.ExportedProgram:
    """Export a feature extractor (MAEFeatures or any module mapping a raw obs dict to
    embeddings) as ``obs -> features``, on ``device`` (default: the module's)."""
    features, dev = _placed(features, device)
    return export_fn(features, (_on(dev, example_obs),))


def save_artifact(path: str, program: torch.export.ExportedProgram) -> None:
    """Write ``program`` to ``path`` (a ``.pt2`` file: the graph and its weights)."""
    torch.export.save(program, path)


def load_artifact(path: str, device: str | torch.device | None = None) -> torch.export.ExportedProgram:
    """Read a ``.pt2`` artifact, moved to ``device`` if given (its weights, and every device in
    its graph). Run it with ``.module()(*args)``. The ``m3l::`` operators its graph names are
    registered first."""
    from .nn import flash_attention  # noqa: F401  registers the m3l:: operators

    program = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, resolve_device(device))
    return program


def example_obs_for(env_like, batch: int = 1, frame_stack: int = 1) -> dict:
    """Zero-filled raw observations of an env's observation space (the port's ``envs/spaces.py``
    ``Dict`` of ``Box``es, frame stack included): the export signature helper, shapes and dtypes
    only. ``frame_stack`` is accepted for the JAX signature's sake; the space already holds it."""
    return {k: np.zeros((batch, *space.shape), dtype=space.dtype) for k, space in env_like.observation_space.spaces.items()}
