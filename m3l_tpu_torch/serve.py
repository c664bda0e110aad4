"""Serving: the flagship PPO+MAE policy as an in-process action server on the card, and as a
``torch.export`` artifact.

Counterpart of ``m3l_tpu/serve.py``: raw environment observations (uint8 image (B, fs, H, W, 3),
float tactile (B, fs, 6, h, w)) go in, actions come out. ``vt_load`` packing, feature extraction
and the policy heads all run on the device; the image crosses to the device as uint8. The
deterministic path serves the Gaussian mean; optional action bounds clip the result
(``PPOMAE.predict`` parity, ``m3l_tpu/rl/ppo_mae.py:436-442``).

* :class:`PolicyServer` runs the policy module in process; its stochastic path samples from a
  caller's ``torch.Generator``.
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


class PolicyServer:
    """Maps raw numpy observations to numpy actions with ``policy`` on its own device.

    Each request is span ``serve.request`` (``utils/trace.py``; its ident is the count of requests
    served before it), with the children ``serve.h2d`` (the obs to the device), ``serve.forward``
    (the policy's launches) and ``serve.readback`` (the clip and the copy back, where the host
    waits for the device)."""

    def __init__(self, policy: ActorCritic, action_low=None, action_high=None):
        self.policy = policy.eval()
        self.device = policy.log_std.device
        self.requests = 0
        self.bounds = None
        if action_low is not None and action_high is not None:
            self.bounds = tuple(torch.as_tensor(b, dtype=torch.float32, device=self.device) for b in (action_low, action_high))

    def to_device(self, obs: dict) -> dict:
        """Raw obs arrays (or tensors) -> tensors on the policy's device, dtypes unchanged (uint8
        stays uint8)."""
        return _on(self.device, obs)

    def _clip(self, actions: torch.Tensor) -> np.ndarray:
        if self.bounds is not None:
            actions = torch.clamp(actions, *self.bounds)
        return actions.cpu().numpy()

    def _request(self):
        self.requests += 1
        return trace.span("serve.request", self.requests - 1)

    def __call__(self, obs: dict) -> np.ndarray:
        """Deterministic actions: the Gaussian mean, clipped to the bounds."""
        with self._request(), torch.inference_mode():
            with trace.span("serve.h2d"):
                x = self.to_device(obs)
            with trace.span("serve.forward"):
                mean, _, _ = self.policy._dist_params(x)
            with trace.span("serve.readback"):
                return self._clip(mean)

    def sample(self, obs: dict, generator: torch.Generator) -> np.ndarray:
        """Stochastic actions drawn with ``generator`` (on the policy's device), clipped."""
        with self._request(), torch.inference_mode():
            with trace.span("serve.h2d"):
                x = self.to_device(obs)
            with trace.span("serve.forward"):
                actions, _, _ = self.policy.step(x, generator)
            with trace.span("serve.readback"):
                return self._clip(actions)


def _on(device: torch.device, obs: dict) -> dict:
    """Raw obs arrays or tensors -> tensors on ``device``, dtypes unchanged."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v).to(device) for k, v in obs.items()}


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
