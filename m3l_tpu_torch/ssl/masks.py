"""Vectorized, static-shape mask samplers (counterpart of ``m3l_tpu/ssl/masks.py``).

Masks are boolean (M, B, N) keep-arrays under the JAX package's distribution family:

* block area ~ U(scale_min, scale_max), one block size per call, shared across the batch;
* block top-left corners uniform per (mask, sample);
* global masks optionally constrained to the complement of the local masks, falling back to the
  unconstrained block for a sample whose constrained block keeps ``min_keep`` patches or fewer;
* tube masks: a spatial keep-set of static size extruded through time;
* V-JEPA's multi-block 3-D masks (:class:`MultiBlock3D`): blocks of one size a batch, placed per
  clip, the context the tokens outside every block and the targets those inside, each index list
  cut to the batch's smallest count. They are drawn on the CPU (as the published collator does),
  so their lengths are known on the host without waiting for the card; the uniforms come from a
  torch generator and the rest is single-threaded numpy, a few milliseconds a batch.

Every draw comes from a ``torch.Generator`` on the target device (the multi-block masks': on the
CPU). The samplers draw their uniforms and hand them to helpers that take the uniforms as tensors
(``block_masks_from_uniforms``, ``tube_masks_from_noise``, ``multiblock_masks_from_uniforms``), so
a test can feed in the uniforms JAX (or a reference) drew and require equal masks. Consumers of the
keep-arrays run the encoder at full length with attention key-masking; those of index lists gather.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


def _block_mask(top: torch.Tensor, left: torch.Tensor, h: torch.Tensor, w: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """(..., grid_h*grid_w) bool block mask from corner and size tensors."""
    rows = torch.arange(grid_h, device=top.device)
    cols = torch.arange(grid_w, device=top.device)
    rmask = (rows >= top[..., None]) & (rows < (top + h)[..., None])
    cmask = (cols >= left[..., None]) & (cols < (left + w)[..., None])
    return (rmask[..., :, None] & cmask[..., None, :]).reshape(*top.shape, grid_h * grid_w)


def _sample_size(u: torch.Tensor, grid_h: int, grid_w: int, scale: tuple[float, float]) -> tuple[torch.Tensor, torch.Tensor]:
    """One (h, w) per call from the scalar uniform ``u``, in f32 as JAX computes it."""
    u = u.to(torch.float32)
    area = scale[0] + u * (scale[1] - scale[0])
    max_keep = grid_h * grid_w * area
    side = torch.round(torch.sqrt(max_keep)).to(torch.int32)  # round half to even, as jnp.round
    return side.clamp(1, grid_h), side.clamp(1, grid_w)


def block_masks_from_uniforms(
    u_size: torch.Tensor, u_top: torch.Tensor, u_left: torch.Tensor, grid_hw: tuple[int, int], scale: tuple[float, float]
) -> torch.Tensor:
    """(M, B, grid_h*grid_w) bool keep-masks from a scalar size uniform and (M, B) corner uniforms."""
    gh, gw = grid_hw
    h, w = _sample_size(u_size, gh, gw, scale)
    top = torch.floor(u_top.float() * (gh - h + 1).float()).to(torch.int32)
    left = torch.floor(u_left.float() * (gw - w + 1).float()).to(torch.int32)
    return _block_mask(top, left, h, w, gh, gw)


def _device(generator: Optional[torch.Generator], device):
    """``device``, else the generator's (the CPU without either)."""
    if device is not None:
        return device
    return generator.device if generator is not None else "cpu"


def sample_block_masks(
    generator: Optional[torch.Generator], batch: int, grid_hw: tuple[int, int], scale: tuple[float, float], n_masks: int, device=None
) -> torch.Tensor:
    """(n_masks, batch, grid_h*grid_w) bool keep-masks drawn from ``generator`` on ``device``
    (the generator's device when not given)."""
    device = _device(generator, device)
    u_size = torch.rand((), generator=generator, device=device)
    u_top = torch.rand((n_masks, batch), generator=generator, device=device)
    u_left = torch.rand((n_masks, batch), generator=generator, device=device)
    return block_masks_from_uniforms(u_size, u_top, u_left, grid_hw, scale)


def constrain(raw: torch.Tensor, forbidden: torch.Tensor, min_keep: int) -> torch.Tensor:
    """``raw`` (M, B, N) masks minus ``forbidden`` (B, N) where more than ``min_keep`` patches
    remain; else the raw block for that (mask, sample)."""
    constrained = raw & ~forbidden[None]
    ok = constrained.sum(-1) > min_keep
    return torch.where(ok[..., None], constrained, raw)


def sample_block_masks_constrained(
    generator: Optional[torch.Generator],
    batch: int,
    grid_hw: tuple[int, int],
    scale: tuple[float, float],
    n_masks: int,
    forbidden: torch.Tensor,
    min_keep: int,
) -> torch.Tensor:
    """Global masks constrained away from ``forbidden`` (B, N) bool, True where a mask may NOT keep
    (the union of the local masks), drawn on ``forbidden``'s device."""
    raw = sample_block_masks(generator, batch, grid_hw, scale, n_masks, device=forbidden.device)
    return constrain(raw, forbidden, min_keep)


def tube_masks_from_noise(noise: torch.Tensor, frames: int, ratio: float) -> torch.Tensor:
    """(M, B, T*H*W) bool keep-masks from spatial noise (M, B, H*W): the round(H*W*(1-ratio))
    patches (at least one) of smallest noise in each frame, the same in every frame."""
    n_spatial = noise.shape[-1]
    keep = max(int(round(n_spatial * (1.0 - ratio))), 1)
    ranks = torch.argsort(torch.argsort(noise, dim=-1, stable=True), dim=-1, stable=True)
    return (ranks < keep).repeat(1, 1, frames)


def random_tube_masks(
    generator: Optional[torch.Generator], batch: int, grid_thw: tuple[int, int, int], ratio: float, n_masks: int, device=None
) -> torch.Tensor:
    """V-JEPA-style tube masks (n_masks, batch, T*H*W) bool with a static keep count per frame."""
    t, h, w = grid_thw
    noise = torch.rand((n_masks, batch, h * w), generator=generator, device=_device(generator, device))
    return tube_masks_from_noise(noise, t, ratio)


# ---------------------------------------------------------------------- #
# V-JEPA's multi-block 3-D masks (src/masks/multiblock3d.py)
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class MultiBlock3D:
    """One mask generator of V-JEPA's multi-block 3-D masks: ``num_blocks`` blocks a clip, all of
    one size a batch, drawn from its ``spatial_scale``, ``aspect_ratio`` and ``temporal_scale``
    ranges. The targets are the tokens inside any block; the context is every other token."""

    num_blocks: int
    spatial_scale: Sequence[float]
    aspect_ratio: Sequence[float] = (0.3, 3.0)
    temporal_scale: Sequence[float] = (1.0, 1.0)


class MultiBlockDraw(NamedTuple):
    """One generator's masks for a batch: the index lists, ascending over the flattened (t, h, w)
    order and cut to the batch's smallest count, the clips drawn again for an empty context, and
    the uniforms they came from (``size`` (3,); ``start``, ``top``, ``left`` (R, B, num_blocks))."""

    context: torch.Tensor  # (B, Kc) int64
    target: torch.Tensor  # (B, Kt) int64
    redraws: int
    uniforms: dict


MAX_MASK_ROUNDS = 1000  # draws of a clip before a generator whose blocks always cover the grid is refused


def multiblock_size(u_size: torch.Tensor, grid_thw: tuple[int, int, int], spec: MultiBlock3D) -> tuple[int, int, int]:
    """The batch's block size (t, h, w) from three uniforms (temporal, spatial, aspect ratio), in
    Python floats as the published sampler computes it: t = max(1, int(T' tau)); keep =
    int(H' W' s); h = min(round(sqrt(keep ar)), H'), w = min(round(sqrt(keep / ar)), W')."""
    t_, h_, w_ = grid_thw
    ut, us, ua = (float(u) for u in u_size)
    tau = spec.temporal_scale[0] + ut * (spec.temporal_scale[1] - spec.temporal_scale[0])
    scale = spec.spatial_scale[0] + us * (spec.spatial_scale[1] - spec.spatial_scale[0])
    ar = spec.aspect_ratio[0] + ua * (spec.aspect_ratio[1] - spec.aspect_ratio[0])
    keep = int(h_ * w_ * scale)
    return max(1, int(t_ * tau)), min(int(round(math.sqrt(keep * ar))), h_), min(int(round(math.sqrt(keep / ar))), w_)


def _multiblock_targets(u_start, u_top, u_left, grid_thw, size) -> np.ndarray:
    """(R, B, T'*H'*W') bool: the union of each round's blocks for each clip. A block starts at
    floor(u * room) in float64 on each axis and is the outer product of its three intervals."""
    (t_, h_, w_), (t, h, w) = grid_thw, size

    def inside(u, extent, length):
        first = np.floor(np.asarray(u, dtype=np.float64) * (length - extent + 1)).astype(np.int64)
        ax = np.arange(length)
        return (ax >= first[..., None]) & (ax < first[..., None] + extent)

    blocks = (inside(u_start, t, t_)[..., :, None, None] & inside(u_top, h, h_)[..., None, :, None]
              & inside(u_left, w, w_)[..., None, None, :])  # (R, B, n, T', H', W')
    return blocks.any(axis=2).reshape(*blocks.shape[:2], -1)


def _ascending(mask: np.ndarray) -> torch.Tensor:
    """(B, N) bool -> (B, K) int64, K the smallest row count: each row's first K True positions in
    ascending order (``nonzero`` lists them row by row)."""
    count = int(mask.sum(axis=-1).min())
    kept = mask & (np.cumsum(mask, axis=-1) <= count)
    return torch.from_numpy(np.nonzero(kept)[1].reshape(mask.shape[0], count))


def _first_rounds(u_size, rounds: torch.Tensor, targets: np.ndarray) -> MultiBlockDraw:
    """The draw from ``rounds`` (3, R, B, n) of uniforms and their ``targets`` (R, B, N): each clip
    takes its first round that leaves it a context."""
    full = targets.all(axis=-1)  # (R, B): no context left
    if full.all(axis=0).any():
        raise ValueError("multi-block masks: a clip's context is empty in every round drawn")
    first = np.argmax(~full, axis=0)
    target = targets[first, np.arange(targets.shape[1])]
    uniforms = {"size": u_size, "start": rounds[0], "top": rounds[1], "left": rounds[2]}
    return MultiBlockDraw(_ascending(~target), _ascending(target), int(first.sum()), uniforms)


def multiblock_masks_from_uniforms(u_size, u_start, u_top, u_left, grid_thw: tuple[int, int, int], spec: MultiBlock3D) -> MultiBlockDraw:
    """One generator's masks from its uniforms: ``u_size`` (3,) sets the batch's block size
    (:func:`multiblock_size`); ``u_start``, ``u_top``, ``u_left`` (R, B, num_blocks) place each
    clip's blocks, round r standing for a clip only where every earlier round left its context
    empty. A block starts at floor(u * (T' - t + 1)) in time, its top and left likewise."""
    size = multiblock_size(u_size, grid_thw, spec)
    return _first_rounds(u_size, torch.stack([u_start, u_top, u_left]), _multiblock_targets(u_start, u_top, u_left, grid_thw, size))


def sample_multiblock_masks(generator: Optional[torch.Generator], batch: int, grid_thw: tuple[int, int, int], spec: MultiBlock3D) -> MultiBlockDraw:
    """One generator's masks for ``batch`` clips, drawn on the CPU from ``generator`` (a CPU
    generator, or torch's default one): the size's uniforms, then rounds of the blocks' uniforms
    until every clip has a context in some round."""
    u_size = torch.rand(3, generator=generator)
    size = multiblock_size(u_size, grid_thw, spec)
    rounds, targets = [], []
    while len(rounds) < MAX_MASK_ROUNDS:
        rounds.append(torch.rand((3, 1, batch, spec.num_blocks), generator=generator))
        targets.append(_multiblock_targets(*rounds[-1].numpy(), grid_thw, size))
        if not np.concatenate(targets).all(axis=-1).all(axis=0).any():
            return _first_rounds(u_size, torch.cat(rounds, dim=1), np.concatenate(targets))
    raise ValueError(f"multi-block masks: blocks of size {size} leave no context on the grid {grid_thw}")
