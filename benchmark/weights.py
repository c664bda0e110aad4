"""Seeded inputs of a run: weights made on the device in one draw, and the seeds of each stream.

The program's parameters are overwritten with these before a run starts, and the reference is
handed the same values, so neither takes weights from the other. The scales follow the shape of
each parameter, not its module: a matrix or kernel (a linear layer with one output too) gets
1/sqrt(fan-in), a vector named as a gain (``weight``, ``gamma``, ``last_g``) 1 + 0.1 z, any other
vector (biases, tokens, a log std) 0.02 z.
"""
from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """A seed for one stream of a run (weights 1, inputs 2, ...), from any whole ``seed``."""
    return (seed * 1_000_003 + stream * 7_919) & _MASK


def _scale_and_shift(name: str, shape: tuple[int, ...]) -> tuple[float, float]:
    core = list(shape)
    while len(core) > 2 and core[0] == 1:  # a table kept with leading unit axes: (1, N, D) is (N, D)
        core.pop(0)
    if len(core) == 2 and core[0] == 1 and not name.endswith("weight"):  # (1, D): one token, a vector
        core.pop(0)
    if len(core) >= 2:
        return 1.0 / math.sqrt(math.prod(core[1:])), 0.0
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "gamma", "last_g"):
        return 0.1, 1.0
    return 0.02, 0.0


def make_weights(shapes: dict[str, tuple[int, ...]], seed: int, device, stream: int = 1) -> dict[str, torch.Tensor]:
    """float32 values for every named shape, from one normal draw on ``device`` (the weights'
    stream by default)."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        scale, shift = _scale_and_shift(name, tuple(shape))
        out[name] = (z[offset : offset + n] * scale + shift).reshape(shape)
        offset += n
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the module's parameters of the same names."""
    params = dict(module.named_parameters())
    for name, value in weights.items():
        params[name].copy_(value)


def parameter_shapes(module: torch.nn.Module, skip: tuple[str, ...] = ()) -> dict[str, tuple[int, ...]]:
    """Names and shapes of a module's parameters in ``named_parameters`` order, without those
    whose name starts with one of ``skip``."""
    return {n: tuple(p.shape) for n, p in module.named_parameters() if not n.startswith(skip)}
