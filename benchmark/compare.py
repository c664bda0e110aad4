"""The numbers that decide ``correct``, each computed from a program's reading and the plain
reference's. Every number is a gap relative to the reference, so a limit is a share."""
from __future__ import annotations

import statistics

import torch


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The widest |program - reference| / |reference| over the steps' losses."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(program, reference))


def leaf_norm_gap(program: dict[str, torch.Tensor], reference: dict[str, torch.Tensor], leaves: list[str] | None = None) -> tuple[float, str]:
    """The worst leaf's |‖program‖ - ‖reference‖| over the larger of that leaf's reference norm
    and the median leaf's, and the leaf's name. ``leaves``: those compared (all by default)."""
    names = leaves if leaves is not None else list(reference)
    ref = {k: float(reference[k].double().norm()) for k in names}
    prog = {k: float(program[k].double().norm()) for k in names}
    median = statistics.median(ref.values())
    worst = max(names, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], median, 1e-30), worst


def moved_leaves(first_grad: dict[str, torch.Tensor], share: float = 1e-3) -> list[str]:
    """Leaves whose first reference gradient is at least ``share`` of the median leaf's: the others
    move under Adam by round-off alone (a key bias under softmax, a parameter the loss never
    reads), so their change is left out of the comparison."""
    norms = {k: float(g.double().norm()) for k, g in first_grad.items()}
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= share * median]


def change(after: dict[str, torch.Tensor], before: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: after[k].float() - before[k].float() for k in after}


def split_flat(flat: torch.Tensor, shapes: dict[str, tuple[int, ...]]) -> dict[str, torch.Tensor]:
    """A flat vector cut into named pieces of the given shapes, in order."""
    out, offset = {}, 0
    for name, shape in shapes.items():
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[offset : offset + n].reshape(shape)
        offset += n
    return out
