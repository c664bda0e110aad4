"""Per-layer attention benchmark on the card: einsum vs flash v1 (split heads through device
memory) vs flash v2 (packed qkv, heads split inside the kernel).

Counterpart of ``scripts/bench_attention.py``. Times one full attention layer (qkv projection,
attention, output projection), forward and backward, at the flagship shape B=512, N=192, D=256,
H=4: x (bf16) @ wqkv -> attention -> @ wout, loss sum(float(o @ wout) ** 2), the f32 weights
cast to bf16. One call runs ``INNER`` steps of ``p += 1e-9 * grad``; after one warm-up call, one
call is timed with CUDA events and reported per step. The ``einsum`` variant is plain PyTorch,
a yardstick written as the JAX one (a bf16 QK^T cast to f32 after the product), not a kernel.

    python -m m3l_tpu_torch.bench_attention [v2|v1|einsum ...]
"""
from __future__ import annotations

import sys
from collections import Counter

import numpy as np
import torch

from .kernels import LAUNCHES
from .nn.flash_attention import flash_attention, flash_attention_qkv
from .utils.device import resolve_device

B, N, D, H = 512, 192, 256, 4
INNER = 10


def make_inputs(b: int = B, n: int = N, d: int = D, device: str | torch.device | None = None, seed: int = 0):
    """((wqkv, wout) f32, x bf16) from a numpy seed, as the JAX script draws them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, n, d))).to(dev, torch.bfloat16)
    wqkv = torch.from_numpy(rng.normal(size=(d, 3 * d)) * 0.02).to(dev, torch.float32)
    wout = torch.from_numpy(rng.normal(size=(d, d)) * 0.02).to(dev, torch.float32)
    return (wqkv, wout), x


def _loss(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return ((o @ wo.to(o.dtype)).float() ** 2).sum()


def _split(p, x, heads):
    wq, wo = p
    b, n, d = x.shape
    qkv = (x @ wq.to(x.dtype)).reshape(b, n, 3, heads, d // heads)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], wo


def loss_einsum(p, x: torch.Tensor, heads: int = H) -> torch.Tensor:
    q, k, v, wo = _split(p, x, heads)
    b, n, d = x.shape
    s = torch.einsum("bnhd,bmhd->bhnm", q, k).float() * (d // heads) ** -0.5
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return _loss(torch.einsum("bhnm,bmhd->bnhd", a, v).reshape(b, n, d), wo)


def loss_v1(p, x: torch.Tensor, heads: int = H) -> torch.Tensor:
    q, k, v, wo = _split(p, x, heads)
    b, n, d = x.shape
    return _loss(flash_attention(q, k, v, scale=(d // heads) ** -0.5).reshape(b, n, d), wo)


def loss_v2(p, x: torch.Tensor, heads: int = H) -> torch.Tensor:
    wq, wo = p
    d = x.shape[-1]
    return _loss(flash_attention_qkv(x @ wq.to(x.dtype), heads, scale=(d // heads) ** -0.5), wo)


VARIANTS = {"v2": loss_v2, "v1": loss_v1, "einsum": loss_einsum}


def loss_and_grads(variant: str, params, x: torch.Tensor, heads: int = H):
    """The layer's loss and its gradients with respect to (wqkv, wout)."""
    p = [t.detach().requires_grad_(True) for t in params]
    loss = VARIANTS[variant](p, x, heads)
    return loss.detach(), torch.autograd.grad(loss, p)


def train_steps(variant: str, params, x: torch.Tensor, heads: int = H, inner: int = INNER) -> None:
    """``inner`` steps of ``p += 1e-9 * grad`` on the f32 ``params``, in place."""
    for _ in range(inner):
        _, grads = loss_and_grads(variant, params, x, heads)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.add_(g, alpha=1e-9)


def time_variant(variant: str, params, x: torch.Tensor, heads: int = H, inner: int = INNER) -> tuple[float, Counter]:
    """ms per step of one timed call of :func:`train_steps` after one warm-up call (CUDA events),
    and the kernel launches of the timed call."""
    if x.device.type != "cuda":
        raise RuntimeError("bench_attention: timing needs tensors on a CUDA device")
    train_steps(variant, params, x, heads, inner)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    before = Counter(LAUNCHES)
    start.record()
    train_steps(variant, params, x, heads, inner)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / inner, Counter(LAUNCHES) - before


def main(argv: list[str] | None = None) -> dict[str, float]:
    args = sys.argv[1:] if argv is None else argv
    pick = [a for a in args if a in VARIANTS] or list(VARIANTS)
    params, x = make_inputs()
    out = {}
    for name in pick:
        out[name], _ = time_variant(name, [p.clone() for p in params], x)
        print(f"{name + ' layer fwd+bwd':50s} {out[name]:8.3f} ms")
    return out


if __name__ == "__main__":
    main()
