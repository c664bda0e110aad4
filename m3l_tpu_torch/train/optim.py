"""Adam over one flat f32 moment pair: :class:`FlatAdam`, the counterpart of
``m3l_tpu/train/optim.py`` ``flat_adam``.

The same math as ``optax.chain(optax.clip_by_global_norm(c), optax.adam(lr, eps=...))``: the
gradients of all parameters are raveled into one f32 vector, clipped by their global norm
(``max(gnorm, 1e-12)`` in the denominator), and both moments stay flat. The bias correction
uses the post-increment count; a learning-rate schedule is read at the pre-increment count, as
optax's ``scale_by_learning_rate`` does. Adam is elementwise and the norm is a sum, so the
parameter order does not change the result: the port ravels in ``parameters()`` order. In the
JAX package this is plain XLA, not a Pallas kernel; here it is plain PyTorch.

Unlike the JAX version, which returns updates for donated parameters, :meth:`FlatAdam.step`
updates the parameters in place.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


class FlatAdam:
    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float | Callable[[int], float],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        max_grad_norm: float | None = None,
    ):
        self.params = list(params)
        self.learning_rate, self.b1, self.b2, self.eps, self.max_grad_norm = learning_rate, b1, b2, eps, max_grad_norm
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.count = 0
        self.mu = torch.zeros(n, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(n, dtype=torch.float32, device=dev)

    def flat_grad(self) -> torch.Tensor:
        """All gradients raveled into one f32 vector; a parameter without a gradient counts zeros
        (JAX differentiates every parameter, unused ones to zero)."""
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float() for p in self.params])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One clipped Adam update from the parameters' gradients, applied in place."""
        g = self.flat_grad()
        if self.max_grad_norm is not None:
            gnorm = torch.sqrt(torch.sum(torch.square(g)))
            g = g * torch.clamp(self.max_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        self.count += 1
        b1, b2 = self.b1, self.b2
        self.mu = b1 * self.mu + (1.0 - b1) * g
        self.nu = b2 * self.nu + (1.0 - b2) * torch.square(g)
        mu_hat = self.mu / (1.0 - b1**self.count)
        nu_hat = self.nu / (1.0 - b2**self.count)
        update = -lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        offset = 0
        for p in self.params:
            p.add_(update[offset : offset + p.numel()].view_as(p))
            offset += p.numel()

    def state_dict(self) -> dict:
        """The step count and both flat moments (the JAX ``FlatAdamState``)."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict`; the moments land on the parameters' device, whatever
        device they were saved from."""
        dev = self.mu.device
        for k in ("mu", "nu"):
            if tuple(d[k].shape) != tuple(self.mu.shape):
                raise ValueError(f"FlatAdam: saved {k} has {tuple(d[k].shape)} values, this optimizer {tuple(self.mu.shape)}")
        self.count = int(d["count"])
        self.mu = d["mu"].to(dev, torch.float32, copy=True)
        self.nu = d["nu"].to(dev, torch.float32, copy=True)

