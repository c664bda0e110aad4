"""Adam over one flat f32 moment pair: :class:`FlatAdam`, the counterpart of
``m3l_tpu/train/optim.py`` ``flat_adam``; AdamW over flat f32 buffers: :class:`FlatAdamW`, the
counterpart of ``flat_adamw``, behind the SSL Trainer's chain (:class:`GradientChain`).

The same math as ``optax.chain(optax.clip_by_global_norm(c), optax.adam(lr, eps=...))``: the
gradients of all parameters are raveled into one f32 vector, clipped by their global norm
(``max(gnorm, 1e-12)`` in the denominator), and both moments stay flat. The bias correction
uses the post-increment count; a learning-rate schedule is read at the pre-increment count, as
optax's ``scale_by_learning_rate`` does. Adam is elementwise and the norm is a sum, so the
parameter order does not change the result: the port ravels in ``parameters()`` order. In the
JAX package this is plain XLA, not a Pallas kernel; here it is plain PyTorch.

Unlike the JAX version, which returns updates for donated parameters, :meth:`FlatAdam.step`
updates the parameters in place.

Under a mesh (``train/mesh.py``) every optimizer here takes the mesh: the dp reduction is one
all-reduce of the flat gradient, before the clip, with the replicated part then taken from the
mp group's first rank; the global norm under mp is the replicated parameters' sum of squares plus
the mp-group sum of the sharded parameters'. The moments stay local: elementwise over this rank's
shards, they are the single-process moments' shares. (JAX switches to leaf-wise optax under a mesh
because a raveled vector cannot carry shardings; the port's flat buffer of local shards carries
none either, so it keeps its flat optimizers.)

:class:`FlatAdamW` is ``flat_adamw``: the reference's weight-decay split (decay only parameters of
2 or more dimensions) as a flat 0/1 mask, and -lr (mu_hat / (sqrt(nu_hat) + eps) + wd mask p) for
the update, lr and wd scalars or schedules read at the pre-increment count. Its parameters live in
one flat f32 buffer (each parameter becomes a view of it), so the whole update is a few
elementwise passes over three vectors with no copy back.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from .mesh import Mesh, gather_flat, gather_like, reduce_flat_grad, shard_flat, shard_like, sharded_mask, sum_of_squares


class FlatAdam:
    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float | Callable[[int], float],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        max_grad_norm: float | None = None,
        mesh: Mesh | None = None,
    ):
        self.params = list(params)
        self.learning_rate, self.b1, self.b2, self.eps, self.max_grad_norm = learning_rate, b1, b2, eps, max_grad_norm
        self.mesh = mesh
        self._sharded = sharded_mask(self.params) if mesh is not None else None
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
        """One clipped Adam update from the parameters' gradients (under a mesh, their sum over
        the dp group), applied in place."""
        g = self.flat_grad()
        if self.mesh is not None:
            reduce_flat_grad(g, self.mesh, self._sharded)
        if self.max_grad_norm is not None:
            gnorm = torch.sqrt(sum_of_squares(g, self.mesh, self._sharded))
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
        """The step count and both flat moments (the JAX ``FlatAdamState``); under a mesh in the
        single-process layout, each parameter's moments gathered (collective)."""
        return {"count": self.count, "mu": gather_flat(self.mu, self.params, self.mesh), "nu": gather_flat(self.nu, self.params, self.mesh)}

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict` (single-process layout); the moments land on the
        parameters' device, whatever device they were saved from, and under a mesh each rank
        keeps its shares."""
        dev = self.mu.device
        moments = {}
        for k in ("mu", "nu"):
            full = d[k].to(dev, torch.float32)
            local = shard_flat(full, self.params, self.mesh)
            if tuple(local.shape) != tuple(self.mu.shape):
                raise ValueError(f"FlatAdam: saved {k} has {tuple(d[k].shape)} values, this optimizer {tuple(self.mu.shape)}")
            moments[k] = local.clone()
        self.count = int(d["count"])
        self.mu, self.nu = moments["mu"], moments["nu"]



def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class GradientChain:
    """What the SSL Trainer chains in front of an AdamW, over ``params``' gradients: ``clip_norms``
    applied in order, each as ``optax.clip_by_global_norm`` (g * max / |g| only where |g| > max,
    no epsilon); with ``every_k`` > 1, as ``optax.MultiSteps``, :meth:`step` averages k gradients
    (acc += (g - acc) / (n + 1)) and applies them on the k-th call, and only that call advances
    :attr:`count`, and so the schedules. A subclass applies the gradients in :meth:`_apply`.
    Under a mesh (:meth:`set_mesh`) each call's gradients are first summed over the dp group."""

    def __init__(self, params: Iterable[torch.nn.Parameter], clip_norms=(), every_k: int = 1):
        self.params = list(params)
        self.clip_norms, self.every_k = tuple(clip_norms), every_k
        self.count = 0
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None
        self.set_mesh(None)

    def set_mesh(self, mesh: Mesh | None) -> None:
        """Reduce every later step's gradients over ``mesh`` (the parameters already sharded)."""
        self.mesh = mesh
        self._sharded = sharded_mask(self.params) if mesh is not None else None

    def _grads(self) -> list[torch.Tensor]:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.mesh is None:
            return grads
        flat = reduce_flat_grad(torch.cat([g.reshape(-1) for g in grads]), self.mesh, self._sharded)
        return [t.view_as(p) for t, p in zip(torch.split(flat, [p.numel() for p in self.params]), self.params)]

    def _norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        if self.mesh is None:
            return _global_norm(grads)
        return torch.sqrt(sum_of_squares(torch.cat([g.reshape(-1) for g in grads]), self.mesh, self._sharded))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _apply(self, grads: list[torch.Tensor]) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self) -> bool:
        """One call per batch, from the parameters' gradients; returns whether it updated them."""
        grads = self._grads()
        if self.every_k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            self.acc = [a + (g - a) / (self.mini_step + 1) for a, g in zip(self.acc, grads)]
            if self.mini_step < self.every_k - 1:
                self.mini_step += 1
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        for max_norm in self.clip_norms:
            norm = self._norm(grads)
            grads = [torch.where(norm < max_norm, g, (g / norm) * max_norm) for g in grads]
        self._apply(grads)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        """The counts and the accumulated gradients, in the single-process layout (collective
        under a mesh)."""
        acc = None if self.acc is None else [gather_like(a, p, self.mesh) for a, p in zip(self.acc, self.params)]
        return {"count": self.count, "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, d: dict) -> None:
        self.count, self.mini_step = int(d["count"]), int(d["mini_step"])
        self.acc = None if d["acc"] is None else [shard_like(a.to(p.device), p, self.mesh) for a, p in zip(d["acc"], self.params)]


class FlatAdamW(GradientChain):
    """AdamW over one flat f32 buffer each for the parameters, the first and the second moment,
    with a flat 0/1 decay mask (1 on parameters of 2 or more dimensions). ``learning_rate`` and
    ``weight_decay`` are scalars or schedules of the step count. Every parameter must be f32; each
    becomes a view of :attr:`flat`, so build the optimizer after the module is on its device."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        learning_rate: float | Callable[[int], float],
        weight_decay: float | Callable[[int], float],
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        clip_norms=(),
        every_k: int = 1,
    ):
        super().__init__(params, clip_norms, every_k)
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("FlatAdamW: every parameter must be float32")
        self.learning_rate, self.weight_decay, (self.b1, self.b2), self.eps = learning_rate, weight_decay, betas, eps
        dev = self.params[0].device
        self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        self.mask = torch.cat([torch.full((p.numel(),), float(p.dim() >= 2), device=dev) for p in self.params])
        offset = 0
        for p in self.params:
            p.data = self.flat[offset : offset + p.numel()].view_as(p)
            offset += p.numel()
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)

    def _apply(self, grads: list[torch.Tensor]) -> None:
        g = torch.cat([x.reshape(-1) for x in grads])
        t = self.count + 1
        self.mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        self.nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        mu_hat = self.mu / (1.0 - self.b1**t)
        nu_hat = self.nu / (1.0 - self.b2**t)
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        wd = self.weight_decay(self.count) if callable(self.weight_decay) else self.weight_decay
        self.flat.add_(-lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps) + wd * self.mask * self.flat))

    def state_dict(self) -> dict:
        """The chain's state and both flat moments (the JAX ``FlatAdamWState`` but the mask, which
        the parameters' shapes give)."""
        return {**super().state_dict(), "mu": gather_flat(self.mu, self.params, self.mesh), "nu": gather_flat(self.nu, self.params, self.mesh)}

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict`; the moments land on the parameters' device (under a mesh,
        this rank's shares)."""
        local = {k: shard_flat(d[k].to(self.mu.device), self.params, self.mesh) for k in ("mu", "nu")}
        for k, v in local.items():
            if tuple(v.shape) != tuple(self.mu.shape):
                raise ValueError(f"FlatAdamW: saved {k} has {tuple(d[k].shape)} values, this optimizer {tuple(self.mu.shape)}")
        super().load_state_dict(d)
        self.mu.copy_(local["mu"])
        self.nu.copy_(local["nu"])
