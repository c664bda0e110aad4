"""Self-distillation losses (DINO, iBOT, KoLeo) as functions (counterpart of
``m3l_tpu/ssl/losses.py``).

The center is an explicit tensor, (1, K) for CLS outputs or (1, 1, K) for patch tokens, which the
caller keeps (a module buffer) and replaces with :func:`update_center`'s result. Every sum here is
over the batch it is given. A JAX mesh run takes them over the global batch (GSPMD, no
``axis_name``); on the port's mesh (``train/mesh.py``) each rank holds only its rows, so the center,
the Sinkhorn-Knopp sums, KoLeo's nearest neighbours and iBOT's masked counts would each need a
global reduction (KoLeo a differentiable gather). Those are not written yet: the modules that use
these losses refuse a mesh (``SSLModule.use_mesh``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def softmax_center_teacher(center: torch.Tensor, teacher_output: torch.Tensor, teacher_temp) -> torch.Tensor:
    """Centered and sharpened teacher distribution: softmax((t - center) / temp) over the last axis."""
    t = teacher_output.float()
    return torch.softmax((t - center.reshape((1,) * (t.dim() - 1) + (-1,))) / teacher_temp, dim=-1)


def update_center(center: torch.Tensor, teacher_output: torch.Tensor, momentum: float = 0.9) -> torch.Tensor:
    """The EMA of the center toward the batch center. For patch tokens (B, N, K) the batch center
    is the mean over tokens, then the mean over the batch."""
    t = teacher_output.float()
    batch_sum = torch.sum(t.mean(dim=1) if t.dim() == 3 else t, dim=0, keepdim=True)
    batch_center = (batch_sum / t.shape[0]).reshape(center.shape)
    return center * momentum + batch_center * (1.0 - momentum)


def sinkhorn_knopp_teacher(
    teacher_output: torch.Tensor,
    teacher_temp,
    n_iterations: int = 3,
    n_samples: Optional[torch.Tensor] = None,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sinkhorn-Knopp assignment of (B, K) teacher logits. ``n_samples`` overrides the sample
    count (iBOT passes the number of kept patches); ``sample_mask`` (B,) bool leaves rows out of
    the transport problem (their columns are zeroed before normalisation)."""
    t = teacher_output.float()
    q = torch.exp(t / teacher_temp).T  # (K, B)
    if sample_mask is not None:
        q = q * sample_mask.float()[None, :]
    b_total = torch.as_tensor(q.shape[1] if n_samples is None else n_samples, dtype=torch.float32, device=q.device)
    k = q.shape[0]
    q = q / torch.sum(q)
    for _ in range(n_iterations):
        q = q / torch.sum(q, dim=1, keepdim=True) / k
        # the clip guards the all-zero columns of masked-out samples (0 / eps = 0)
        q = q / torch.clamp(torch.sum(q, dim=0, keepdim=True), min=1e-30) / b_total
    return (q * b_total).T


def dino_cross_entropy(student_outputs: Sequence[torch.Tensor], teacher_probs: Sequence[torch.Tensor], student_temp: float = 0.1) -> torch.Tensor:
    """Sum over (student view, teacher view) pairs of -mean(sum(t * log_softmax(s / temp)))."""
    total = torch.zeros((), dtype=torch.float32, device=student_outputs[0].device)
    for s in student_outputs:
        lsm = torch.log_softmax(s.float() / student_temp, dim=-1)
        for t in teacher_probs:
            total = total - torch.mean(torch.sum(t * lsm, dim=-1))
    return total


def ibot_patch_loss(
    student_patch_logits: torch.Tensor, teacher_patch_probs: torch.Tensor, student_masks: torch.Tensor, student_temp: float = 0.1
) -> torch.Tensor:
    """Masked patch-level distillation over (B, N, K) logits and probabilities, ``student_masks``
    (B, N) bool True at the predicted patches, each sample weighted by 1 / its masked count."""
    lsm = torch.log_softmax(student_patch_logits.float() / student_temp, dim=-1)
    per_patch = torch.sum(teacher_patch_probs * lsm, dim=-1)  # (B, N)
    weight = 1.0 / torch.clamp(student_masks.sum(-1, keepdim=True).float(), min=1.0)
    masked = per_patch * student_masks.float() * weight
    return -torch.sum(masked) / student_masks.shape[0]


def ibot_patch_loss_all_pairs(
    student_patch_logits: torch.Tensor, teacher_patch_probs: torch.Tensor, keep_masks: torch.Tensor, student_temp: float = 0.1
) -> torch.Tensor:
    """All-pairs patch distillation: for every (student view i, teacher view j) of the (M, B, N, K)
    inputs, the mean of sum(t_j * log_softmax(s_i / temp)) over the tokens that view j keeps
    (``keep_masks`` (M, B, N) bool), negated and summed over the M^2 pairs. Every position is
    computed (key-masked forward) and weighted, with no gather, so the shapes stay static."""
    m = student_patch_logits.shape[0]
    lsm = torch.log_softmax(student_patch_logits.float() / student_temp, dim=-1)
    t = teacher_patch_probs.float()
    total = torch.zeros((), dtype=torch.float32, device=lsm.device)
    for i in range(m):
        for j in range(m):
            per_tok = torch.sum(t[j] * lsm[i], dim=-1)  # (B, N)
            w = keep_masks[j].float()
            total = total - torch.sum(per_tok * w) / torch.clamp(w.sum(), min=1.0)
    return total


def koleo_loss(student_output: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Kozachenko-Leonenko entropic regulariser: -mean(log distance to the nearest neighbour) over
    L2-normalised rows. The eps sits inside both square roots, so an all-zero row and two equal
    rows still give finite gradients."""
    x = student_output.float()
    x = x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)
    dots = x @ x.T
    n = x.shape[0]
    dots = dots - 2.0 * torch.eye(n, device=x.device)  # exclude self
    nn_idx = torch.argmax(dots, dim=1)
    d = x - x[nn_idx]
    dists = torch.sqrt(torch.sum(d * d, dim=-1) + eps * eps)
    return -torch.mean(torch.log(dists))
