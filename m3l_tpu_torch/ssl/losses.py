"""Self-distillation losses (DINO, iBOT, KoLeo) as functions (counterpart of
``m3l_tpu/ssl/losses.py``).

The center is an explicit tensor, (1, K) for CLS outputs or (1, 1, K) for patch tokens, which the
caller keeps (a module buffer) and replaces with :func:`update_center`'s result. Without a mesh
every sum is over the batch it is given. A JAX mesh run takes them over the global batch (GSPMD,
no ``axis_name``); on the port's mesh (``train/mesh.py``) each rank holds only its dp rows, so each
function that takes a batch statistic has a ``mesh`` argument, the counterpart of JAX's
``axis_name``: the center's batch sum and row count, the Sinkhorn-Knopp total, row sums and sample
count, iBOT's kept-token counts and KoLeo's candidate neighbours (a differentiable gather,
:func:`..train.mesh.gather_dp`) are then taken over the dp group, and a loss is this rank's share of
the global one (the ranks' shares sum to it). The mp ranks of one dp index hold the same rows, so
no sum runs over mp. With ``mesh=None`` the functions compute what they did before the argument.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..train.mesh import gather_dp


def dp_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` (a fresh tensor) summed in place over the dp group; ``t`` itself without a mesh."""
    return t if mesh is None else mesh.all_reduce_dp(t)


def softmax_center_teacher(center: torch.Tensor, teacher_output: torch.Tensor, teacher_temp) -> torch.Tensor:
    """Centered and sharpened teacher distribution: softmax((t - center) / temp) over the last axis."""
    t = teacher_output.float()
    return torch.softmax((t - center.reshape((1,) * (t.dim() - 1) + (-1,))) / teacher_temp, dim=-1)


def update_center(center: torch.Tensor, teacher_output: torch.Tensor, momentum: float = 0.9, mesh=None) -> torch.Tensor:
    """The EMA of the center toward the batch center. For patch tokens (B, N, K) the batch center
    is the mean over tokens, then the mean over the batch. Under ``mesh`` the batch sum and the
    row count are summed over the dp group in one collective."""
    t = teacher_output.float()
    batch_sum = torch.sum(t.mean(dim=1) if t.dim() == 3 else t, dim=0, keepdim=True)
    if mesh is None:
        batch_center = (batch_sum / t.shape[0]).reshape(center.shape)
    else:
        both = mesh.all_reduce_dp(torch.cat([batch_sum.reshape(-1), batch_sum.new_full((1,), t.shape[0])]))
        batch_center = (both[:-1] / both[-1]).reshape(center.shape)
    return center * momentum + batch_center * (1.0 - momentum)


def sinkhorn_knopp_teacher(
    teacher_output: torch.Tensor,
    teacher_temp,
    n_iterations: int = 3,
    n_samples: Optional[torch.Tensor] = None,
    sample_mask: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Sinkhorn-Knopp assignment of (B, K) teacher logits. ``n_samples`` overrides the sample
    count (iBOT passes the number of kept patches); ``sample_mask`` (B,) bool leaves rows out of
    the transport problem (their columns are zeroed before normalisation). Under ``mesh`` the
    total and the sample count (one collective) and every row sum are summed over the dp group;
    the column sums are per sample and stay local."""
    t = teacher_output.float()
    q = torch.exp(t / teacher_temp).T  # (K, B)
    if sample_mask is not None:
        q = q * sample_mask.float()[None, :]
    if torch.is_tensor(n_samples):
        b_total = n_samples.to(q.device, torch.float32)
    else:  # a fill on the card, not a copy the host waits for
        b_total = torch.full((), q.shape[1] if n_samples is None else n_samples, dtype=torch.float32, device=q.device)
    k = q.shape[0]
    if mesh is None:
        q = q / torch.sum(q)
    else:
        total, b_total = mesh.all_reduce_dp(torch.stack([torch.sum(q), b_total.reshape(())]))
        q = q / total
    for _ in range(n_iterations):
        q = q / dp_sum(torch.sum(q, dim=1, keepdim=True), mesh) / k
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
    student_patch_logits: torch.Tensor,
    teacher_patch_probs: torch.Tensor,
    keep_masks: torch.Tensor,
    student_temp: float = 0.1,
    mesh=None,
) -> torch.Tensor:
    """All-pairs patch distillation: for every (student view i, teacher view j) of the (M, B, N, K)
    inputs, the mean of sum(t_j * log_softmax(s_i / temp)) over the tokens that view j keeps
    (``keep_masks`` (M, B, N) bool), negated and summed over the M^2 pairs. Every position is
    computed (key-masked forward) and weighted, with no gather, so the shapes stay static. Under
    ``mesh`` each view's kept count is the global batch's (one collective for the M counts) and the
    result is this rank's share."""
    m = student_patch_logits.shape[0]
    lsm = torch.log_softmax(student_patch_logits.float() / student_temp, dim=-1)
    t = teacher_patch_probs.float()
    counts = dp_sum(keep_masks.float().sum(dim=(1, 2)), mesh)  # (M,): whole numbers, exact in any order
    total = torch.zeros((), dtype=torch.float32, device=lsm.device)
    for i in range(m):
        for j in range(m):
            per_tok = torch.sum(t[j] * lsm[i], dim=-1)  # (B, N)
            w = keep_masks[j].float()
            total = total - torch.sum(per_tok * w) / torch.clamp(counts[j], min=1.0)
    return total


def koleo_loss(student_output: torch.Tensor, eps: float = 1e-8, mesh=None) -> torch.Tensor:
    """Kozachenko-Leonenko entropic regulariser: -mean(log distance to the nearest neighbour) over
    L2-normalised rows. The eps sits inside both square roots, so an all-zero row and two equal
    rows still give finite gradients. Under a ``mesh`` with dp > 1 each of this rank's rows finds
    its neighbour among all rows of the global batch (gathered over the dp group, differentiably),
    and the result is this rank's share, -sum(log distance) over its rows / the global row count."""
    x = student_output.float()
    x = x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)
    n = x.shape[0]
    if mesh is None or mesh.dp == 1:
        dots = x @ x.T
        dots = dots - 2.0 * torch.eye(n, device=x.device)  # exclude self
        nn_idx = torch.argmax(dots, dim=1)
        d = x - x[nn_idx]
        dists = torch.sqrt(torch.sum(d * d, dim=-1) + eps * eps)
        return -torch.mean(torch.log(dists))
    everyone = gather_dp(x, mesh)  # (B_global, D)
    rows = mesh.rows(everyone.shape[0])
    own = torch.zeros(n, everyone.shape[0], device=x.device)
    own[:, rows] = torch.eye(n, device=x.device)
    nn_idx = torch.argmax(x @ everyone.T - 2.0 * own, dim=1)  # exclude self
    d = x - everyone[nn_idx]
    dists = torch.sqrt(torch.sum(d * d, dim=-1) + eps * eps)
    return -torch.sum(torch.log(dists)) / everyone.shape[0]
