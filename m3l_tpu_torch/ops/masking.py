"""Static-shape random masking for the multimodal MAE (counterpart of ``m3l_tpu/ops/masking.py``).

Each modality segment gets its own uniform-argsort permutation; its first ``masked`` entries
are masked. Indices are global token positions (each segment's permutation is offset by the
segment start); the masked blocks of all segments are concatenated, then the kept blocks. The
noise comes from an explicit ``torch.Generator``, so it never matches JAX's bits: tests build a
:class:`ModalMask` from numpy and hand it in.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class ModalMask(NamedTuple):
    """Mask realisation for one batch (int64 index tensors on the tokens' device).

    masked_idx:   (B, M) global indices of masked tokens
    unmasked_idx: (B, K) global indices of kept tokens (encoder input order)
    restore_idx:  (B, N) gather indices st. cat([kept, masked], 1)[b, restore_idx[b]]
                  reproduces the original token order (N = M + K)
    """

    masked_idx: torch.Tensor
    unmasked_idx: torch.Tensor
    restore_idx: torch.Tensor


def mask_from_indices(masked_idx: torch.Tensor, unmasked_idx: torch.Tensor) -> ModalMask:
    """The :class:`ModalMask` of given masked and kept indices; ``restore_idx`` inverts them."""
    combined = torch.cat([unmasked_idx, masked_idx], dim=1)
    return ModalMask(masked_idx, unmasked_idx, torch.argsort(combined, dim=-1))


def random_modal_masking(
    generator: torch.Generator, batch: int, segment_sizes: Sequence[int], segment_masked: Sequence[int]
) -> ModalMask:
    """Sample a per-modality random mask with ``generator``, on the generator's device."""
    dev = generator.device
    masked_parts, unmasked_parts = [], []
    offset = 0
    for n, m in zip(segment_sizes, segment_masked):
        if n == 0:
            continue
        noise = torch.rand((batch, n), generator=generator, device=dev)
        perm = torch.argsort(noise, dim=-1) + offset
        masked_parts.append(perm[:, :m])
        unmasked_parts.append(perm[:, m:])
        offset += n
    empty = torch.zeros((batch, 0), dtype=torch.long, device=dev)
    masked_idx = torch.cat(masked_parts, dim=1) if masked_parts else empty
    unmasked_idx = torch.cat(unmasked_parts, dim=1) if unmasked_parts else empty
    return mask_from_indices(masked_idx, unmasked_idx)


def gather_tokens(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D)[b, idx[b]] -> (B, K, D)."""
    return torch.take_along_dim(tokens, idx[:, :, None], dim=1)


def restore_tokens(kept_tokens: torch.Tensor, mask_token: torch.Tensor, mask: ModalMask) -> torch.Tensor:
    """The full-length sequence in original order: one inverse-permutation gather over the kept
    tokens followed by copies of ``mask_token``, not scatters."""
    b, m = mask.masked_idx.shape
    mask_block = mask_token.to(kept_tokens.dtype).expand(b, m, kept_tokens.shape[-1])
    return gather_tokens(torch.cat([kept_tokens, mask_block], dim=1), mask.restore_idx)
