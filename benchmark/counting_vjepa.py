"""Model operations of a V-JEPA step, counted from shapes and the step's token counts, under the
conventions of ``counting.py`` (forward plus backward, 3x forward where gradients flow; norms and
activations not counted).

A step's context and target counts change with its masks, and attention's work with the square of
a sequence's length, so the operations are counted a step at a time from the counts the program
kept for that step (``VJEPAModule.mask_counts``).
"""
from __future__ import annotations

from .counting import block_flops, linear_flops


def vjepa_step_flops(cfg: dict, batch: int, counts: list[tuple[int, int]]) -> float:
    """Operations of one step over ``batch`` clips: the target's forward over every token, and for
    each generator's (context, target) count in ``counts`` the context encoder (the tubelet
    embedding of the whole clip, the blocks over the context) and the predictor (the input
    projection, the blocks over context and targets, the output projection at the targets),
    forward and backward."""
    d, p, tub = cfg["embed_dim"], cfg["patch_size"], cfg["tubelet_size"]
    n = (cfg["num_frames"] // tub) * (cfg["img_size"] // p) ** 2
    mlp = int(d * cfg["mlp_ratio"])
    dp = cfg["pred_embed_dim"]
    patch = linear_flops(n, cfg["in_chans"] * tub * p * p, d)
    total = patch + cfg["depth"] * block_flops(n, d, d, mlp)
    for context, target in counts:
        encoder = patch + cfg["depth"] * block_flops(context, d, d, mlp)
        predictor = (linear_flops(context, d, dp) + cfg["pred_depth"] * block_flops(context + target, dp, dp, int(dp * cfg["mlp_ratio"]))
                     + linear_flops(target, dp, d))
        total += 3 * (encoder + predictor)
    return batch * total
