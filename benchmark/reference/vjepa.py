"""Plain reference of V-JEPA's ViT-L/16 video pretraining (arXiv:2404.08471; facebookresearch/jepa
``configs/pretrain/vitl16.yaml`` run by ``app/vjepa/train.py``): its multi-block 3-D masks, its
encoder, EMA target and predictor, and its training step.

Plain PyTorch over dicts of float32 parameters named as the benchmark names them, no kernels.
Every product goes through a :class:`~.numerics.Numerics`.

* Masks (``src/masks/multiblock3d.py``), one set per generator: a block size drawn once a batch
  from three uniforms (temporal scale tau, spatial scale s, aspect ratio ar: t = max(1, int(T'
  tau)), keep = int(H' W' s), h = min(round(sqrt(keep ar)), H'), w = min(round(sqrt(keep / ar)),
  W')), then for each clip ``num_blocks`` blocks at start, top and left floor(u x (room + 1)); a
  clip's mask starts at ones and each block zeroes its tokens; a clip left with no context is drawn
  again from its next round of uniforms. The targets are the zeroed tokens and the context the
  rest, each listed in ascending (t, h, w) order and cut to the batch's smallest count.
* The encoder: tubelets of 2 frames x 16 x 16 embedded by one linear map (a stride-equal Conv3d),
  a fixed sin-cos table added, the context gathered, pre-norm blocks (LayerNorm eps 1e-6, qkv and
  projection biases, exact GELU, no LayerScale), a final LayerNorm.
* The target: the EMA encoder over every token, layer-normed without affine parameters (eps 1e-5).
* The predictor: 1024 -> 384 on the context plus its table, one mask token (generator i's) plus the
  table at each target, pre-norm blocks of 16 heads of 24, a LayerNorm, 384 -> 1024 at the targets.
* The step: the mean over the generators of mean |z - h| (``loss_exp`` 1, ``reg_coeff`` 0),
  gradients clipped to a global norm of ``clip_grad``, AdamW (b1 0.9, b2 0.999, eps 1e-8) at the
  warm-up-cosine learning rate and the cosine weight decay, then the target's EMA at the linear
  momentum ramp; the schedules' horizon is ``ipe`` x ``ipe_scale`` x ``epochs`` steps.

For given index sets the loss separates by clip, so a step runs in chunks of clips with the
gradients summed, which bounds the N x N attention of the f32 reference.

Departures from the published code, each also in the configuration's ``assumed``: the position
tables are the program's (``vit.sincos_nd``: per axis a sin block then a cos block, frequencies
``10000 ** -linspace(0, 1, half)``), not ``get_3d_sincos_pos_embed(uniform_power=True)``; the
frames are synthetic uint8 over 255, without ImageNet normalisation or the random-resize crop;
the target starts behind its encoder (its weights a lagging mix, as a resumed fit's stand); the
clip is of the global norm over all trainable parameters at every step, where ``train.py`` clips
the encoder and the predictor apart and only after the warm-up; AdamW decays every parameter of 2
or more dimensions (the published excludes biases and 1-D parameters: the same sets), the
predictor's unused patch embedding too, which the program keeps; the schedules are read at the
count of steps before the update, as the program's optimizer reads them (``train.py`` steps its
schedulers first, one step ahead).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import Numerics
from .vit import AdamW, ln, sincos_nd
from .vtt import attention


# ------------------------------------------------------------------------------------------ #
# masks
# ------------------------------------------------------------------------------------------ #
def block_size(u_size, grid, spec: dict) -> tuple[int, int, int]:
    """The batch's (t, h, w) from its uniforms (temporal, spatial, aspect ratio)."""
    dur, height, width = grid
    u_t, u_s, u_a = (float(u) for u in u_size)
    lo, hi = spec["temporal_scale"]
    t = max(1, int(dur * (lo + u_t * (hi - lo))))
    lo, hi = spec["spatial_scale"]
    keep = int(height * width * (lo + u_s * (hi - lo)))
    lo, hi = spec["aspect_ratio"]
    ar = lo + u_a * (hi - lo)
    h = min(int(round(math.sqrt(keep * ar))), height)
    w = min(int(round(math.sqrt(keep / ar))), width)
    return t, h, w


def multiblock_masks(uniforms: dict, grid, spec: dict) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(context (B, Kc), target (B, Kt), clips drawn again) from one generator's uniforms
    (``size`` (3,); ``start``, ``top``, ``left`` (rounds, B, blocks)), a clip at a time."""
    dur, height, width = grid
    t, h, w = block_size(uniforms["size"], grid, spec)
    start, top, left = (uniforms[k].double().cpu() for k in ("start", "top", "left"))
    contexts, targets, redraws = [], [], 0
    for b in range(start.shape[1]):
        for r in range(start.shape[0]):
            keep = torch.ones(dur, height, width, dtype=torch.int32)
            for j in range(start.shape[2]):
                s0 = math.floor(float(start[r, b, j]) * (dur - t + 1))
                t0 = math.floor(float(top[r, b, j]) * (height - h + 1))
                l0 = math.floor(float(left[r, b, j]) * (width - w + 1))
                keep[s0 : s0 + t, t0 : t0 + h, l0 : l0 + w] = 0
            keep = keep.flatten()
            if keep.any():
                break
            redraws += 1
        else:
            raise ValueError("every round left the clip without a context")
        contexts.append(torch.nonzero(keep).flatten())
        targets.append(torch.nonzero(keep == 0).flatten())
    kc, kt = min(len(c) for c in contexts), min(len(x) for x in targets)
    return torch.stack([c[:kc] for c in contexts]), torch.stack([x[:kt] for x in targets]), redraws


# ------------------------------------------------------------------------------------------ #
# the model
# ------------------------------------------------------------------------------------------ #
def block(num: Numerics, P, name, x, heads):
    h = ln(x, P, f"{name}.norm1")
    h = attention(num, None, num.linear(h, P[f"{name}.attn.qkv.weight"], P[f"{name}.attn.qkv.bias"]), heads)
    x = x + num.linear(h, P[f"{name}.attn.proj.weight"], P[f"{name}.attn.proj.bias"])
    h = F.gelu(num.linear(ln(x, P, f"{name}.norm2"), P[f"{name}.mlp.fc1.weight"], P[f"{name}.mlp.fc1.bias"]))
    return x + num.linear(h, P[f"{name}.mlp.fc2.weight"], P[f"{name}.mlp.fc2.bias"])


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(x, idx[:, :, None], dim=1)


class VJEPAReference:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        p, tub = cfg["patch_size"], cfg["tubelet_size"]
        self.grid = (cfg["num_frames"] // tub, cfg["img_size"] // p, cfg["img_size"] // p)
        self.pos = sincos_nd(self.grid, cfg["embed_dim"]).to(device)
        self.pred_pos = sincos_nd(self.grid, cfg["pred_embed_dim"]).to(device)

    def tubelets(self, num, P, name, x):
        """(B, T, H, W, C) -> (B, N, D): each tubelet's (C, t, h, w) values through the Conv3d's weight."""
        b, tt, hh, ww, c = x.shape
        tub, p = self.cfg["tubelet_size"], self.cfg["patch_size"]
        x = x.reshape(b, tt // tub, tub, hh // p, p, ww // p, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, -1, c * tub * p * p)
        w = P[f"{name}.patch_embed.proj.weight"]
        return num.linear(x, w.reshape(w.shape[0], -1), P[f"{name}.patch_embed.proj.bias"]) + self.pos

    def encoder(self, num, P, name, x, idx=None):
        """Normed tokens of the encoder ``name`` over the clips ``x``, at ``idx`` (B, K) or all."""
        t = self.tubelets(num, P, name, x)
        if idx is not None:
            t = gather(t, idx)
        for i in range(self.cfg["depth"]):
            t = block(num, P, f"{name}.blocks.{i}", t, self.cfg["num_heads"])
        return ln(t, P, f"{name}.norm")

    def predictor(self, num, P, z, ctx_idx, tgt_idx, mask_index):
        n = "predictor"
        x = num.linear(z, P[f"{n}.input_projection.weight"], P[f"{n}.input_projection.bias"]) + self.pred_pos[ctx_idx]
        tokens = P[f"{n}.mask_tokens.{mask_index}"][None] + self.pred_pos[tgt_idx]
        x = torch.cat([x, tokens], dim=1)
        for i in range(self.cfg["pred_depth"]):
            x = block(num, P, f"{n}.blocks.{i}", x, self.cfg["pred_num_heads"])
        x = ln(x, P, f"{n}.norm")[:, ctx_idx.shape[1] :]
        return num.linear(x, P[f"{n}.output_projection.weight"], P[f"{n}.output_projection.bias"])


# ------------------------------------------------------------------------------------------ #
# schedules and the step
# ------------------------------------------------------------------------------------------ #
def horizon(cfg: dict) -> int:
    return int(cfg["ipe"] * cfg["ipe_scale"] * cfg["epochs"])


def learning_rate(cfg: dict, step: int) -> float:
    warm = cfg["warmup"] * cfg["ipe"]
    if step < warm:
        return cfg["start_lr"] + step / warm * (cfg["lr"] - cfg["start_lr"])
    progress = (step - warm) / max(horizon(cfg) - warm, 1)
    return max(cfg["final_lr"], cfg["final_lr"] + (cfg["lr"] - cfg["final_lr"]) * 0.5 * (1.0 + math.cos(math.pi * progress)))


def weight_decay(cfg: dict, step: int) -> float:
    ref, final = cfg["weight_decay"], cfg["final_weight_decay"]
    wd = final + (ref - final) * 0.5 * (1.0 + math.cos(math.pi * step / horizon(cfg)))
    return min(final, wd) if final >= ref else max(final, wd)


def momentum(cfg: dict, step: int) -> float:
    m0, m1 = cfg["ema"]
    return m0 + min(step / horizon(cfg), 1.0) * (m1 - m0)


def vjepa_steps(cfg: dict, num: Numerics, weights: dict, batches, uniforms, steps: int, device, chunk: int):
    """The first ``steps`` steps from ``weights`` (``context_encoder.*``, ``predictor.*`` trained;
    ``target_encoder.*``) on ``batches`` (clips (B, T, H, W, C) in [0, 1]), each step's masks made
    from its generators' ``uniforms`` (a list a step, a dict a generator). Returns (losses, first
    gradients (clipped, as AdamW took them), trainable parameters after the last step, the target
    after it, each step's masks [(context, target, redraws), ...])."""
    ref = VJEPAReference(cfg, device)
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items() if not k.startswith("target_encoder.")}
    T = {k: v.detach().clone().float() for k, v in weights.items() if k.startswith("target_encoder.")}
    opt = AdamW(P)
    specs = cfg["mask"]
    losses, first, masks = [], None, []
    for step, x, drawn in zip(range(steps), batches, uniforms):
        made = [multiblock_masks(u, ref.grid, spec) for u, spec in zip(drawn, specs)]
        masks.append(made)
        b = x.shape[0]
        grads = {k: torch.zeros_like(p) for k, p in P.items()}
        loss = 0.0
        for c0 in range(0, b, chunk):
            xc = x[c0 : c0 + chunk]
            with torch.no_grad():
                h = ref.encoder(num, T, "target_encoder", xc)
                h = F.layer_norm(h, (h.shape[-1],))
            for i, (ctx, tgt, _) in enumerate(made):
                ci, ti = ctx[c0 : c0 + chunk].to(device), tgt[c0 : c0 + chunk].to(device)
                z = ref.predictor(num, P, ref.encoder(num, P, "context_encoder", xc, ci), ci, ti, i)
                part = (z - gather(h, ti)).abs().sum() / (b * ti.shape[1] * z.shape[-1] * len(made))
                gs = torch.autograd.grad(part, list(P.values()), allow_unused=True)
                for (k, _), g in zip(P.items(), gs):
                    if g is not None:
                        grads[k] += g
                loss += float(part.detach())
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if norm >= cfg["clip_grad"]:
                grads = {k: g / norm * cfg["clip_grad"] for k, g in grads.items()}
        if step == 0:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(loss)
        opt.step(P, grads, learning_rate(cfg, step), weight_decay(cfg, step))
        with torch.no_grad():
            m = torch.tensor(momentum(cfg, step), dtype=torch.float32, device=device)
            for k in T:
                T[k] = T[k] * m + P["context_encoder." + k[len("target_encoder."):]].detach() * (1.0 - m)
    return losses, first, {k: v.detach() for k, v in P.items()}, T, masks
