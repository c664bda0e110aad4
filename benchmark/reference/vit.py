"""Plain reference of Sparsh's tactile ViT (arXiv:2410.24090, ``config/model/dino_vit.yaml`` on
``config/data/digit.yaml``), of its DINO pretraining step and of the frozen attentive force probe.

Plain PyTorch over dicts of float32 parameters named as the benchmark names them, no kernels.
Every product goes through a :class:`~.numerics.Numerics`.

* Input: two DIGIT frames ``frame_stride`` apart, each the signed difference to the first frame
  of the recording shifted by 127 and clipped to 0-255, concatenated on channels, divided by 255.
* The ViT: a patch-16 convolution, a DINOv2-style sin/cos table (one block per axis, sin then cos,
  frequencies ``10000 ** -linspace(0, 1, block/2)``), one register token in front, pre-norm blocks
  (LayerNorm eps 1e-6, qkv and projection biases, exact GELU, a LayerScale after the attention and
  after the MLP), a final LayerNorm. A key mask hides masked patches from attention; every token
  is still computed.
* DINO: block masks (one block size per draw shared by the batch, corners per sample; the global
  block kept away from the union of the local ones where more than ``min_keep`` patches remain),
  the student over each view, the register token's output through the head (MLP 2048-2048-256,
  L2 normalisation, a weight-normed 65,536-wide last layer), the teacher's view centred and
  sharpened, cross-entropy summed over (student view, teacher view) pairs, plus the
  reconstruction probe (layer-normed teacher patch tokens -> a 2-block decoder -> pixels, MSE);
  AdamW with decay on matrices only, the warm-up-cosine learning rate; after each step the
  centre's EMA (0.9) and the teacher's EMA at the momentum ramp.
* The force probe: the frozen ViT's patch tokens, one learned query through a cross-attention
  block, a 2-layer head (384 -> 96 -> 3), smooth-L1 (beta 0.02); AdamW over the probe.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics
from .vtt import attention

LN_EPS = 1e-6


def sincos_nd(grid: tuple[int, ...], dim: int, temperature: float = 10000.0) -> torch.Tensor:
    n_axes = len(grid)
    block = (dim // n_axes) // 2 * 2
    half = block // 2
    freqs = temperature ** (-np.linspace(0.0, 1.0, half))
    mesh = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in grid], indexing="ij")
    out = np.zeros((int(np.prod(grid)), dim))
    for ax, pos in enumerate(mesh):
        ang = pos.reshape(-1)[:, None] * freqs[None, :]
        out[:, ax * block : ax * block + half] = np.sin(ang)
        out[:, ax * block + half : (ax + 1) * block] = np.cos(ang)
    return torch.from_numpy(out.astype(np.float32))


def frames_to_images(frames: torch.Tensor, starts: torch.Tensor, num_frames: int, stride: int, background: torch.Tensor) -> torch.Tensor:
    """(B, H, W, num_frames*3) f32 images of the windows starting at ``starts``, from uint8
    ``frames`` (T, H, W, 3) with background removal against ``background``."""
    diff = (frames[starts[:, None] + stride * torch.arange(num_frames, device=frames.device)].to(torch.int16)
            - background.to(torch.int16))
    img = torch.clamp(diff + 127, 0, 255).float()  # (B, T, H, W, 3)
    b, t, h, w, c = img.shape
    return img.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c) / 255.0


def ln(x, P, name, eps=LN_EPS):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def block(num: Numerics, P, name, x, heads, key_mask=None):
    h = ln(x, P, f"{name}.norm1")
    h = attention(num, None, num.linear(h, P[f"{name}.attn.qkv.weight"], P[f"{name}.attn.qkv.bias"]), heads, key_mask)
    x = x + num.linear(h, P[f"{name}.attn.proj.weight"], P[f"{name}.attn.proj.bias"]) * P[f"{name}.ls1.gamma"]
    h = F.gelu(num.linear(ln(x, P, f"{name}.norm2"), P[f"{name}.mlp.fc1.weight"], P[f"{name}.mlp.fc1.bias"]))
    return x + num.linear(h, P[f"{name}.mlp.fc2.weight"], P[f"{name}.mlp.fc2.bias"]) * P[f"{name}.ls2.gamma"]


class ViTReference:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.p = cfg["patch_size"]
        self.grid = (cfg["img_size"] // self.p, cfg["img_size"] // self.p)
        self.pos = sincos_nd(self.grid, cfg["embed_dim"]).to(device)
        self.dec_pos = sincos_nd(self.grid, cfg["recon_probe_embed_dim"]).to(device)

    def embed(self, num, P, name, x):
        t = num.conv2d(x.permute(0, 3, 1, 2), P[f"{name}.patch_embed.proj.weight"], P[f"{name}.patch_embed.proj.bias"], self.p, 0)
        return t.flatten(2).transpose(1, 2) + self.pos

    def forward(self, num, P, name, x, key_masks=None):
        """Normed tokens (rows, 1 + N, D), registers first; ``key_masks`` (M, B, N) runs the M
        masked views of every image, mask-major."""
        t = self.embed(num, P, name, x)
        km = None
        if key_masks is not None:
            m, b, n = key_masks.shape
            t = t.repeat(m, 1, 1)
            km = torch.cat([torch.ones(m * b, 1, dtype=torch.bool, device=t.device), key_masks.reshape(m * b, n)], dim=1)
        t = torch.cat([P[f"{name}.register_tokens"].expand(t.shape[0], -1, -1), t], dim=1)
        for i in range(self.cfg["depth"]):
            t = block(num, P, f"{name}.blocks.{i}", t, self.cfg["num_heads"], km)
        return ln(t, P, f"{name}.norm")


def dino_head(num, P, name, x):
    layers = sorted({int(k[len(name) + 12 :].split(".")[0]) for k in P if k.startswith(f"{name}.mlp_layers.")})
    for i in layers:
        x = num.linear(x, P[f"{name}.mlp_layers.{i}.weight"], P[f"{name}.mlp_layers.{i}.bias"])
        if i < layers[-1]:
            x = F.gelu(x)
    x = x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)
    v, g = P[f"{name}.last_v"], P[f"{name}.last_g"]
    w = g[:, None] * v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-24)
    return num.matmul(x, w.t())


# ------------------------------------------------------------------------------------------ #
# block masks
# ------------------------------------------------------------------------------------------ #
def block_masks(gen: torch.Generator, batch: int, grid, scale, n_masks: int) -> torch.Tensor:
    """(n_masks, batch, gh*gw) bool keep-masks: one block size (area ~ U(scale), side
    round(sqrt(area N)), half to even) per draw, corners uniform per (mask, sample)."""
    gh, gw = grid
    dev = gen.device
    u = torch.rand((), generator=gen, device=dev)
    u_top = torch.rand((n_masks, batch), generator=gen, device=dev)
    u_left = torch.rand((n_masks, batch), generator=gen, device=dev)
    area = scale[0] + u * (scale[1] - scale[0])
    side = torch.round(torch.sqrt(gh * gw * area)).to(torch.int32)
    h, w = side.clamp(1, gh), side.clamp(1, gw)
    top = torch.floor(u_top * (gh - h + 1).float()).to(torch.int32)
    left = torch.floor(u_left * (gw - w + 1).float()).to(torch.int32)
    rows, cols = torch.arange(gh, device=dev), torch.arange(gw, device=dev)
    r = (rows >= top[..., None]) & (rows < (top + h)[..., None])
    c = (cols >= left[..., None]) & (cols < (left + w)[..., None])
    return (r[..., :, None] & c[..., None, :]).reshape(n_masks, batch, gh * gw)


def dino_masks(gen: torch.Generator, batch: int, cfg: dict):
    grid = (cfg["img_size"] // cfg["patch_size"],) * 2
    local = block_masks(gen, batch, grid, cfg["local_mask_scale"], cfg["num_local_masks"])
    raw = block_masks(gen, batch, grid, cfg["global_mask_scale"], cfg["num_global_masks"])
    constrained = raw & ~local.any(dim=0)[None]
    glob = torch.where((constrained.sum(-1) > cfg["min_keep_num_sensors"])[..., None], constrained, raw)
    return glob, local


# ------------------------------------------------------------------------------------------ #
# schedules and AdamW
# ------------------------------------------------------------------------------------------ #
def warmup_cosine(step: int, base: float, warmup: int, total: int) -> float:
    if step < warmup:
        return step / max(warmup, 1) * base
    return max(0.0, base * 0.5 * (1.0 + math.cos(math.pi * (step - warmup) / max(total - warmup, 1))))


class AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8), weight decay on parameters of 2 or more dimensions."""

    def __init__(self, params: dict):
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float, wd: float) -> None:
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(0.9).add_(0.1 * g)
            self.nu[k].mul_(0.999).add_(0.001 * g * g)
            upd = (self.mu[k] / (1 - 0.9**self.t)) / (torch.sqrt(self.nu[k] / (1 - 0.999**self.t)) + 1e-8)
            p.sub_(lr * (upd + (wd * p if p.dim() >= 2 else 0.0)))


def _grads(loss, params: dict) -> dict:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


# ------------------------------------------------------------------------------------------ #
# the DINO step
# ------------------------------------------------------------------------------------------ #
def dino_steps(cfg: dict, num: Numerics, weights: dict, batches, seed: int, steps_per_epoch: int, steps: int, device):
    """The first ``steps`` DINO steps from ``weights`` (students, teachers, head and probe) on
    ``batches`` (images (B, H, W, C)), masks redrawn from a generator on ``device`` seeded with
    ``seed``. Returns (losses, first gradients, trainable parameters after the last step, the
    centre after the last step, the teachers after the last step)."""
    vit = ViTReference(cfg, device)
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items() if not k.startswith("teacher_")}
    T = {k: v.detach().clone().float() for k, v in weights.items() if k.startswith("teacher_")}
    center = torch.zeros(1, cfg["dino_out_dim"], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    opt = AdamW(P)
    total = steps_per_epoch * cfg["max_epochs"]
    warm_t = cfg["teacher_warmup_epochs"] * steps_per_epoch
    losses, first = [], None
    for step, x in zip(range(steps), batches):
        glob, local = dino_masks(gen, x.shape[0], cfg)
        b, mg, ml = x.shape[0], glob.shape[0], local.shape[0]
        temp = cfg["teacher_temp"][1] if step > warm_t else cfg["teacher_temp"][0] + step * (cfg["teacher_temp"][1] - cfg["teacher_temp"][0]) / max(warm_t, 1)
        s_views = []
        for masks in (glob, local):
            out = vit.forward(num, P, "student_backbone", x, masks)[:, 0]
            s_views += list(dino_head(num, P, "student_head", out).reshape(masks.shape[0], b, -1))
        with torch.no_grad():
            t_logits = dino_head(num, T, "teacher_head", vit.forward(num, T, "teacher_backbone", x, glob)[:, 0])
            t_probs = torch.softmax((t_logits - center) / temp, dim=-1).reshape(mg, b, -1)
        loss = torch.zeros((), device=device)
        for s in s_views:
            lsm = torch.log_softmax(s / cfg["student_temp"], dim=-1)
            for t in t_probs:
                loss = loss - (t * lsm).sum(-1).mean()
        with torch.no_grad():
            emb = vit.forward(num, T, "teacher_backbone", x)[:, 1:]
            emb = (emb - emb.mean(-1, keepdim=True)) / torch.sqrt(emb.var(-1, keepdim=True, correction=0) + 1e-5)
        d = num.linear(emb, P["recon_probe.decoder_embed.weight"], P["recon_probe.decoder_embed.bias"]) + vit.dec_pos
        for i in range(cfg["recon_probe_depth"]):
            d = block(num, P, f"recon_probe.blocks.{i}", d, cfg["recon_probe_num_heads"])
        pred = num.linear(ln(d, P, "recon_probe.norm"), P["recon_probe.decoder_pred.weight"], P["recon_probe.decoder_pred.bias"])
        p = cfg["patch_size"]
        bb, h, w, c = x.shape
        target = x.reshape(bb, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(bb, -1, p * p * c)
        loss = loss + ((pred - target) ** 2).mean()
        grads = _grads(loss, P)
        if step == 0:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        opt.step(P, grads, warmup_cosine(step, cfg["base_lr"], cfg["warmup_epochs"] * steps_per_epoch, total), cfg["weight_decay"])
        with torch.no_grad():
            center = center * 0.9 + t_logits.mean(dim=0, keepdim=True) * 0.1
            m0, m1 = cfg["moving_average_decay"]
            decay = torch.tensor(m0 + min(max(step / max(total, 1), 0.0), 1.0) * (m1 - m0), dtype=torch.float32)
            for k in T:
                s = P["student_" + k[len("teacher_"):]]
                T[k] = T[k] * decay + s.detach() * (1.0 - decay)
    return losses, first, {k: v.detach() for k, v in P.items()}, center, T


# ------------------------------------------------------------------------------------------ #
# the frozen force probe
# ------------------------------------------------------------------------------------------ #
def force_probe_steps(cfg: dict, num: Numerics, weights: dict, batches, steps_per_epoch: int, steps: int, device):
    """The first ``steps`` probe steps from ``weights`` (encoder ``model_encoder.encoder.*``,
    frozen; probe ``model_task.*``) on ``batches`` of (images, force targets). Returns (losses,
    first gradients, probe parameters after the last step)."""
    vit = ViTReference(cfg, device)
    enc = {k: v.float() for k, v in weights.items() if k.startswith("model_encoder.")}
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items() if k.startswith("model_task.")}
    opt = AdamW(P)
    total = steps_per_epoch * cfg["force_probe_max_epochs"]
    heads = cfg["force_probe_num_heads"]
    losses, first = [], None
    for step, (x, y) in zip(range(steps), batches):
        with torch.no_grad():
            tokens = vit.forward(num, enc, "model_encoder.encoder", x)[:, 1:]
        c = "model_task.pooler.cross"
        q = P["model_task.pooler.query_tokens"].expand(x.shape[0], -1, -1)
        qn, kvn = ln(q, P, f"{c}.norm_q"), ln(tokens, P, f"{c}.norm_kv")
        b, nq, d = qn.shape
        qq = num.linear(qn, P[f"{c}.xattn.q.weight"], P[f"{c}.xattn.q.bias"]).reshape(b, nq, heads, -1).transpose(1, 2)
        k, v = num.linear(kvn, P[f"{c}.xattn.kv.weight"], P[f"{c}.xattn.kv.bias"]).reshape(b, -1, 2, heads, d // heads).permute(2, 0, 3, 1, 4)
        a = torch.softmax(num.matmul(qq, k.transpose(-1, -2)) * (d // heads) ** -0.5, dim=-1)
        o = num.matmul(a, v).transpose(1, 2).reshape(b, nq, d)
        q = q + num.linear(o, P[f"{c}.xattn.proj.weight"], P[f"{c}.xattn.proj.bias"])
        h = F.gelu(num.linear(ln(q, P, f"{c}.norm2"), P[f"{c}.mlp.fc1.weight"], P[f"{c}.mlp.fc1.bias"]))
        q = q + num.linear(h, P[f"{c}.mlp.fc2.weight"], P[f"{c}.mlp.fc2.bias"])
        h = torch.relu(num.linear(q[:, 0], P["model_task.head.0.weight"], P["model_task.head.0.bias"]))
        pred = num.linear(h, P["model_task.head.1.weight"], P["model_task.head.1.bias"])
        diff = (pred - y).abs()
        beta = cfg["smooth_l1_beta"]
        loss = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta).mean()
        grads = _grads(loss, P)
        if step == 0:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        lr = warmup_cosine(step, cfg["force_probe_base_lr"], cfg["force_probe_warmup_epochs"] * steps_per_epoch, total)
        opt.step(P, grads, lr, cfg["force_probe_weight_decay"])
    return losses, first, {k: v.detach() for k, v in P.items()}
