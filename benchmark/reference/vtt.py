"""Plain reference of the M3L visuo-tactile transformer policy and its masked autoencoder
(arXiv:2311.00924, the reference ``train.py``'s model), and of the joint PPO+MAE update.

Written from the model's description in plain PyTorch over a dict of float32 parameters named as
the benchmark names them (the program's parameter names), with no kernels, no cache and no
batching tricks. Every product goes through a :class:`~.numerics.Numerics`, so the same code is
the float32 reference and the lower-precision control.

The model:

* raw observations: uint8 image (B, fs, 64, 64, 3) scaled to [0, 1] and stacked frame-major on
  channels; tactile (B, fs, 6, 32, 32) in [-1, 1], split into two sensors of 3 channels, stacked
  frame-major and mapped to [0, 1];
* tokens: an early convolution tower per modality (convs 4x4/2, 4x4/2, then 4x4/2 for the image
  and 3x3/1 for touch, ReLU after each, a 1x1 projection to the width): 64 tokens per map; plus a
  modality embedding and a 2-D sin/cos table (x-block then y-block, sin and cos interleaved);
* a pre-norm transformer (LayerNorm eps 1e-5, qkv without bias, exact GELU, final LayerNorm);
* the policy: encoder over all 192 tokens, a depth-1 post transformer, the token mean, tanh MLP
  towers (256, 256) for the action mean and the value; a state-independent log std;
* the MAE: per-modality random masks (the masked tokens drawn by argsort of uniform noise per
  segment), the encoder over the kept tokens, mask tokens restored to the full order, decoder
  modality and sin/cos embeddings, the decoder, linear heads to pixel and tactile patches, and
  the loss MSE(pixels) + 10 MSE(tactile) over every patch (early-convolution masking);
* the update: GAE, advantages normalised per minibatch (ddof 1), the clipped PPO loss plus 0.5
  value loss plus the MAE loss, one global-norm clip at 0.5 over every parameter, and Adam
  (b1 0.9, b2 0.999, eps 1e-5) with bias correction.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics

LOG_2PI = math.log(2.0 * math.pi)


# ------------------------------------------------------------------------------------------ #
# inputs
# ------------------------------------------------------------------------------------------ #
def sincos_2d(height: int, width: int, channels: int) -> torch.Tensor:
    """(height*width, channels) table: ``ch = ceil(channels/4)*2`` channels per axis with
    ``1/10000**(arange(0, ch, 2)/ch)`` frequencies, sin and cos interleaved; rows first."""
    ch = int(np.ceil(channels / 4) * 2)
    inv = 1.0 / (10000.0 ** (np.arange(0, ch, 2, dtype=np.float64) / ch))

    def axis(n):
        ang = np.arange(n, dtype=np.float64)[:, None] * inv[None, :]
        return np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(n, -1)

    out = np.zeros((height, width, 2 * ch))
    out[:, :, :ch] = axis(height)[:, None, :]
    out[:, :, ch:] = axis(width)[None, :, :]
    return torch.from_numpy(out[:, :, :channels].reshape(height * width, channels).astype(np.float32))


def load_obs(obs: dict, frame_stack: int) -> dict:
    """Raw obs tensors -> image (B, H, W, 3 fs) and tactile1..k (B, h, w, 3 fs), all f32 in [0, 1]."""
    img = obs["image"]
    b, fs, h, w, c = img.shape
    out = {"image": img.permute(0, 2, 3, 1, 4).reshape(b, h, w, fs * c).float() / 255.0}
    tac = obs["tactile"].float()
    b, fs, c, h, w = tac.shape
    for k in range(c // 3):
        sensor = tac[:, :, 3 * k : 3 * k + 3]  # (B, fs, 3, h, w), frames first
        out[f"tactile{k + 1}"] = (sensor.permute(0, 3, 4, 1, 2).reshape(b, h, w, fs * 3) + 1.0) / 2.0
    return out


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/p)(W/p), p*p*C), each patch flattened (row, col, channel)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


# ------------------------------------------------------------------------------------------ #
# layers
# ------------------------------------------------------------------------------------------ #
def layer_norm(x, P, name, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def attention(num: Numerics, x, qkv, heads, key_mask=None):
    """softmax(q k^T / sqrt(dh)) v over the packed (B, N, 3 H dh) projection ``qkv``."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    s = num.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    a = torch.softmax(s, dim=-1)
    return num.matmul(a, v).permute(0, 2, 1, 3).reshape(b, n, -1)


def transformer(num: Numerics, P, name, x, depth, heads):
    for i in range(depth):
        blk = f"{name}.blocks.{i}"
        h = layer_norm(x, P, f"{blk}.0.norm")
        h = attention(num, x, num.linear(h, P[f"{blk}.0.to_qkv.weight"]), heads)
        x = x + num.linear(h, P[f"{blk}.0.to_out.weight"], P[f"{blk}.0.to_out.bias"])
        h = layer_norm(x, P, f"{blk}.1.norm")
        h = F.gelu(num.linear(h, P[f"{blk}.1.fc1.weight"], P[f"{blk}.1.fc1.bias"]))
        x = x + num.linear(h, P[f"{blk}.1.fc2.weight"], P[f"{blk}.1.fc2.bias"])
    return layer_norm(x, P, f"{name}.norm")


def early_cnn(num: Numerics, P, name, x, image: bool):
    """(B, H, W, C) -> (B, 64, dim)."""
    x = x.permute(0, 3, 1, 2)
    for i, (stride, pad) in enumerate([(2, 1), (2, 1), (2, 1) if image else (1, 1)], start=1):
        x = F.relu(num.conv2d(x, P[f"{name}.conv{i}.weight"], P[f"{name}.conv{i}.bias"], stride, pad))
    x = num.conv2d(x, P[f"{name}.conv4.weight"], P[f"{name}.conv4.bias"], 1, 0)
    return x.flatten(2).transpose(1, 2)


# ------------------------------------------------------------------------------------------ #
# the model
# ------------------------------------------------------------------------------------------ #
class VTTReference:
    """The policy and its MAE at the sizes of a configuration file (see ``configs/``)."""

    MAE = "features.mae"

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.fs = cfg["frame_stack"]
        self.dim = cfg["dim_embedding"]
        self.depth, self.heads = cfg["depth"], cfg["heads"]
        self.n_img = (cfg["image_size"] // 8) ** 2
        self.n_tac = (cfg["tactile_size"] // 4) ** 2
        self.pos_enc = sincos_2d(cfg["image_size"] // 8, cfg["image_size"] // 8, self.dim).to(device)
        self.tac_enc = sincos_2d(cfg["tactile_size"] // 4, cfg["tactile_size"] // 4, self.dim).to(device)

    def tokens(self, num, P, x):
        m = self.MAE
        mod = P[f"{m}.encoder_modality_embedding.weight"]
        img = early_cnn(num, P, f"{m}.early_conv_vision", x["image"], True) + mod[0] + self.pos_enc
        tac = [early_cnn(num, P, f"{m}.early_conv_tactile", x[f"tactile{k}"], False) + mod[k] + self.tac_enc for k in (1, 2)]
        return torch.cat([img, *tac], dim=1)

    def features(self, num, P, tokens):
        enc = transformer(num, P, f"{self.MAE}.encoder.transformer", tokens, self.depth, self.heads)
        return transformer(num, P, "features.post", enc, 1, self.heads).mean(dim=1)

    def heads_(self, num, P, feats):
        def tower(name, h):
            for i in range(2):
                h = torch.tanh(num.linear(h, P[f"{name}.layers.{i}.weight"], P[f"{name}.layers.{i}.bias"]))
            return h

        mean = num.linear(tower("pi_mlp", feats), P["action_net.weight"], P["action_net.bias"])
        value = num.linear(tower("vf_mlp", feats), P["value_net.weight"], P["value_net.bias"])[:, 0]
        return mean, value

    def act(self, num, P, obs):
        """Deterministic actions (the Gaussian mean) and values of raw observations."""
        x = load_obs(obs, self.fs)
        return self.heads_(num, P, self.features(num, P, self.tokens(num, P, x)))

    def mae_loss(self, num, P, x, tokens, mask):
        """MSE(pixels) + 10 MSE(tactile) over every patch; ``mask`` = (masked_idx, kept_idx)."""
        m = self.MAE
        masked_idx, kept_idx = mask
        kept = torch.take_along_dim(tokens, kept_idx[:, :, None], dim=1)
        enc = transformer(num, P, f"{m}.encoder.transformer", kept, self.depth, self.heads)
        b = tokens.shape[0]
        full = torch.cat([enc, P[f"{m}.mask_token"].expand(b, masked_idx.shape[1], -1)], dim=1)
        order = torch.argsort(torch.cat([kept_idx, masked_idx], dim=1), dim=1)
        full = torch.take_along_dim(full, order[:, :, None], dim=1)
        dmod = P[f"{m}.decoder_modality_embedding.weight"]
        n = self.n_img
        full = torch.cat([
            full[:, :n] + dmod[0] + self.pos_enc,
            full[:, n : n + self.n_tac] + dmod[1] + self.tac_enc,
            full[:, n + self.n_tac :] + dmod[2] + self.tac_enc,
        ], dim=1)
        dec = transformer(num, P, f"{m}.decoder", full, self.cfg["decoder_depth"], self.cfg["decoder_heads"])
        pix = num.linear(dec[:, :n], P[f"{m}.to_pixels.weight"], P[f"{m}.to_pixels.bias"])
        tac = num.linear(dec[:, n:], P[f"{m}.to_tactiles.weight"], P[f"{m}.to_tactiles.bias"])
        target_tac = torch.cat([patchify(x["tactile1"], 4), patchify(x["tactile2"], 4)], dim=1)
        return ((pix - patchify(x["image"], 8)) ** 2).mean() + 10.0 * ((tac - target_tac) ** 2).mean()


def mask_counts(cfg: dict) -> tuple[list[int], list[int]]:
    """Segment sizes (image, sensor 1, sensor 2) and masked tokens per segment: int(ratio N)
    masked, the image int(masked N_img / N) of them, each sensor half of the rest."""
    n_img, n_tac = (cfg["image_size"] // 8) ** 2, (cfg["tactile_size"] // 4) ** 2
    n = n_img + 2 * n_tac
    masked = int(cfg["masking_ratio"] * n)
    m_img = int(masked * n_img / n)
    m_tac = (masked - m_img) // 2
    return [n_img, n_tac, n_tac], [m_img, m_tac, m_tac]


def draw_mask(generator: torch.Generator, batch: int, cfg: dict):
    """(masked_idx, kept_idx): per segment, argsort of uniform noise; its first entries masked."""
    sizes, counts = mask_counts(cfg)
    masked, kept, offset = [], [], 0
    for n, m in zip(sizes, counts):
        noise = torch.rand((batch, n), generator=generator, device=generator.device)
        perm = torch.argsort(noise, dim=-1) + offset
        masked.append(perm[:, :m])
        kept.append(perm[:, m:])
        offset += n
    return torch.cat(masked, dim=1), torch.cat(kept, dim=1)


def gae(rewards, values, starts, last_values, last_dones, gamma, lam):
    adv = torch.zeros_like(values)
    last = torch.zeros_like(last_values)
    next_v, next_nt = last_values, 1.0 - last_dones
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * next_v * next_nt - values[t]
        last = delta + gamma * lam * next_nt * last
        adv[t] = last
        next_v, next_nt = values[t], 1.0 - starts[t]
    return adv, adv + values


def ppo_steps(ref: VTTReference, num: Numerics, weights: dict, rollout: dict, cfg: dict, seed: int, steps: int, device, on_step=None):
    """The first ``steps`` joint PPO+MAE updates of a fresh update phase from ``weights``.

    ``rollout`` holds the benchmark's host arrays (obs, actions, rewards, episode_starts, values,
    log_probs, last_obs, last_episode_starts). The phase's randomness is redrawn from a generator
    on ``device`` seeded with ``seed``: one permutation of the rollout per epoch, then one mask
    per minibatch. Returns (losses, first clipped gradient by parameter, parameters after the
    last step); ``on_step(i, loss, grads)`` may alter a step (a planted fault)."""
    names = list(weights)
    P = {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
    obs = {k: put(v.reshape(-1, *v.shape[2:])) for k, v in rollout["obs"].items()}
    t_len, e_len = rollout["rewards"].shape
    n = t_len * e_len
    batch, gamma, lam = cfg["batch_size"], cfg["gamma"], cfg["gae_lambda"]
    with torch.no_grad():
        _, last_values = ref.act(num, P, {k: put(v) for k, v in rollout["last_obs"].items()})
    values = put(rollout["values"]).reshape(-1)
    adv, ret = gae(put(rollout["rewards"]), values.reshape(t_len, e_len), put(rollout["episode_starts"]), last_values,
                   put(rollout["last_episode_starts"]), gamma, lam)
    adv, ret = adv.reshape(-1), ret.reshape(-1)
    actions, old_logp = put(rollout["actions"]).reshape(n, -1), put(rollout["log_probs"]).reshape(-1)

    gen = torch.Generator(device=device).manual_seed(seed)
    perms = torch.stack([torch.randperm(n, generator=gen, device=device) for _ in range(cfg["ppo_epochs"])])
    idx_all = perms.reshape(-1, batch)
    masks = [draw_mask(gen, batch, cfg) for _ in range(steps)]

    mu = {k: torch.zeros_like(p) for k, p in P.items()}
    nu = {k: torch.zeros_like(p) for k, p in P.items()}
    losses, first_grad = [], None
    clip = cfg["clip_range"]
    for i in range(steps):
        idx = idx_all[i]
        a = adv[idx]
        a = (a - a.mean()) / (a.std(correction=1) + 1e-8)
        x = load_obs({k: v[idx] for k, v in obs.items()}, ref.fs)
        tokens = ref.tokens(num, P, x)
        mean, value = ref.heads_(num, P, ref.features(num, P, tokens))
        log_std = P["log_std"]
        logp = (-0.5 * ((actions[idx] - mean) ** 2 / torch.exp(2 * log_std) + 2 * log_std + LOG_2PI)).sum(-1)
        entropy = (0.5 + 0.5 * LOG_2PI + log_std).sum()
        ratio = torch.exp(logp - old_logp[idx])
        policy_loss = -torch.minimum(a * ratio, a * torch.clamp(ratio, 1 - clip, 1 + clip)).mean()
        value_loss = ((ret[idx] - value) ** 2).mean()
        loss = policy_loss + cfg["ent_coef"] * (-entropy) + cfg["vf_coef"] * value_loss
        loss = loss + ref.mae_loss(num, P, x, tokens, masks[i])
        grads = torch.autograd.grad(loss, [P[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(P[k]) if g is None else g for k, g in zip(names, grads)]
        if on_step is not None:
            loss, grads = on_step(i, loss, grads)
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        factor = torch.clamp(cfg["max_grad_norm"] / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = [g * factor for g in grads]
        if i == 0:
            first_grad = {k: g.detach().clone() for k, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                m_hat = mu[k] / (1 - 0.9 ** (i + 1))
                v_hat = nu[k] / (1 - 0.999 ** (i + 1))
                P[k] -= cfg["lr_ppo"] * m_hat / (torch.sqrt(v_hat) + 1e-5)
    return losses, first_grad, {k: p.detach() for k, p in P.items()}
