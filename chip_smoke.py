#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (m3l_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it fails:

1. the card's name and power limit, and the matmul precision flags;
2. build every CUDA source of m3l_tpu_torch/csrc (one nvcc each, all started together);
3. each kernel against its plain PyTorch version on the card, element by element within its
   stated tolerance, at the serving and training shapes and a few more (the packed qkv pair and
   the split-head v1 pair, which share their kernel bodies); then each timed beside
   its plain version, its byte/FLOP bound and one PyTorch library call that computes the same
   function (timed as a yardstick only; the port never calls it). Each case prints the body
   that served it (bf16 "tensor_core", f32 "tf32x3": both on the tensor cores, forward and
   backward) and fails on another;
4. the serving slice: the full-width PPO+MAE policy (dim 256, 4 encoder layers + 1 post layer,
   bf16 compute, random weights from a seed) serves 8 requests of batch 8 and one of batch 512
   through PolicyServer; every forward must launch the attention kernel 5 times, and the
   batch-8 actions and values, in bf16 and in f32 on the card, must match the same weights
   run in f32 on the CPU;
5. the training slice at full width (dim 256, 4 encoder layers, 192 tokens, 10 kept at mask
   ratio 0.95, decoder depth 3, 4 heads): (a) one joint PPO+MAE minibatch update in f32 on
   the card against the same weights, batch and mask in f32 on the CPU, at minibatch 64 so the
   CPU side takes seconds; (b) PPOMAE in bf16 on FakeInsertion (8 envs, frame stack 4,
   rollout 1024, minibatch 512, 2 epochs) learns for two iterations; every train() must
   launch the forward kernel 12 times per update plus 5 (last_values) and the backward kernel
   12 times per update. Cut from the reference workload to fit the time limit: the rollout
   (1024 of 32768 samples) and the epochs (2 of 10); widths, depth, tokens and the minibatch
   are full.

6. the attention-layer bench (``m3l_tpu_torch.bench_attention``) at its full shape B=512, N=192,
   D=256, H=4, bf16: the v1 and v2 layers must give the same loss and gradients, bit for bit
   (shared kernel bodies), and each timed call of 10 steps must launch only its own kernels, 10
   forward and 10 backward; the einsum layer none. Every variant is timed;
7. the training CLI on the card at full width (``cli.train.main``, its defaults: dim 256, depth
   4, frame stack 4, bf16) on FakeInsertion with 8 envs in process workers (``--subproc True``),
   rollout 1024 and 2 epochs of minibatch 512: two iterations in joint mode, one with
   ``--separate_optimizer True``, one with ``--representation False``; then the joint model is
   saved and a fresh ``main`` resumes from the file: before it learns, its step count,
   parameters and Adam moments equal the saved ones and lie on the card. Every train() must
   launch the kernel counts of its mode. Cut from the reference workload as in phase 5: the
   rollout (1024 of 32768 samples) and the epochs (2 of 10). The checkpoint is written under
   ``smoke_checkpoints/`` (gitignored) and removed at the end.
8. the SAC+MAE slice at full width (the SAC CLI's model: dim 256, depth 4, 4 heads x 64, mlp 512,
   frame stack 4, 192 tokens, 10 kept, decoder depth 3; batch 256, MAE batch 256): (a) one f32
   gradient step in separate and in joint mode on the card against the same weights, batch,
   masks and noise on the CPU, at batch 32 (losses, ent_coef, every Adam's gradient and all
   five parameter groups, to SAC_F32_TOL); (b) SACMAE.learn in bf16 on FakeInsertion with 4
   in-process envs, learning_starts 512, gradient_steps 4 and a 20,000-transition ring, on the
   host ReplayBuffer and on DeviceReplayBuffer (fused train_steps), in both modes: finite losses,
   moved parameters, the target moved by tau toward the critic, and every train_steps() and
   every policy action held to its attention launches (SAC_LAUNCHES); gradient steps/s and
   env-steps/s are printed; (c) cli.train_sacmae.main at its defaults for 64 gradient steps,
   then a save and a load into a fresh model: step count, parameters and the four Adams'
   moments equal on the card. Cut from the reference workload: the ring (20,000 of 1,000,000
   transitions), learning_starts (512 of 10,000), total_timesteps (a few hundred of 3,000,000)
   and, for speed, 4 envs where the CLI's default is 1; widths, depth, tokens and batches are
   full.
9. the SSL pretraining slice at full width (config/experiment/mae_vit.yaml: ViT-small, dim 384,
   12 layers of 6 heads x 64, 196 patches of 16 on 224 x 224 x 6, mask 0.75 so 49 kept; the
   masked-query decoder, 8 cross-attention blocks at 512 wide; f32; batch 64): (a) one f32 step
   of the MAEModule on the card against the same weights, batch and masking noise on the CPU,
   at batch 8 (SSL_F32_TOL); (b) ``cli.pretrain.main`` at the config's defaults on 197 synthetic
   frames (192 windows at stride 5: 3 steps an epoch) for 2 epochs: finite losses, and every
   Trainer step launches exactly 12 forward and 12 backward packed kernels on the 3xTF32
   bodies; steps/s and images/s are printed, the first step excluded; (c) a fresh ``main`` with
   3 epochs resumes: before it fits, global_step 6, epoch 2, the parameters and AdamW's moments
   equal the saved ones on the card; (d) the bf16 encoder: 12 + 12 launches a step, all on the
   tensor cores; (e) the He-style decoder: 20 + 20 launches a step (Dh 32 at N=196 in the
   decoder); (f) one full-image forward of the encoder (N=196): 12 launches, against the CPU,
   then timed.
   Cut from the reference workload: the data (197 random frames) and the epochs (2 of 200);
   widths, depth, tokens and the batch are full. Checkpoints go under ``smoke_checkpoints/``.
10. self-distillation and latent-prediction pretraining at full width through the same CLI and
   Trainer, f32, batch 64, on the packed pair with key masks (the 3xTF32 bodies): (a) one DINO
   step (config/experiment/dino_vit.yaml: ViT-small, 1 register token so N = 197, 1 global + 4
   local block masks, dino_out_dim 65536, the reconstruction probe) on the card against the same
   weights, batch, masks and temperature on the CPU at batch 8 (DISTILL_F32_TOL: the loss, the
   trainable gradients, the parameters after AdamW, the teachers after the EMA, the center); (b)
   ``cli.pretrain.main`` on dino_vit.yaml at its defaults, 197 frames, 2 epochs: finite losses and
   exactly 50 forward + 26 backward launches a step (36 + 24 with a key mask), all on the tf32x3
   bodies (DISTILL_LAUNCHES); (c) a resume: the teachers, the center, the student and AdamW's
   moments bit-equal on the card; (d) DINOv2 (dinov2_vit.yaml: 2 global + 4 local, centering,
   batch 64, no cut) and I-JEPA (ijepa_vit.yaml: no registers, predictor depth 6 at 384 wide,
   12 heads x 32, 4 target masks, N = 392 in the predictor) through the CLI for 2 epochs each, at
   their exact launch counts. Each run prints steps/s, images/s (first step excluded) and
   torch.cuda.max_memory_allocated. Cut as phase 9: the data and the epochs.

Phase 3 also holds both packed kernels to their plain versions at the SSL slices' shapes
(SSL_SHAPES: (64, 49, 6, 64), (64, 196, 6, 64), (64, 196, 16, 32), (64, 197, 6, 64), (64, 392,
12, 32), f32 and bf16, with and without a random key mask) and times them there and at the
training shape (512, 192, 4, 64); on each side of each body's whole-head limit (LENGTH_CASES,
B=2, H=4, with and without a key mask: a longer head streams in tiles, with the bits it would
have staged whole), timing bf16 and f32 at B=2, N=784, Dh=64 (3b); and under the key masks of
phase 10's paths (3c, DISTILL_MASKED: DINO's global block at (64, 197, 6, 64), its local blocks
at (256, 197, 6, 64), I-JEPA's cut context at (64, 392, 12, 32)), f32 and bf16, each timed
beside SDPA under the same mask, its bound counting only the kept keys. It prints err/tol for
each case.

Each phase after the kernel checks runs with the launch counts set to 0 just before it and read
just after; phases 4-8 also fail unless every bf16 forward launch, and in phases 5-8 every bf16
backward launch, took the tensor-core body; phases 9-10 hold every launch to its dtype's body
and count the launches with a key mask (``MASKED_LAUNCHES``).
The last lines are a {"kernels": [...]} JSON line, {"slice": ...}, {"train": ...},
{"bench_attention": ...}, {"cli": ...}, {"sac": ...}, {"ssl": ...} and {"ssl_distill": ...} JSON
lines, the card line as nvidia-smi prints it, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from m3l_tpu_torch import bench_attention
from m3l_tpu_torch.cli import pretrain as pretrain_cli
from m3l_tpu_torch.cli import train as train_cli
from m3l_tpu_torch.cli import train_sacmae as sac_cli_module
from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.kernels import BWD_BODY_LAUNCHES, FWD_BODY_LAUNCHES, LAUNCHES, MASKED_LAUNCHES, reset_launches
from m3l_tpu_torch.kernels.build import build_all
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import (
    BWD_KERNEL,
    KERNEL,
    V1_BWD_KERNEL,
    V1_KERNEL,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_bwd_tolerance,
    flash_attention_qkv,
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_bwd_tolerance,
    flash_attention_qkv_reference,
    flash_attention_qkv_tolerance,
    flash_attention_reference,
    flash_attention_tolerance,
)
from m3l_tpu_torch.profile_paths import random_minibatch
from m3l_tpu_torch.models import VTMAE, VTT, VTTConfig
from m3l_tpu_torch.rl import PPOMAE, SACMAE, MAEFeatures, SACActorCritic
from m3l_tpu_torch.serve import PolicyServer, build_policy, random_obs
from m3l_tpu_torch.ssl import MAEModule, sample_block_masks, sample_block_masks_constrained
from m3l_tpu_torch.ssl.ijepa import cut_context
from m3l_tpu_torch.train import Trainer, load_checkpoint
from m3l_tpu_torch.utils.config import instantiate, load_config

# H100 SXM data sheet: HBM rate and dense peak rates per compute type. f32 runs in 3xTF32 (three
# TF32 tensor-core products for each f32 one), so its least time is 3 x FLOP over the 495 TFLOP/s
# of TF32; the 67 TFLOP/s of f32 FMA is no bound for it.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}

# The kernels against their plain versions: the elementwise bounds of
# flash_attention_qkv_tolerance (f32 1e-5; bf16 one ulp of the output plus one ulp of each
# probability times |v|) and flash_attention_qkv_bwd_tolerance (f32 2e-5; bf16 one ulp of dqkv
# plus the worst-case f32 summation term).
# The policy on the card against the same weights in f32 on the CPU, absolute on actions and
# values; the compared magnitudes are printed beside it (|action| max ~9e-2, median ~3e-2;
# |value| ~1.1e-2 on the H100). bf16: about 3x the largest error these seeds gave on the H100
# (actions 1.668e-3, values 8.817e-4), which is bf16 rounding through five layers and so a
# coarse check. f32 (TF32 off): the same arithmetic in another summation order, about 12x
# the largest error these seeds gave on the H100 (actions 8.196e-8, values 5.774e-8), so a
# layer that computes something else on the card (vt_load, EarlyCNN, LayerNorm, pooling, the
# kernel) shows far above it; tests/test_torch_policy.py shows that one key dropped from
# attention exceeds this bound.
SLICE_TOL = 5e-3
SLICE_F32_TOL = 1e-6
# One f32 minibatch update on the card against the CPU (TF32 off): each loss relative to its
# magnitude, the flat pre-clip gradient relative to its norm, and the updated parameters
# relative to the learning rate. About 10x the largest values these seeds gave on the H100
# (1.936e-7, 1.522e-7, 2.980e-4: the same f32 arithmetic in another summation order; Adam's
# first step is ~lr * sign(g), so a parameter differs only where its gradient is near zero).
# tests/test_torch_train_phase.py shows that one key dropped from every attention layer
# exceeds all three.
TRAIN_F32_TOL = dict(loss_rel=2e-6, grad_rel=2e-6, param_per_lr=3e-3)

FRAME_STACK = 4
ACTION_DIM = 3
SERVE_B, SERVE_N, SERVE_H, SERVE_DH = 512, 192, 4, 64  # attention at the batch-512 forward
TRAIN_N_KEPT = 10  # the MAE encoder's tokens at mask ratio 0.95
TRAIN_ENVS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_EPOCHS, CHECK_BATCH = 8, 128, 512, 2, 64
TRAIN_TIMED_UPDATES = 5
# the packed attention of the SSL slices at batch 64: MAE's masked encoder (49 of 196 patches kept),
# the full-image encoder, and the He-style decoder (512 wide, 16 heads); DINO's global view (196
# patches + 1 register) and the I-JEPA predictor (196 context + 196 mask tokens, 12 heads of 32)
SSL_SHAPES = [(64, 49, 6, 64), (64, 196, 6, 64), (64, 196, 16, 32), (64, 197, 6, 64), (64, 392, 12, 32)]
# the same kernels under the key masks the phase-10 paths give them (distill_mask): DINO's global
# view and its four local views at once, and the I-JEPA predictor's context
DISTILL_MASKED = [("global block", (64, 197, 6, 64)), ("local blocks", (256, 197, 6, 64)), ("context", (64, 392, 12, 32))]
TIMED_SHAPES = SSL_SHAPES + [(SERVE_B, SERVE_N, SERVE_H, SERVE_DH)]  # each timed in f32 and bf16
ALL_KERNELS = (KERNEL, BWD_KERNEL, V1_KERNEL, V1_BWD_KERNEL)
CKPT_DIR = Path(__file__).resolve().parent / "smoke_checkpoints"


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def packed_qkv(b, n, h, dh, dtype, masked, seed):
    """qkv (B, N, 3HDh), a cotangent g (B, N, HDh) and an optional key mask, from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device="cuda").to(dtype)
    cot = torch.randn(b, n, h * dh, generator=g, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = torch.rand(b, n, generator=g, device="cuda") > 0.3
        mask[:, 0] = True
    return qkv, cot, mask


def distill_mask(kind: str, b: int, seed: int) -> torch.Tensor:
    """A key mask of the phase-10 paths on the 14 x 14 patch grid, drawn by the port's samplers:
    "global block", the register key and one global block avoiding four local ones (DINO, (B,
    197)); "local blocks", the register key and local blocks, 4 per sample (B / 4 samples); and
    "context", the I-JEPA context block cut by four target blocks, then 196 visible mask tokens
    (the predictor, (B, 392))."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    grid, ones = (14, 14), torch.ones(b, 1, dtype=torch.bool, device="cuda")
    if kind == "global block":
        local = sample_block_masks(g, b, grid, (0.2, 0.8), 4)
        return torch.cat([ones, sample_block_masks_constrained(g, b, grid, (0.2, 0.8), 1, local.any(0), 4)[0]], dim=1)
    if kind == "local blocks":
        return torch.cat([ones, sample_block_masks(g, b // 4, grid, (0.2, 0.8), 4).reshape(b, 196)], dim=1)
    tgt = sample_block_masks(g, b, grid, (0.15, 0.2), 4)
    ctx = cut_context(sample_block_masks(g, b, grid, (0.85, 1.0), 1)[0], tgt)
    return torch.cat([ctx, ones.expand(b, 196)], dim=1)


def check_distill_masks() -> dict:
    """Both packed kernels against their plain versions under the phase-10 key masks, f32 and
    bf16; returns err/tol by case."""
    worst = {}
    for i, (kind, (b, n, h, dh)) in enumerate(DISTILL_MASKED):
        mask = distill_mask(kind, b, seed=i)
        for dtype in (torch.float32, torch.bfloat16):
            qkv, cot, _ = packed_qkv(b, n, h, dh, dtype, False, seed=200 + i)
            want = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
            for direction, counter in (("forward", FWD_BODY_LAUNCHES), ("backward", BWD_BODY_LAUNCHES)):
                bodies = Counter(counter)
                if direction == "forward":
                    out = flash_attention_qkv(qkv, h, key_mask=mask)
                    ref = flash_attention_qkv_reference(qkv, h, key_mask=mask)
                    tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
                else:
                    out = fa._launch_bwd(qkv, cot, h, fa._key_bias(mask), dh**-0.5)
                    ref = flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask)
                    tol = flash_attention_qkv_bwd_tolerance(qkv, cot, h, ref, key_mask=mask)
                torch.cuda.synchronize()
                body = ",".join((counter - bodies).elements())
                report(f"{direction} ({kind})", b, n, h, dh, dtype, kind, out, ref, tol, body)
                if body != want:
                    fail(f"{direction} ({kind}) {dtype} took the body {body!r}, expected {want!r}")
                worst[f"{direction} {kind} {str(dtype)[6:]}"] = ((out.float() - ref.float()).abs() / tol).max().item()
    return worst


def report(kind, b, n, h, dh, dtype, masked, out, ref, tol, body="") -> float:
    """Print one kernel-vs-plain case; fail if an element is outside its bound. Returns max err."""
    if out.shape != ref.shape or out.dtype != dtype or not torch.isfinite(out).all():
        fail(f"{kind} output malformed at {(b, n, h, dh, dtype)}")
    diff = (out.float() - ref.float()).abs()
    err, ratio = diff.max().item(), (diff / tol).max().item()
    ref_max = ref.float().abs().max().item()
    ok = ratio <= 1.0
    print(f"  {kind} B={b} N={n} H={h} Dh={dh} {str(dtype)[6:]} mask={masked}: max_abs_err={err:.3e} "
          f"max|ref|={ref_max:.3e} rel_err={err / ref_max:.3e} tol in [{tol.min().item():.3e}, {tol.max().item():.3e}] "
          f"max err/tol={ratio:.3f}{' body=' + body if body else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{kind} kernel disagrees with its plain version at {(b, n, h, dh, dtype, masked)}")
    return err


def split_heads(qkv, cot, h):
    """Packed qkv (B, N, 3HDh) and cotangent (B, N, HDh) -> contiguous q, k, v and g (B, N, H, Dh)."""
    b, n, thd = qkv.shape
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, thd // (3 * h)).unbind(2))
    return q, k, v, cot.view(b, n, h, thd // (3 * h))


def check_attention() -> dict:
    """Every kernel against its plain version at every listed shape; returns the max abs errors
    at the training shape (B=512, N=192, bf16, no mask) keyed by kernel."""
    fwd = [(b, n, 4, 64) for b in (8, 512) for n in (10, 192)] + [(64, 196, 16, 64)]
    bwd = [(512, 192, 4, 64), (512, TRAIN_N_KEPT, 4, 64), (8, 192, 4, 64), (64, 196, 16, 64)]
    errs = {}
    for kind, shapes in (("forward", fwd + SSL_SHAPES), ("backward", bwd + SSL_SHAPES), ("v1 forward", bwd), ("v1 backward", bwd)):
        cases = [(s, dt, m) for s in shapes for dt in (torch.bfloat16, torch.float32) for m in (False, True)]
        for i, ((b, n, h, dh), dtype, masked) in enumerate(cases):
            qkv, cot, mask = packed_qkv(b, n, h, dh, dtype, masked, seed=i)
            counter = FWD_BODY_LAUNCHES if "forward" in kind else BWD_BODY_LAUNCHES
            bodies = Counter(counter)
            if kind == "forward":
                out = flash_attention_qkv(qkv, h, key_mask=mask)
                ref = flash_attention_qkv_reference(qkv, h, key_mask=mask)
                tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
            elif kind == "backward":
                out = fa._launch_bwd(qkv, cot, h, None if mask is None else fa._key_bias(mask), dh**-0.5)
                ref = flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask)
                tol = flash_attention_qkv_bwd_tolerance(qkv, cot, h, ref, key_mask=mask)
            elif kind == "v1 forward":
                q, k, v, _ = split_heads(qkv, cot, h)
                out = flash_attention(q, k, v, key_mask=mask)
                ref = flash_attention_reference(q, k, v, key_mask=mask)
                tol = flash_attention_tolerance(q, k, v, ref, key_mask=mask)
            else:  # the backward kernel on the collapsed operands, as flash_attention's backward calls it
                q, k, v, g = split_heads(qkv, cot, h)
                bias = None if mask is None else fa._key_bias(fa._v1_mask(mask, h))
                grads = fa._launch_v1_bwd(*(fa._collapse(t) for t in (q, k, v, g)), bias, dh**-0.5)
                out = torch.cat([fa._uncollapse(t, h) for t in grads], dim=-1)
                refs = flash_attention_bwd_reference(q, k, v, g, key_mask=mask)
                ref = torch.cat(refs, dim=-1)
                tol = torch.cat(flash_attention_bwd_tolerance(q, k, v, g, refs, key_mask=mask), dim=-1)
            torch.cuda.synchronize()
            body = ",".join((counter - bodies).elements())
            err = report(kind, b, n, h, dh, dtype, masked, out, ref, tol, body)
            want = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
            if body != want:
                fail(f"{kind} at {(b, n, h, dh, dtype, masked)} took the body {body!r}, expected {want!r}")
            if (b, n, h, dh, dtype, masked) == (SERVE_B, SERVE_N, SERVE_H, SERVE_DH, torch.bfloat16, False):
                errs[kind] = err
    return errs


# The longest head each body stages whole (in one tile) and one more, per dtype and head dim: the
# bf16 backward (and the old CUDA-core passes' limit, which took longer bf16 heads), the bf16
# forward, the f32 backward and the f32 forward (at Dh 128 both f32 limits are 208). Each runs
# forward and backward at B=2, H=4.
LENGTH_CASES = {
    (torch.bfloat16, 64): (384, 385, 406, 407, 784, 785),
    (torch.bfloat16, 128): (208, 209, 253, 254, 416, 417),
    (torch.float32, 64): (400, 401, 416, 417),
    (torch.float32, 128): (208, 209),
}
LONG_N = 784  # 8 frames at tubelet 2 on a 14 x 14 patch grid: timed in bf16 and f32


def check_lengths() -> dict:
    """Both packed kernels against their plain versions on each side of each whole-head limit,
    with and without a key mask; fails on a disagreement or a body other than its dtype's. Returns
    the largest err/tol per direction and dtype."""
    worst = {}
    for (dtype, dh), ns in LENGTH_CASES.items():
        for n in ns:
            for masked in (False, True):
                qkv, cot, mask = packed_qkv(2, n, 4, dh, dtype, masked, seed=n)
                want = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
                for kind, counter in (("forward", FWD_BODY_LAUNCHES), ("backward", BWD_BODY_LAUNCHES)):
                    bodies = Counter(counter)
                    if kind == "forward":
                        out = flash_attention_qkv(qkv, 4, key_mask=mask)
                        ref = flash_attention_qkv_reference(qkv, 4, key_mask=mask)
                        tol = flash_attention_qkv_tolerance(qkv, 4, ref, key_mask=mask)
                    else:
                        out = fa._launch_bwd(qkv, cot, 4, None if mask is None else fa._key_bias(mask), dh**-0.5)
                        ref = flash_attention_qkv_bwd_reference(qkv, cot, 4, key_mask=mask)
                        tol = flash_attention_qkv_bwd_tolerance(qkv, cot, 4, ref, key_mask=mask)
                    torch.cuda.synchronize()
                    body = ",".join((counter - bodies).elements())
                    report(f"{kind} length", 2, n, 4, dh, dtype, masked, out, ref, tol, body)
                    if body != want:
                        fail(f"{kind} at N={n} Dh={dh} {dtype} took the body {body!r}, expected {want!r}")
                    key = f"{kind} {str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), ((out.float() - ref.float()).abs() / tol).max().item())
    return worst


def tensor_core_only(where: str) -> dict:
    """The forward and backward launches per body since the counts were last set to 0; fails
    unless every one took the bf16 body (the paths that call this run bf16)."""
    out = {}
    for name, counter, kernels in (("fwd", FWD_BODY_LAUNCHES, (KERNEL, V1_KERNEL)), ("bwd", BWD_BODY_LAUNCHES, (BWD_KERNEL, V1_BWD_KERNEL))):
        bodies = out[name] = dict(counter)
        if set(bodies) - {"tensor_core"} or bodies.get("tensor_core", 0) != sum(LAUNCHES[k] for k in kernels):
            fail(f"{where}: {name} launches by body {bodies}, expected all {dict(LAUNCHES)} on the tensor cores")
    return out


def bound(nbytes: int, flops: int, dtype) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes, flops=flops)


def mask_cost(b: int, n: int, mask) -> tuple[int, int]:
    """(bytes of the f32 key bias, query-key pairs the function needs per head): a masked key
    needs no product."""
    if mask is None:
        return 0, b * n * n
    return 4 * b * n, n * int(mask.sum().item())


def time_attention(b, n, h, dh, dtype, split=False, mask=None) -> dict:
    """The forward kernel, packed (``split`` False) or split-head on the collapsed operands; with
    ``mask`` (packed only), under that key mask (SDPA takes it as a boolean attention mask)."""
    qkv, _, _ = packed_qkv(b, n, h, dh, dtype, False, seed=100)
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4))  # (B, H, N, Dh)
    if split:
        cq, ck, cv = (t.view(b * h, n, dh) for t in (q, k, v))
        ms = cuda_ms(lambda: fa._launch_v1(cq, ck, cv, None, dh**-0.5))
        plain_ms = cuda_ms(lambda: fa._v1_fwd_plain(cq, ck, cv, None, dh**-0.5))
    else:
        ms = cuda_ms(lambda: flash_attention_qkv(qkv, h, key_mask=mask))
        plain_ms = cuda_ms(lambda: flash_attention_qkv_reference(qkv, h, key_mask=mask))
    attn_mask = None if mask is None else mask[:, None, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask))
    elem = qkv.element_size()
    mask_bytes, pairs = mask_cost(b, n, mask)
    # q, k, v (and the key bias) read once, output written once; QK^T and AV over the kept keys
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **bound(qkv.numel() * elem + b * n * h * dh * elem + mask_bytes, 4 * h * pairs * dh, dtype))


def time_attention_bwd(b, n, h, dh, dtype, split=False, mask=None) -> dict:
    """The backward kernel, packed (``split`` False) or split-head on the collapsed operands; with
    ``mask`` (packed only), under that key mask."""
    qkv, cot, _ = packed_qkv(b, n, h, dh, dtype, False, seed=101)
    scale = dh**-0.5
    g = cot.view(b, n, h, dh).permute(0, 2, 1, 3).contiguous()  # (B, H, N, Dh)
    if split:
        cq, ck, cv = (t.contiguous().view(b * h, n, dh) for t in qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4))
        cg = g.view(b * h, n, dh)
        ms = cuda_ms(lambda: fa._launch_v1_bwd(cq, ck, cv, cg, None, scale))
        plain_ms = cuda_ms(lambda: fa._v1_bwd_plain(cq, ck, cv, cg, None, scale))
    else:
        bias = None if mask is None else fa._key_bias(mask)
        ms = cuda_ms(lambda: fa._launch_bwd(qkv, cot, h, bias, scale))
        plain_ms = cuda_ms(lambda: flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask))
    # the library yardstick: SDPA's backward through autograd, on the same q, k, v and cotangent
    q, k, v = (t.contiguous().requires_grad_(True) for t in qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4))
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=None if mask is None else mask[:, None, None, :])
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True))
    elem = qkv.element_size()
    mask_bytes, pairs = mask_cost(b, n, mask)
    # q, k, v, g (and the key bias) read once, dq, dk, dv written once; S, dV, dA, dQ, dK over the kept keys
    nbytes = (2 * qkv.numel() + cot.numel()) * elem + mask_bytes
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound(nbytes, 10 * h * pairs * dh, dtype))


def serve_slice() -> dict:
    torch.manual_seed(0)
    policy = build_policy(dtype=torch.bfloat16, device="cuda")  # full width, frame stack 4
    bounds = dict(action_low=[-1.0] * ACTION_DIM, action_high=[1.0] * ACTION_DIM)
    server = PolicyServer(policy, **bounds)
    rng = np.random.default_rng(0)
    small = [random_obs(rng, 8, FRAME_STACK) for _ in range(8)]
    large = random_obs(rng, 512, FRAME_STACK)

    reset_launches()
    forwards = 0
    server(small[0])  # warm-up: cuBLAS/cuDNN handles and algorithm choice
    forwards += 1
    latencies, actions = [], []
    for obs in small:
        t0 = time.perf_counter()
        actions.append(server(obs))  # returns host numpy: the request's end is synchronous
        latencies.append(time.perf_counter() - t0)
        forwards += 1
    server(large)
    forwards += 1
    t0 = time.perf_counter()
    large_actions = server(large)
    t_large = time.perf_counter() - t0
    forwards += 1
    launches = LAUNCHES[KERNEL]
    if launches != 5 * forwards or any(LAUNCHES[k] for k in (BWD_KERNEL, V1_KERNEL, V1_BWD_KERNEL)):
        fail(f"serving launched the attention kernels {dict(LAUNCHES)} in {forwards} forwards, expected 5 forward launches per forward")
    bodies = tensor_core_only("serving")

    if large_actions.shape != (512, ACTION_DIM) or not np.isfinite(large_actions).all():
        fail("batch-512 actions malformed")
    for got in actions:
        if got.shape != (8, ACTION_DIM) or not np.isfinite(got).all():
            fail("batch-8 actions malformed")

    def twin(dtype, device):
        p = build_policy(dtype=dtype, device=device)
        p.load_state_dict(policy.state_dict())
        return PolicyServer(p, **bounds)

    cpu = outputs(twin(torch.float32, "cpu"), small)
    ref_act, ref_val = np.abs(cpu[0]), np.abs(cpu[1])
    scale = dict(action_abs_max=float(ref_act.max()), action_abs_median=float(np.median(ref_act)),
                 value_abs_max=float(ref_val.max()), value_abs_median=float(np.median(ref_val)))
    print(f"  slice: batch-8 reference, f32 on the CPU: |action| max {scale['action_abs_max']:.3e}, median "
          f"{scale['action_abs_median']:.3e}; |value| max {scale['value_abs_max']:.3e}, median {scale['value_abs_median']:.3e}")
    errs = {}
    for name, srv, tol in (("bf16", server, SLICE_TOL), ("f32", twin(torch.float32, "cuda"), SLICE_F32_TOL)):
        got = outputs(srv, small)
        act_err, val_err = (float(np.abs(g - r).max()) for g, r in zip(got, cpu))
        errs[f"{name}_actions_max_abs_err"], errs[f"{name}_values_max_abs_err"] = act_err, val_err
        print(f"  slice: batch-8 {name} on the card vs f32 on the CPU: actions max_abs_err={act_err:.3e}, "
              f"values max_abs_err={val_err:.3e}; tol {tol:.0e}")
        if not (act_err <= tol and val_err <= tol):
            fail(f"{name} policy on the card disagrees with the f32 plain path on the CPU")
    lat_ms = [t * 1e3 for t in latencies]
    return dict(
        batch8_latency_ms_p50=statistics.median(lat_ms), batch8_latency_ms=lat_ms,
        batch512_ms=t_large * 1e3, batch512_obs_frames_per_s=512 * FRAME_STACK / t_large,
        forwards=forwards, attention_launches=launches, bodies=bodies, **errs, **scale,
    )


def outputs(server: PolicyServer, batches: list) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic actions and values of ``server`` on each batch, concatenated."""
    acts, vals = [], []
    for obs in batches:
        acts.append(server(obs))
        with torch.inference_mode():
            vals.append(server.policy.predict_values(server.to_device(obs)).float().cpu().numpy())
    return np.concatenate(acts), np.concatenate(vals)


def train_env() -> SyncVecEnv:
    return SyncVecEnv([make_env("FakeInsertion", i, seed=0, frame_stack=FRAME_STACK) for i in range(TRAIN_ENVS)])


def update_once(model: PPOMAE, mb: dict, mask) -> tuple[dict, torch.Tensor]:
    """One minibatch update on the whole of ``mb``; returns its metrics and the flat pre-clip
    gradient."""
    n = mb["advantages"].shape[0]
    idx = torch.arange(n, device=model.device)
    mask = type(mask)(*(t.to(model.device) for t in mask))
    metrics = model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], mask)
    return {k: float(v) for k, v in metrics.items()}, model.optimizer.flat_grad()


def update_errors(a: PPOMAE, b: PPOMAE, batch: int, seed: int = 0) -> dict:
    """One minibatch update of ``a`` and ``b`` (same weights, same batch and mask): the largest
    loss difference relative to the loss, the gradient difference relative to the gradient's
    norm, and the largest parameter difference after the step relative to the learning rate."""
    mask = b.policy.features.mae.sample_mask(torch.Generator().manual_seed(seed), batch)
    results = [update_once(m, random_minibatch(np.random.default_rng(seed), batch, m.device), mask) for m in (a, b)]
    (ma, ga), (mb_, gb) = results
    loss_rel = max(abs(ma[k] - mb_[k]) / max(abs(mb_[k]), 1e-30) for k in ma)
    grad_rel = ((ga.cpu() - gb.cpu()).norm() / gb.cpu().norm()).item()
    pa, pb = (torch.cat([p.detach().cpu().reshape(-1) for p in m.policy.parameters()]) for m in (a, b))
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, param_per_lr=((pa - pb).abs().max() / a.optimizer.learning_rate).item(),
                losses=mb_, grad_norm=gb.norm().item())


def train_slice() -> dict:
    lr = 1e-4
    # (a) one f32 update at full width, card vs CPU
    torch.manual_seed(1)
    policy = build_policy(dtype=torch.float32, device="cuda")
    twin = build_policy(dtype=torch.float32, device="cpu")
    twin.load_state_dict(policy.state_dict())
    kw = dict(learning_rate=lr, n_steps=CHECK_BATCH // TRAIN_ENVS, batch_size=CHECK_BATCH, frame_stack=FRAME_STACK)
    t0 = time.perf_counter()
    errs = update_errors(PPOMAE(policy, train_env(), device="cuda", **kw), PPOMAE(twin, train_env(), device="cpu", **kw), CHECK_BATCH)
    print(f"  train: one f32 update at minibatch {CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): "
          f"loss rel err {errs['loss_rel']:.3e}, grad err/|grad| {errs['grad_rel']:.3e} (|grad| {errs['grad_norm']:.3e}), "
          f"param err/lr {errs['param_per_lr']:.3e}; tol {TRAIN_F32_TOL}; losses {errs['losses']}")
    if any(errs[k] > TRAIN_F32_TOL[k] for k in TRAIN_F32_TOL):
        fail("the f32 minibatch update on the card disagrees with the CPU")

    # (b) two learn iterations in bf16 on FakeInsertion
    torch.manual_seed(2)
    policy = build_policy(dtype=torch.bfloat16, device="cuda")
    before = [p.detach().clone() for p in policy.parameters()]
    model = PPOMAE(policy, train_env(), learning_rate=lr, n_steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                   n_epochs=TRAIN_EPOCHS, frame_stack=FRAME_STACK, seed=0, device="cuda", verbose=1)
    updates = TRAIN_EPOCHS * model.n_minibatches
    per_train = []
    train = model.train

    def counted_train():
        start = dict(LAUNCHES)
        metrics = train()
        per_train.append({k: LAUNCHES[k] - start.get(k, 0) for k in (KERNEL, BWD_KERNEL)})
        return metrics

    model.train = counted_train
    reset_launches()
    model.learn(total_timesteps=2 * TRAIN_STEPS * TRAIN_ENVS)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in (KERNEL, BWD_KERNEL)}
    learn_bodies = tensor_core_only("bf16 learn")
    if LAUNCHES[V1_KERNEL] or LAUNCHES[V1_BWD_KERNEL]:
        fail(f"training launched the split-head kernels: {dict(LAUNCHES)}")
    for i, counts in enumerate(per_train):
        if counts != {KERNEL: 12 * updates + 5, BWD_KERNEL: 12 * updates}:
            fail(f"train() {i} launched {counts}, expected {12 * updates + 5} forward and {12 * updates} backward")
    metrics = model.last_metrics
    if model.iteration != 2 or not all(np.isfinite(metrics[k]) for k in metrics if k != "explained_variance"):
        fail(f"bf16 learn did not finish two iterations with finite losses: {metrics}")
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(policy.parameters(), before))
    if not moved > 0 or not all(torch.isfinite(p).all() for p in policy.parameters()):
        fail("bf16 learn left the parameters unmoved or not finite")

    # milliseconds per minibatch update, synchronised, after one warm-up update
    mb = random_minibatch(np.random.default_rng(3), TRAIN_BATCH, model.device)
    idx = torch.arange(TRAIN_BATCH, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(3)
    masks = [model.policy.features.mae.sample_mask(gen, TRAIN_BATCH) for _ in range(TRAIN_TIMED_UPDATES + 1)]
    reset_launches()
    model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], masks[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in masks[1:]:
        model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], m)
    torch.cuda.synchronize()
    update_s = (time.perf_counter() - t0) / TRAIN_TIMED_UPDATES
    tensor_core_only("timed bf16 updates")
    return dict(
        f32_check=dict(errs, tol=TRAIN_F32_TOL, minibatch=CHECK_BATCH),
        iterations=[dict(collect_s=s["collect"], train_s=s["train"]) for s in model.iteration_seconds],
        updates_per_train=updates, launches=launches, launches_per_train=per_train, bodies=learn_bodies,
        update_ms=update_s * 1e3, update_obs_frames_per_s=TRAIN_BATCH * FRAME_STACK / update_s,
        last_metrics=metrics, max_param_move=moved,
    )


def bench_phase() -> dict:
    """The attention-layer bench at its full shape: v1 and v2 agree bit for bit, each timed call
    launches only its own kernels (one forward and one backward per step)."""
    params, x = bench_attention.make_inputs(device="cuda")
    reset_launches()
    loss1, grads1 = bench_attention.loss_and_grads("v1", params, x)
    loss2, grads2 = bench_attention.loss_and_grads("v2", params, x)
    torch.cuda.synchronize()
    if not (torch.equal(loss1, loss2) and all(torch.equal(a, b) for a, b in zip(grads1, grads2))):
        fail(f"the v1 and v2 layers disagree: loss {loss1.item()} vs {loss2.item()}, max grad diff "
             f"{max((a - b).abs().max().item() for a, b in zip(grads1, grads2))}")
    print(f"  v1 and v2 layers: loss {loss1.item():.6e} and gradients equal bit for bit")
    own = {"v2": (KERNEL, BWD_KERNEL), "v1": (V1_KERNEL, V1_BWD_KERNEL), "einsum": ()}
    out = dict(loss=loss1.item(), v1_equals_v2=True, inner=bench_attention.INNER)
    for name in bench_attention.VARIANTS:
        reset_launches()
        ms, timed = bench_attention.time_variant(name, [p.clone() for p in params], x)
        path = {k: LAUNCHES[k] for k in ALL_KERNELS if LAUNCHES[k]}
        bodies = tensor_core_only(f"bench {name}")
        want = {k: bench_attention.INNER for k in own[name]}
        if dict(timed) != want or path != {k: 2 * v for k, v in want.items()}:
            fail(f"{name} layer launched {dict(timed)} in its timed call and {path} in all, expected {want} per call")
        print(f"  {name + ' layer fwd+bwd':50s} {ms:8.3f} ms; launches per timed call {dict(timed)}")
        out[name] = dict(ms=ms, launches_timed_call=dict(timed), launches=path, bodies=bodies)
    return out


def cli_phase() -> dict:
    """``cli.train.main`` on the card at full width in each mode, then a resume from a saved
    model; every train() is held to its mode's launch counts."""
    base = ["--env", "FakeInsertion", "--n_envs", str(TRAIN_ENVS), "--rollout_length", str(TRAIN_STEPS * TRAIN_ENVS),
            "--ppo_epochs", str(TRAIN_EPOCHS), "--batch_size", str(TRAIN_BATCH), "--subproc", "True", "--seed", "0"]
    updates = TRAIN_EPOCHS * TRAIN_STEPS * TRAIN_ENVS // TRAIN_BATCH
    chunks = TRAIN_BATCH // 32  # the CLI's --mae_batch_size
    # attention layers per update, forward and backward: joint 12 (4 encoder twice, 3 decoder, 1
    # post); separate 7 per MAE chunk (4 encoder on the kept tokens, 3 decoder) plus 5 (4 encoder,
    # 1 post) for PPO; plain PPO 5; train() adds 5 forward for the last values
    layers = {"joint": 12, "separate": 7 * chunks + 5, "plain": 5}
    per_train, entries = [], []
    train, learn = PPOMAE.train, PPOMAE.learn

    def counted_train(self):
        start = Counter(LAUNCHES)
        metrics = train(self)
        per_train.append({k: LAUNCHES[k] - start[k] for k in ALL_KERNELS})
        return metrics

    def recorded_learn(self, *args, **kwargs):  # the model as main() hands it to learn()
        entries.append(dict(steps=self.num_timesteps, params=[p.detach().clone() for p in self.policy.parameters()],
                            mu=self.optimizer.mu.clone(), nu=self.optimizer.nu.clone(), count=self.optimizer.count))
        return learn(self, *args, **kwargs)

    def run(mode, argv, iterations):
        per_train.clear()
        reset_launches()
        t0 = time.perf_counter()
        model = train_cli.main(base + argv)
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        u, expect = model.n_epochs * model.n_minibatches, layers[mode]
        want = {KERNEL: expect * u + 5, BWD_KERNEL: expect * u, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
        if u != updates or len(per_train) != iterations or any(c != want for c in per_train):
            fail(f"{mode}: {len(per_train)} train() calls launched {per_train}, expected {iterations} of {want}")
        bodies = tensor_core_only(f"cli {mode}")
        m = model.last_metrics
        before = entries[-1]["params"]
        moved = max((p.detach() - b).abs().max().item() for p, b in zip(model.policy.parameters(), before))
        finite = all(np.isfinite(m[k]) for k in m if k != "explained_variance") and all(torch.isfinite(p).all() for p in model.policy.parameters())
        if model.iteration != iterations or not finite or not moved > 0 or (m["mae_loss"] == 0) != (mode == "plain"):
            fail(f"{mode}: {model.iteration} iterations, metrics {m}, max parameter move {moved}")
        its = [dict(collect_s=t["collect"], train_s=t["train"]) for t in model.iteration_seconds]
        split = "; ".join(f"collect {i['collect_s']:.2f} s, train {i['train_s']:.2f} s" for i in its)
        print(f"  {mode}: {split}; main() {seconds:.1f} s; launches per train() {per_train[0]}")
        return model, dict(iterations=its, main_s=seconds, launches_per_train=list(per_train), updates_per_train=u,
                           launches={k: LAUNCHES[k] for k in ALL_KERNELS}, bodies=bodies, last_metrics=m, max_param_move=moved)

    out = {}
    steps = TRAIN_STEPS * TRAIN_ENVS
    PPOMAE.train, PPOMAE.learn = counted_train, recorded_learn
    try:
        joint, out["joint"] = run("joint", ["--total_timesteps", str(2 * steps)], 2)
        out["separate"] = run("separate", ["--total_timesteps", str(steps), "--separate_optimizer", "True"], 1)[1]
        out["plain"] = run("plain", ["--total_timesteps", str(steps), "--representation", "False"], 1)[1]
        CKPT_DIR.mkdir(exist_ok=True)
        path = str(CKPT_DIR / "joint.ckpt")
        joint.save(path)
        saved = dict(steps=joint.num_timesteps, params=[p.detach().clone() for p in joint.policy.parameters()],
                     mu=joint.optimizer.mu.clone(), nu=joint.optimizer.nu.clone(), count=joint.optimizer.count)
        del joint
        resumed, out["resume"] = run("joint", ["--total_timesteps", str(3 * steps), "--resume_from", path], 1)
    finally:
        PPOMAE.train, PPOMAE.learn = train, learn
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    got = entries[-1]
    on_card = all(t.device.type == "cuda" for t in (*got["params"], got["mu"], got["nu"]))
    same = (got["steps"] == saved["steps"] and got["count"] == saved["count"] and torch.equal(got["mu"], saved["mu"])
            and torch.equal(got["nu"], saved["nu"]) and all(torch.equal(a, b) for a, b in zip(got["params"], saved["params"])))
    if not (on_card and same and resumed.num_timesteps == 3 * steps):
        fail(f"resume: restored {got['steps']} steps (saved {saved['steps']}), state equal {same}, on the card {on_card}, "
             f"ended at {resumed.num_timesteps}")
    print(f"  resume: restored {got['steps']} steps, Adam count {got['count']}; parameters and moments equal the saved ones on the card")
    out["resume"].update(restored_steps=got["steps"], restored_equal=same, restored_on_card=on_card)
    return out


SAC_CHECK_BATCH, SAC_BATCH, SAC_ENVS, SAC_STARTS, SAC_GRAD_STEPS, SAC_RING, SAC_TRAIN_EVENTS = 32, 256, 4, 512, 4, 20_000, 8
# attention launches per SAC gradient step (forward, backward). Separate: the MAE on one chunk of
# the batch (4 encoder layers on the kept tokens, 3 decoder) and the features of x and of x_next
# (4 encoder + 1 post each, no gradient). Joint: the features of x with their gradient and the
# MAE loss in one pass (5 + 7), then x and x_next as above. Every policy action after
# learning_starts adds 5 forwards.
SAC_LAUNCHES = {"separate": (17, 7), "joint": (22, 12)}
# One f32 SAC step at full width, card vs CPU (TF32 off), the same weights, batch, masks and noise:
# each metric relative to its magnitude, each Adam's gradient relative to its norm, and each
# parameter group after the step relative to the learning rate (3e-4), beyond the difference of
# Adam's steps lr * g / (|g| + eps) that the two gradients imply (an element whose gradient is a
# few eps from zero turns f32 noise into a large part of lr). About 10x the largest values these
# seeds gave on the H100 (6.540e-8; 2.504e-7; 1.981e-4, the MAE in joint mode, about one ulp of a
# parameter): the same f32 arithmetic in another summation order. tests/test_torch_sac_mae.py
# shows that one key dropped from every attention layer exceeds the first two; the third holds
# each side to Adam's step on its own gradient.
SAC_F32_TOL = dict(loss_rel=1e-6, grad_rel=3e-6, param_per_lr=2e-3)
SAC_GROUPS = ("mae", "actor", "critic", "target", "ent")


def sac_policy(dtype, device) -> SACActorCritic:
    """The SAC CLI's full-width model (``cli.train_sacmae.build_model``'s wiring) from torch's global
    generator: dim 256, depth 4, 4 heads x 64, mlp 512, frame stack 4, decoder depth 3."""
    c = VTTConfig(frame_stack=FRAME_STACK)
    mae = VTMAE(VTT(c, dtype=dtype), decoder_dim=c.dim, masking_ratio=0.95, decoder_depth=3, decoder_heads=4,
                early_conv_masking=True, dtype=dtype)
    return SACActorCritic(MAEFeatures(mae, c.dim, frame_stack=FRAME_STACK, dtype=dtype), c.dim, ACTION_DIM, dtype=dtype).to(device)


def sac_env(n=SAC_ENVS) -> SyncVecEnv:
    return SyncVecEnv([make_env("FakeInsertion", i, seed=0, frame_stack=FRAME_STACK) for i in range(n)])


def sac_group(name: str) -> str:
    if name.startswith("features.mae."):
        return "mae"
    for g in ("critic_target", "critic", "log_ent_coef"):
        if name.startswith(g):
            return {"critic_target": "target", "critic": "critic", "log_ent_coef": "ent"}[g]
    return "actor"


def sac_steps_taken(model: SACMAE) -> dict:
    """Per parameter name: (the gradient its Adam's single step took, that Adam's lr and eps). The
    separate MAE Adam comes last: the actor's Adam leaves the MAE at zero gradient there."""
    names = {id(p): n for n, p in model.policy.named_parameters()}
    out = {}
    for opt in (model.actor_optimizer, model.critic_optimizer, model.ent_optimizer, model.mae_optimizer):
        if opt is None or opt.count != 1:
            continue
        g, off = opt.mu / (1.0 - opt.b1), 0
        for p in opt.params:
            if names[id(p)] not in out or opt is model.mae_optimizer:
                out[names[id(p)]] = (g[off : off + p.numel()].view_as(p), opt.learning_rate, opt.eps)
            off += p.numel()
    return out


def sac_models(separate: bool, seed: int = 0) -> list:
    """The f32 full-width SACMAE on the card and on the CPU from the same weights, at batch
    SAC_CHECK_BATCH."""
    torch.manual_seed(seed)
    init = sac_policy(torch.float32, "cpu").state_dict()
    models = []
    for dev in ("cuda", "cpu"):
        p = sac_policy(torch.float32, dev)
        p.load_state_dict(init)
        models.append(SACMAE(p, sac_env(1), batch_size=SAC_CHECK_BATCH, mae_batch_size=SAC_CHECK_BATCH, separate_optimizer=separate,
                             frame_stack=FRAME_STACK, buffer_size=64, device=dev))
    return models


def sac_update_errors(a: SACMAE, b: SACMAE, seed: int = 0) -> dict:
    """One SAC+MAE step of ``a`` and ``b`` (same weights and settings) on the same batch, masks and
    noise, drawn from ``seed``: what SAC_F32_TOL bounds, ``a`` against ``b``."""
    bs, fs = b.batch_size, b.frame_stack
    rng = np.random.default_rng(seed)
    batch = {"obs": random_obs(rng, bs, fs), "next_obs": random_obs(rng, bs, fs),
             "actions": rng.uniform(-1, 1, (bs, ACTION_DIM)).astype(np.float32),
             "rewards": rng.normal(size=bs).astype(np.float32), "dones": (rng.random(bs) < 0.3).astype(np.float32)}
    gen = torch.Generator().manual_seed(seed)
    mask = b.policy.features.mae.sample_mask(gen, bs)
    noise = [torch.randn(bs, ACTION_DIM, generator=gen) for _ in range(2)]
    metrics = []
    for m in (a, b):
        put = lambda x: torch.from_numpy(x).to(m.device)  # noqa: E731
        tb = {k: {kk: put(vv) for kk, vv in v.items()} if isinstance(v, dict) else put(v) for k, v in batch.items()}
        out = m.update(tb, [type(mask)(*(t.to(m.device) for t in mask))], *(n.to(m.device) for n in noise))
        metrics.append({k: float(v) for k, v in out.items()})
    loss_rel = max(abs(metrics[0][k] - metrics[1][k]) / max(abs(metrics[1][k]), 1e-30) for k in metrics[1])
    grad_rel = {}
    for name in ("actor_optimizer", "critic_optimizer", "ent_optimizer", "mae_optimizer"):
        oa, ob = getattr(a, name), getattr(b, name)
        if ob is not None and ob.count:
            grad_rel[name] = ((oa.mu.cpu() - ob.mu).norm() / ob.mu.norm()).item()
    steps_a, steps_b = sac_steps_taken(a), sac_steps_taken(b)
    implied = {}
    for name, (g, lr, eps) in steps_b.items():
        ga = steps_a[name][0].cpu()
        implied[name] = lr * ((ga / (ga.abs() + eps)) - (g / (g.abs() + eps))).abs()
    lr = b.critic_optimizer.learning_rate
    param_per_lr = dict.fromkeys(SAC_GROUPS, 0.0)
    a_params = dict(a.policy.named_parameters())
    for name, p in b.policy.named_parameters():
        diff = (a_params[name].detach().cpu() - p.detach()).abs()
        if name in implied:
            diff = diff - implied[name]
        elif name.startswith("critic_target."):  # polyak: tau times the critic's step difference
            diff = diff - b.tau * implied["critic." + name[len("critic_target."):]]
        group = sac_group(name)
        param_per_lr[group] = max(param_per_lr[group], diff.max().item() / lr)
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, param_per_lr=param_per_lr, metrics=metrics[1],
                ent_coef=(metrics[0]["ent_coef"], metrics[1]["ent_coef"]))


def sac_learn(separate: bool, device_buffer: bool) -> dict:
    """SACMAE.learn in bf16 at full width on FakeInsertion: warm-up to learning_starts, then
    SAC_TRAIN_EVENTS train events of SAC_GRAD_STEPS gradient steps; every train_steps() call and
    every policy action is held to its attention launches."""
    torch.manual_seed(3)
    model = SACMAE(sac_policy(torch.bfloat16, "cuda"), sac_env(), batch_size=SAC_BATCH, mae_batch_size=SAC_BATCH,
                   learning_starts=SAC_STARTS, gradient_steps=SAC_GRAD_STEPS, buffer_size=SAC_RING, separate_optimizer=separate,
                   device_buffer=device_buffer, frame_stack=FRAME_STACK, seed=0, device="cuda")
    before = [p.detach().clone() for p in model.policy.parameters()]
    fwd, bwd = SAC_LAUNCHES["separate" if separate else "joint"]
    calls, train_s = [], []
    train_steps, sample = model.train_steps, model._sample

    def counted(fn, kind):
        def run(*args):
            start = Counter(LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*args)  # returns host numbers: synchronised
            if kind == "train":
                train_s.append(time.perf_counter() - t0)
            calls.append((kind, LAUNCHES[KERNEL] - start[KERNEL], LAUNCHES[BWD_KERNEL] - start[BWD_KERNEL]))
            return out
        return run

    model.train_steps, model._sample = counted(train_steps, "train"), counted(sample, "act")
    reset_launches()
    t0 = time.perf_counter()
    # a train event after every env step from learning_starts on, a policy action before every later one
    model.learn(total_timesteps=SAC_STARTS + (SAC_TRAIN_EVENTS - 1) * SAC_ENVS)
    learn_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    bodies = tensor_core_only(f"sac learn {'separate' if separate else 'joint'}")
    launches = {k: LAUNCHES[k] for k in ALL_KERNELS}
    trains = [c for c in calls if c[0] == "train"]
    acts = [c for c in calls if c[0] == "act"]
    want_train, want_act = ("train", SAC_GRAD_STEPS * fwd, SAC_GRAD_STEPS * bwd), ("act", 5, 0)
    if len(trains) != SAC_TRAIN_EVENTS or any(c != want_train for c in trains) or any(c != want_act for c in acts) or len(acts) != SAC_TRAIN_EVENTS - 1:
        fail(f"sac learn launched {calls}, expected {SAC_TRAIN_EVENTS} train_steps() of {want_train} and {SAC_TRAIN_EVENTS - 1} acts of {want_act}")
    if launches[V1_KERNEL] or launches[V1_BWD_KERNEL]:
        fail(f"sac learn launched the split-head kernels: {launches}")
    m = model.last_metrics
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(model.policy.parameters(), before))
    finite = all(np.isfinite(v) for v in m.values()) and all(torch.isfinite(p).all() for p in model.policy.parameters())
    if set(m) != {"mae_loss", "ent_coef", "ent_coef_loss", "critic_loss", "actor_loss"} or not finite or not moved > 0:
        fail(f"sac learn: metrics {m}, max parameter move {moved}")
    # the target moves by tau toward the critic on every step
    model.train_steps = train_steps
    p = model.policy
    target0 = [t.detach().clone() for t in p.critic_target.parameters()]
    model.train_steps(1)
    for t0_, t, c in zip(target0, p.critic_target.parameters(), p.critic.parameters()):
        if not torch.equal(t.detach(), (1.0 - model.tau) * t0_ + model.tau * c.detach()):
            fail("sac: the target did not move by tau toward the critic")
    grad_steps = SAC_GRAD_STEPS * SAC_TRAIN_EVENTS
    return dict(learn_s=learn_s, transitions=model.num_timesteps, gradient_steps=grad_steps,
                gradient_steps_per_s=grad_steps / sum(train_s), env_steps_per_s=model.num_timesteps / learn_s, train_steps_s=train_s,
                launches=launches, launches_per_train_steps=list(trains[0][1:]), bodies=bodies, last_metrics=m, max_param_move=moved)


def sac_cli() -> dict:
    """``cli.train_sacmae.main`` on the card at its defaults (full width, bf16, batch 256, MAE
    batch 256, frame stack 4, env workers in processes), cut in env count, ring, warm-up and
    length; then save and load into a fresh model: step count, parameters and every Adam's moments
    equal on the card."""
    argv = ["--env", "FakeInsertion", "--n_envs", str(SAC_ENVS), "--buffer_size", str(SAC_RING),
            "--learning_starts", str(SAC_STARTS), "--total_timesteps", str(SAC_STARTS + 63 * SAC_ENVS), "--seed", "0"]
    reset_launches()
    t0 = time.perf_counter()
    model = sac_cli_module.main(argv)
    main_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    bodies = tensor_core_only("sac cli")
    launches = {k: LAUNCHES[k] for k in ALL_KERNELS}
    fwd, bwd = SAC_LAUNCHES["separate"]
    want = {KERNEL: 64 * fwd + 63 * 5, BWD_KERNEL: 64 * bwd, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
    if model._n_updates != 64 or launches != want or not all(np.isfinite(v) for v in model.last_metrics.values()):
        fail(f"sac cli: {model._n_updates} updates, launches {launches} (expected {want}), metrics {model.last_metrics}")
    CKPT_DIR.mkdir(exist_ok=True)
    try:
        path = str(CKPT_DIR / "sac.ckpt")
        model.save(path)
        config = sac_cli_module.build_parser().parse_args(argv)
        fresh = sac_cli_module.build_model(config, sac_env())
        fresh.load(path)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    opts = ("actor_optimizer", "critic_optimizer", "ent_optimizer", "mae_optimizer")
    dev = model.device.type  # the CLI's default, cuda
    same = fresh.num_timesteps == model.num_timesteps and all(
        torch.equal(a, b) and a.device.type == dev for a, b in zip(fresh.policy.parameters(), model.policy.parameters()))
    for name in opts:
        a, b = getattr(fresh, name), getattr(model, name)
        same &= a.count == b.count and torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu) and a.mu.device.type == dev
    if not same:
        fail("sac cli: the loaded model differs from the saved one")
    print(f"  sac cli: main() {main_s:.1f} s, {model._n_updates} gradient steps, launches {launches}; saved and loaded: "
          f"{fresh.num_timesteps} steps, parameters and the four Adams' moments equal on the card")
    return dict(main_s=main_s, gradient_steps=model._n_updates, launches=launches, bodies=bodies, last_metrics=model.last_metrics,
                restored_equal=True)


def sac_phase() -> dict:
    out = {"f32_check": {}}
    for mode, separate in (("separate", True), ("joint", False)):
        t0 = time.perf_counter()
        e = sac_update_errors(*sac_models(separate))
        print(f"  sac {mode}: one f32 step at batch {SAC_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): "
              f"loss rel err {e['loss_rel']:.3e}, grad err/|grad| {json.dumps(e['grad_rel'])}, param err/lr {json.dumps(e['param_per_lr'])}, "
              f"ent_coef {e['ent_coef']}; tol {SAC_F32_TOL}")
        if (e["loss_rel"] > SAC_F32_TOL["loss_rel"] or max(e["grad_rel"].values()) > SAC_F32_TOL["grad_rel"]
                or max(e["param_per_lr"].values()) > SAC_F32_TOL["param_per_lr"] or e["ent_coef"][0] != e["ent_coef"][1]):
            fail(f"the f32 SAC step on the card disagrees with the CPU ({mode})")
        out["f32_check"][mode] = dict(e, tol=SAC_F32_TOL, batch=SAC_CHECK_BATCH)
    for mode, separate in (("separate", True), ("joint", False)):
        for ring, device_buffer in (("host", False), ("device", True)):
            r = out[f"{mode}_{ring}"] = sac_learn(separate, device_buffer)
            print(f"  sac learn {mode} {ring} ring: {r['learn_s']:.2f} s, {r['gradient_steps_per_s']:.2f} gradient steps/s, "
                  f"{r['env_steps_per_s']:.1f} env-steps/s; launches per train_steps({SAC_GRAD_STEPS}) {r['launches_per_train_steps']}")
    out["cli"] = sac_cli()
    return out

SSL_CONFIG = str(Path(__file__).resolve().parent / "config" / "experiment" / "mae_vit.yaml")
SSL_CHECK_BATCH, SSL_BATCH, SSL_SYNTHETIC = 8, 64, 197  # 197 frames at stride 5: 192 windows, 3 batches of 64
# One f32 MAE step at full width (ViT-small + the masked-query decoder), card vs CPU (TF32 off), the
# same weights, batch and masking noise, warm-up 0 so the first step moves the parameters: the
# loss relative to its magnitude, each parameter's gradient relative to its norm, and each
# parameter after AdamW relative to the learning rate, beyond the difference of Adam's first
# steps lr * g / (|g| + eps) that the two gradients imply (the key third of every qkv bias has a
# gradient that is zero analytically, so f32 noise, and Adam makes it a step of up to lr). On the
# H100 these seeds gave 0 (the losses equal), 4.454e-7 and 1.186e-3 (one ulp of a parameter near
# 1, at lr 1e-4): the bounds are about ten ulps of the loss and ~10x the other two.
SSL_F32_TOL = dict(loss_rel=1e-6, grad_rel=5e-6, param_per_lr=1.2e-2)
SSL_FULL_TOL = 3e-5  # the full-image encoder's normalised tokens, card vs CPU (f32), absolute: ~10x the 2.921e-6 measured


def ssl_models(overrides=()):
    """The config's encoder and MAEModule (f32, seeded weights), built on the CPU."""
    cfg = load_config(SSL_CONFIG, list(overrides))
    return instantiate(cfg["model"]["algorithm"])(instantiate(cfg["model"]["encoder"]))


def ssl_step(module: MAEModule, x: torch.Tensor, noise: torch.Tensor):
    """One MAE step of ``module`` on ``x`` with the masking ``noise``: the loss, every gradient
    and the parameters after the optimizer's first update."""
    module.sample_noise = lambda b, g: noise.to(x.device)
    opt = module.configure_optimizer(3, 2)
    loss, _ = module.training_loss({"image": x}, None, 0)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in module.named_parameters()}
    opt.step()
    return loss.item(), grads, {n: p.detach() for n, p in module.named_parameters()}, opt


def ssl_check() -> dict:
    """(a) One f32 step at full width on the card against the CPU."""
    cpu = ssl_models(["model.algorithm.warmup_epochs=0"])
    card = copy.deepcopy(cpu).to("cuda")
    enc = cpu.encoder
    x = torch.from_numpy(np.random.default_rng(0).random((SSL_CHECK_BATCH, *enc.img_size, enc.in_chans), dtype=np.float32))
    noise = torch.rand((SSL_CHECK_BATCH, cpu.num_patches), generator=torch.Generator().manual_seed(0))
    la, ga, pa, opt = ssl_step(card, x.cuda(), noise)
    lb, gb, pb, _ = ssl_step(cpu, x, noise)
    torch.cuda.synchronize()
    lr, eps = opt.learning_rate(0), opt.adamw.param_groups[0]["eps"]
    grad_rel, param_per_lr = 0.0, 0.0
    for name, g in gb.items():
        a = ga[name].cpu()
        grad_rel = max(grad_rel, ((a - g).norm() / g.norm()).item())
        implied = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        param_per_lr = max(param_per_lr, ((pa[name].cpu() - pb[name]).abs() - implied).max().item() / lr)
    return dict(loss_rel=abs(la - lb) / abs(lb), grad_rel=grad_rel, param_per_lr=param_per_lr, loss=lb, lr=lr, batch=SSL_CHECK_BATCH)


def ssl_run(name: str, overrides: list, launches: tuple[int, int], body: str, ckpt: Path, epochs: int = 2, resume_check=None,
            config: str = SSL_CONFIG, masked: tuple[int, int] = (0, 0)) -> dict:
    """``cli.pretrain.main`` on the card at ``config``'s defaults plus ``overrides``: every Trainer
    step must launch ``launches`` (forward, backward) packed kernels, all on ``body``, of which
    ``masked`` carry a key mask. Returns the history, the launches, the synchronised step times
    and the peak device memory."""
    steps, train_step, try_resume = [], Trainer.train_step, Trainer._try_resume
    last_end = [time.perf_counter()]

    def counted_step(self, module, optimizer, batch):
        start, fwd0, bwd0, masked0 = Counter(LAUNCHES), Counter(FWD_BODY_LAUNCHES), Counter(BWD_BODY_LAUNCHES), Counter(MASKED_LAUNCHES)
        t0 = time.perf_counter()
        out = train_step(self, module, optimizer, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        steps.append(dict(step_s=t1 - t0, fetch_s=t0 - last_end[0], launches={k: LAUNCHES[k] - start[k] for k in ALL_KERNELS},
                          masked={k: MASKED_LAUNCHES[k] - masked0[k] for k in (KERNEL, BWD_KERNEL)},
                          fwd_bodies=dict(FWD_BODY_LAUNCHES - fwd0), bwd_bodies=dict(BWD_BODY_LAUNCHES - bwd0)))
        last_end[0] = t1
        return out

    def checked_resume(self, module, optimizer):
        resumed = try_resume(self, module, optimizer)
        if resume_check is not None:
            resume_check(self, module, optimizer, resumed)
        last_end[0] = time.perf_counter()
        return resumed

    argv = ["--config", config, "--synthetic", str(SSL_SYNTHETIC), f"trainer.max_epochs={epochs}", f"ckpt_dir={ckpt}", *overrides]
    Trainer.train_step, Trainer._try_resume = counted_step, checked_resume
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer, module, history = pretrain_cli.main(argv)
    finally:
        Trainer.train_step, Trainer._try_resume = train_step, try_resume
    main_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = launches
    want = {KERNEL: fwd, BWD_KERNEL: bwd, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
    want_masked = {KERNEL: masked[0], BWD_KERNEL: masked[1]}
    for i, st in enumerate(steps):
        if (st["launches"] != want or st["fwd_bodies"] != {body: fwd} or st["bwd_bodies"] != {body: bwd}
                or st["masked"] != want_masked):
            fail(f"ssl {name}: step {i} launched {st['launches']} ({st['masked']} with a key mask) on bodies {st['fwd_bodies']} / "
                 f"{st['bwd_bodies']}, expected {want} ({want_masked}) on {body}")
    losses = [h["train_loss"] for h in history]
    if not steps or not all(np.isfinite(losses)) or not all(torch.isfinite(p).all() for p in module.parameters()):
        fail(f"ssl {name}: {len(steps)} steps, losses {losses}")
    timed = steps[1:]  # the first step pays cuBLAS set-up and allocation
    step_s = statistics.mean(st["step_s"] for st in timed)
    out = dict(main_s=main_s, steps=len(steps), global_step=trainer.global_step, epochs=[h["epoch"] for h in history], losses=losses,
               launches={k: LAUNCHES[k] for k in ALL_KERNELS}, launches_per_step=dict(want), masked_per_step=want_masked, body=body,
               step_ms=[st["step_s"] * 1e3 for st in steps], fetch_ms=[st["fetch_s"] * 1e3 for st in steps],
               steps_per_s=1.0 / step_s, images_per_s=SSL_BATCH / step_s, batch=SSL_BATCH, max_memory_allocated=peak)
    print(f"  ssl {name}: main() {main_s:.1f} s, {len(steps)} steps, losses {[round(v, 4) for v in losses]}; step "
          f"{step_s * 1e3:.2f} ms ({out['steps_per_s']:.2f} steps/s, {out['images_per_s']:.1f} images/s at batch {SSL_BATCH}, first step "
          f"excluded); loader + copy {statistics.median(out['fetch_ms'][1:]):.1f} ms median; {fwd} + {bwd} launches a step on {body}, "
          f"{masked[0]} + {masked[1]} with a key mask; peak memory {peak / 2**30:.2f} GiB")
    return dict(out, trainer=trainer, module=module)


def resume_checker(saved: dict, restored: dict):
    """A ``resume_check`` for ``ssl_run``: records in ``restored`` whether the resumed Trainer
    step, epoch, module state (parameters and buffers) and AdamW's moments and count equal
    ``saved`` (a loaded ``last.ckpt``) bit for bit on the card."""
    def check(trainer, module, optimizer, resumed):
        state = optimizer.adamw.state_dict()["state"]
        restored.update(resumed=resumed, step=trainer.global_step, epoch=trainer.current_epoch,
                        model=all(torch.equal(a, saved["model"][k]) and a.is_cuda for k, a in module.state_dict().items()),
                        moments=all(torch.equal(s[m], saved["opt"]["adamw"]["state"][i][m]) and s[m].is_cuda
                                    for i, s in state.items() for m in ("exp_avg", "exp_avg_sq")),
                        count=optimizer.count == saved["opt"]["count"])

    return check


def ssl_phase() -> dict:
    """Phase 9: the SSL pretraining slice at full width through cli.pretrain and its Trainer."""
    out = {}
    t0 = time.perf_counter()
    e = out["f32_check"] = ssl_check()
    print(f"  ssl (a): one f32 step at batch {SSL_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): loss rel err "
          f"{e['loss_rel']:.3e}, grad err/|grad| {e['grad_rel']:.3e}, param err/lr {e['param_per_lr']:.3e}; tol {SSL_F32_TOL}")
    if any(e[k] > SSL_F32_TOL[k] for k in SSL_F32_TOL):
        fail("the f32 MAE step on the card disagrees with the CPU")
    e["tol"] = SSL_F32_TOL
    ckpt = CKPT_DIR / "ssl"
    try:
        runs = {}
        runs["cli"] = ssl_run("(b) cli f32", [], (12, 12), "tf32x3", ckpt)
        steps = runs["cli"]["global_step"]  # 2 epochs
        saved = load_checkpoint(ckpt / "last.ckpt", map_location="cuda")
        restored = {}
        runs["resume"] = ssl_run("(c) resume", [], (12, 12), "tf32x3", ckpt, epochs=3, resume_check=resume_checker(saved, restored))
        if restored != dict(resumed=True, step=steps, epoch=2, model=True, moments=True, count=True) or runs["resume"]["global_step"] != steps * 3 // 2:
            fail(f"ssl resume: restored {restored}, ended at step {runs['resume']['global_step']}")
        print(f"  ssl (c): restored global_step {steps} and epoch 2; parameters and AdamW moments equal the saved ones on the card")
        runs["bf16"] = ssl_run("(d) bf16 encoder", ["model.encoder.compute_dtype=bfloat16"], (12, 12), "tensor_core", ckpt / "bf16")
        runs["he"] = ssl_run("(e) He-style decoder", ["model.algorithm.decode_masked_only=false"], (20, 20), "tf32x3", ckpt / "he")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    encoder = runs["cli"]["module"].encoder  # f32
    for r in runs.values():
        del r["trainer"], r["module"]
    # (f) the full-image encoder (N = 196): one forward, 12 launches, against the CPU on two images
    x = torch.from_numpy(np.random.default_rng(1).random((SSL_BATCH, *encoder.img_size, encoder.in_chans), dtype=np.float32)).cuda()
    reset_launches()
    with torch.no_grad():
        feats = encoder.get_intermediate_layers(x, n=4)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in ALL_KERNELS}
    if launches != {KERNEL: 12, BWD_KERNEL: 0, V1_KERNEL: 0, V1_BWD_KERNEL: 0} or dict(FWD_BODY_LAUNCHES) != {"tf32x3": 12}:
        fail(f"ssl full-image forward launched {launches} on {dict(FWD_BODY_LAUNCHES)}, expected 12 forward on the 3xTF32 body")
    with torch.no_grad():
        ref = copy.deepcopy(encoder).cpu().get_intermediate_layers(x[:2].cpu(), n=4)
    err = max((a[:2].cpu() - b).abs().max().item() for a, b in zip(feats, ref))
    shape = (SSL_BATCH, encoder.num_patches, encoder.embed_dim)  # (64, 196, 384)
    if len(feats) != 4 or any(f.shape != shape or not torch.isfinite(f).all() for f in feats) or err > SSL_FULL_TOL:
        fail(f"ssl full-image forward: shapes {[tuple(f.shape) for f in feats]}, max err vs CPU {err:.3e} (tol {SSL_FULL_TOL})")
    full_ms = []
    for _ in range(3):  # the synchronised forward, after the checked one
        t0 = time.perf_counter()
        with torch.no_grad():
            encoder.get_intermediate_layers(x, n=4)
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  ssl (f): full-image encoder forward at N={shape[1]}: {launches[KERNEL]} launches; last 4 blocks {shape}; max err vs CPU "
          f"{err:.3e} (tol {SSL_FULL_TOL}); {statistics.median(full_ms):.2f} ms a forward (median of {len(full_ms)})")
    out.update(runs, full_image=dict(launches=launches, max_abs_err_vs_cpu=err, tol=SSL_FULL_TOL, forward_ms=full_ms))
    return out


EXPERIMENTS = Path(__file__).resolve().parent / "config" / "experiment"
DISTILL_CHECK_BATCH = 8
# Packed launches per Trainer step at the configs' depths (forward, backward), and of those the
# ones with a key mask. DINO and DINOv2: forward, the student's global and local passes, the
# teacher's global pass and the probe's full teacher pass (12 each) and the probe decoder (2);
# backward, the student's two passes (12 each) and the probe decoder; every pass but the probe's
# is key-masked. I-JEPA: forward, the context encoder (key-masked), the target encoder and four
# predictor passes of 6 layers (key-masked); backward, the context encoder and the predictor.
DISTILL_LAUNCHES = {"dino": ((50, 26), (36, 24)), "dinov2": ((50, 26), (36, 24)), "ijepa": ((48, 36), (36, 36))}
# One f32 DINO step at full width (ViT-small, 1 register, dino_out_dim 65536, the probe), card vs
# CPU (TF32 off), the same weights, batch, masks and temperature: the loss relative to its
# magnitude, each trainable gradient relative to its norm, each trainable parameter after AdamW
# relative to the learning rate beyond the difference of Adam's first steps that the two
# gradients imply, each teacher parameter after the EMA beyond (1 - momentum) times that
# difference, relative to the learning rate, and the center after its EMA, absolute. On the H100
# these seeds gave 7.241e-8 (about one ulp of the loss), 1.934e-6, 1.190e-3 (one ulp of a
# parameter near 1, at lr 1e-4), 7.294e-5 and 1.211e-8 (|center| up to 2.6e-2): the same f32
# arithmetic in another summation order; each bound is about 10x its value.
DISTILL_F32_TOL = dict(loss_rel=1e-6, grad_rel=2e-5, param_per_lr=1.2e-2, teacher_per_lr=7e-4, center_abs=1.2e-7)


def distill_models(name: str, overrides=()):
    """The experiment config's encoder and algorithm (f32, seeded weights), built on the CPU."""
    cfg = load_config(str(EXPERIMENTS / f"{name}_vit.yaml"), list(overrides))
    return instantiate(cfg["model"]["algorithm"])(instantiate(cfg["model"]["encoder"]))


def dino_step(module, x: torch.Tensor, masks: tuple):
    """One Trainer step of the DINO ``module`` by hand (loss, backward, AdamW, the post-update
    hook) on ``x`` under ``masks`` at step 0: the loss, the trainable gradients, and the state
    after it."""
    module.setup_schedules(3, 2)
    module.sample_masks = lambda generator, batch: tuple(m.to(x.device) for m in masks)
    opt = module.configure_optimizer(3, 2)
    loss, aux = module.training_loss({"image": x}, None, 0)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone() for n, p in module.trainable_parameters().items()}
    opt.step()
    module.on_train_batch_end(aux, 0)
    return loss.item(), grads, {n: v.detach() for n, v in module.state_dict().items()}, opt


def distill_check() -> dict:
    """(a) One f32 DINO step at full width on the card against the CPU."""
    cpu = distill_models("dino", ["model.algorithm.warmup_epochs=0"])
    card = copy.deepcopy(cpu).to("cuda")
    enc = cpu.student_backbone
    x = torch.from_numpy(np.random.default_rng(2).random((DISTILL_CHECK_BATCH, *enc.img_size, enc.in_chans), dtype=np.float32))
    masks = cpu.sample_masks(torch.Generator().manual_seed(3), DISTILL_CHECK_BATCH)
    reset_launches()
    la, ga, sa, opt = dino_step(card, x.cuda(), masks)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in (KERNEL, BWD_KERNEL)}
    if launches != dict(zip((KERNEL, BWD_KERNEL), DISTILL_LAUNCHES["dino"][0])):
        fail(f"the DINO check step launched {launches}, expected {DISTILL_LAUNCHES['dino'][0]}")
    lb, gb, sb, _ = dino_step(cpu, x, masks)
    lr, eps = opt.learning_rate(0), opt.adamw.param_groups[0]["eps"]
    momentum = cpu._momentum_fn(0)
    implied, grad_rel, param_per_lr = {}, 0.0, 0.0
    for name, g in gb.items():
        a = ga[name].cpu()
        grad_rel = max(grad_rel, ((a - g).norm() / g.norm()).item())
        implied[name] = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        param_per_lr = max(param_per_lr, ((sa[name].cpu() - sb[name]).abs() - implied[name]).max().item() / lr)
    teacher_per_lr = 0.0
    for name in sb:
        if name.startswith("teacher_"):
            step = (1.0 - momentum) * implied["student_" + name[len("teacher_"):]]
            teacher_per_lr = max(teacher_per_lr, ((sa[name].cpu() - sb[name]).abs() - step).max().item() / lr)
    center_abs = (sa["center"].cpu() - sb["center"]).abs().max().item()
    return dict(loss_rel=abs(la - lb) / abs(lb), grad_rel=grad_rel, param_per_lr=param_per_lr, teacher_per_lr=teacher_per_lr,
                center_abs=center_abs, center_max=sb["center"].abs().max().item(), loss=lb, lr=lr, momentum=momentum,
                batch=DISTILL_CHECK_BATCH, launches=launches)


def distill_phase() -> dict:
    """Phase 10: DINO, DINOv2 and I-JEPA at full width through cli.pretrain and its Trainer."""
    out = {}
    t0 = time.perf_counter()
    e = out["f32_check"] = distill_check()
    print(f"  distill (a): one f32 DINO step at batch {DISTILL_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): loss rel err "
          f"{e['loss_rel']:.3e}, grad err/|grad| {e['grad_rel']:.3e}, param err/lr {e['param_per_lr']:.3e}, teacher err/lr "
          f"{e['teacher_per_lr']:.3e}, center abs err {e['center_abs']:.3e} (|center| max {e['center_max']:.3e}); tol {DISTILL_F32_TOL}")
    if any(e[k] > DISTILL_F32_TOL[k] for k in DISTILL_F32_TOL):
        fail("the f32 DINO step on the card disagrees with the CPU")
    e["tol"] = DISTILL_F32_TOL
    ckpt = CKPT_DIR / "distill"

    def run(label, name, path, **kw):
        launches, masked = DISTILL_LAUNCHES[name]
        r = ssl_run(label, [], launches, "tf32x3", path, config=str(EXPERIMENTS / f"{name}_vit.yaml"), masked=masked, **kw)
        del r["trainer"], r["module"]
        torch.cuda.empty_cache()
        return r

    try:
        runs = {}
        runs["dino"] = run("(b) DINO", "dino", ckpt)
        steps = runs["dino"]["global_step"]  # 2 epochs
        saved = load_checkpoint(ckpt / "last.ckpt", map_location="cuda")
        if not any(k.startswith("teacher_backbone.") for k in saved["model"]) or "center" not in saved["model"]:
            fail("the DINO checkpoint lacks the teacher or the center")
        restored = {}
        runs["dino_resume"] = run("(c) DINO resume", "dino", ckpt, epochs=3, resume_check=resume_checker(saved, restored))
        del saved
        if restored != dict(resumed=True, step=steps, epoch=2, model=True, moments=True, count=True) or runs["dino_resume"]["global_step"] != steps * 3 // 2:
            fail(f"DINO resume: restored {restored}, ended at step {runs['dino_resume']['global_step']}")
        print(f"  distill (c): restored global_step {steps} and epoch 2; teachers, center, student and AdamW moments equal the saved ones on the card")
        # batch 64 holds the iBOT logits, (2 x 64, 196, 65536) f32 (6.6 GB a copy), several times:
        # 59.6 GiB at the peak on the H100, so the config's batch fits and is not cut
        runs["dinov2"] = run("(d) DINOv2", "dinov2", ckpt / "dinov2")
        runs["ijepa"] = run("(d) I-JEPA", "ijepa", ckpt / "ijepa")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out.update(runs)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}; matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_bf16_reduced_precision_reduction={torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    t0 = time.perf_counter()
    secs = build_all()
    print(f"[2] built {sorted(secs)} in {time.perf_counter() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")

    print("[3] kernels against their plain versions")
    errs = check_attention()
    timed = {}
    n192, n10 = (SERVE_B, SERVE_N), (SERVE_B, TRAIN_N_KEPT)
    for kind, fn, split, shapes in (("forward", time_attention, False, ((8, SERVE_N), n192, n10)),
                                    ("backward", time_attention_bwd, False, (n192, n10)),
                                    ("v1 forward", time_attention, True, (n192, n10)),
                                    ("v1 backward", time_attention_bwd, True, (n192, n10))):
        for b, n in shapes:
            t = timed[kind, b, n] = fn(b, n, SERVE_H, SERVE_DH, torch.bfloat16, split=split)
            print(f"  {kind} B={b} N={n} H={SERVE_H} Dh={SERVE_DH} bf16: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B, {t['flops']} FLOP)")

    for b, n, h, dh in TIMED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for kind, fn in (("forward", time_attention), ("backward", time_attention_bwd)):
                t = timed[kind, b, n, h, dh, dtype] = fn(b, n, h, dh, dtype)
                print(f"  {kind} B={b} N={n} H={h} Dh={dh} {str(dtype)[6:]}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                      f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B, {t['flops']} FLOP)")

    print("[3b] heads of any length: each side of each whole-head limit")
    length_worst = check_lengths()
    print(f"  largest err/tol: {json.dumps(length_worst)}")
    for dtype in (torch.bfloat16, torch.float32):
        for kind, fn in (("forward", time_attention), ("backward", time_attention_bwd)):
            t = timed[kind, 2, LONG_N, dtype] = fn(2, LONG_N, SERVE_H, SERVE_DH, dtype)
            print(f"  {kind} B=2 N={LONG_N} H={SERVE_H} Dh={SERVE_DH} {str(dtype)[6:]}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B, {t['flops']} FLOP)")

    print("[3c] the phase-10 key masks")
    distill_worst = check_distill_masks()
    print(f"  largest err/tol: {json.dumps(distill_worst)}")
    for i, (kind, (b, n, h, dh)) in enumerate(DISTILL_MASKED):
        mask = distill_mask(kind, b, seed=i)
        for dtype in (torch.float32, torch.bfloat16):
            for direction, fn in (("forward", time_attention), ("backward", time_attention_bwd)):
                t = timed[direction, kind, dtype] = fn(b, n, h, dh, dtype, mask=mask)
                print(f"  {direction} ({kind}) B={b} N={n} H={h} Dh={dh} {str(dtype)[6:]}, {mask.float().mean().item():.3f} of keys kept: "
                      f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
                      f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B, {t['flops']} FLOP)")

    print("[4] serving slice")
    sl = serve_slice()
    print(f"  batch 8: p50 {sl['batch8_latency_ms_p50']:.3f} ms per request; batch 512: {sl['batch512_ms']:.3f} ms, "
          f"{sl['batch512_obs_frames_per_s']:.1f} obs-frames/s; {sl['attention_launches']} attention launches in {sl['forwards']} forwards")

    print("[5] training slice")
    tr = train_slice()
    its = "; ".join(f"collect {i['collect_s']:.2f} s, train {i['train_s']:.2f} s" for i in tr["iterations"])
    print(f"  learn: {its}; {tr['updates_per_train']} updates per train(), launches per train() {tr['launches_per_train']}")
    print(f"  minibatch update {tr['update_ms']:.3f} ms ({TRAIN_BATCH} samples), {tr['update_obs_frames_per_s']:.1f} update obs-frames/s")

    print("[6] attention-layer bench")
    bench = bench_phase()

    print("[7] training CLI")
    cli = cli_phase()

    print("[8] SAC+MAE slice")
    sac = sac_phase()

    print("[9] SSL pretraining slice")
    ssl = ssl_phase()

    print("[10] self-distillation and latent-prediction pretraining (DINO, DINOv2, I-JEPA)")
    distill = distill_phase()

    def by_path(name):
        """The kernel's launches in each path's run (counts set to 0 just before it)."""
        return dict(serve=sl["attention_launches"] if name == KERNEL else 0, train=tr["launches"].get(name, 0),
                    bench_v2=bench["v2"]["launches"].get(name, 0), bench_v1=bench["v1"]["launches"].get(name, 0),
                    **{f"cli_{mode}": cli[mode]["launches"][name] for mode in ("joint", "separate", "plain", "resume")},
                    **{f"sac_{run}": sac[run]["launches"][name] for run in ("separate_host", "separate_device", "joint_host", "joint_device", "cli")},
                    **{f"ssl_{run}": ssl[run]["launches"][name] for run in ("cli", "resume", "bf16", "he", "full_image")},
                    **{f"distill_{run}": distill[run]["launches"][name] for run in ("dino", "dino_resume", "dinov2", "ijepa")})

    def ssl_shapes(kind):
        """The packed kernel of this direction at the SSL slices' shapes and the training shape, f32
        and bf16, with no mask; then under the phase-10 key masks."""
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        return [dict(B=b, N=n, H=h, Dh=dh, dtype=str(dt)[6:], mask=None, **{k: timed[kind, b, n, h, dh, dt][k] for k in keys})
                for b, n, h, dh in TIMED_SHAPES for dt in (torch.float32, torch.bfloat16)] + [
                dict(B=b, N=n, H=h, Dh=dh, dtype=str(dt)[6:], mask=mk, err_per_tol=distill_worst[f"{kind} {mk} {str(dt)[6:]}"],
                     **{k: timed[kind, mk, dt][k] for k in keys})
                for mk, (b, n, h, dh) in DISTILL_MASKED for dt in (torch.float32, torch.bfloat16)]

    def row(name, source, replaces, kind, path, err):
        t, t10 = timed[(kind, *n192)], timed[(kind, *n10)]
        launches = by_path(name)
        return dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches[path], main_path=path,
            launches_by_path=launches,
            max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=dict(B=SERVE_B, N=SERVE_N, H=SERVE_H, Dh=SERVE_DH, dtype="bfloat16"),
            n10_ms=t10["ms"], n10_plain_ms=t10["plain_ms"], n10_library_ms=t10["library_ms"], n10_bound_ms=t10["bound_ms"],
            **long_n(kind),
        )

    def long_n(kind):
        """The packed kernel of this direction at B=2, N=784 (the v1 pair runs the same bodies)."""
        direction = kind.split()[-1]
        return {f"n{LONG_N}_{str(dt)[6:]}_{k}": timed[direction, 2, LONG_N, dt][k]
                for dt in (torch.bfloat16, torch.float32) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    b8 = timed["forward", 8, SERVE_N]
    src, ref = "m3l_tpu_torch/csrc/", "m3l_tpu/nn/flash_attention.py:"
    kernels = [
        dict(row(KERNEL, src + "flash_attention_qkv_fwd.cu", ref + "263", "forward", "train", errs["forward"]),
             batch8_ms=b8["ms"], batch8_plain_ms=b8["plain_ms"], batch8_library_ms=b8["library_ms"], batch8_bound_ms=b8["bound_ms"],
             ssl_shapes=ssl_shapes("forward")),
        dict(row(BWD_KERNEL, src + "flash_attention_qkv_bwd.cu", ref + "280", "backward", "train", errs["backward"]),
             ssl_shapes=ssl_shapes("backward")),
        row(V1_KERNEL, src + "flash_attention_fwd.cu", ref + "40", "v1 forward", "bench_v1", errs["v1 forward"]),
        row(V1_BWD_KERNEL, src + "flash_attention_bwd.cu", ref + "55", "v1 backward", "bench_v1", errs["v1 backward"]),
    ]
    # every bf16 launch took the bf16 body of its direction, every f32 launch (phase 9's f32 runs)
    # the 3xTF32 body (checked)
    for k, name in zip(kernels, ("_fwd_qkv_kernel", "_bwd_qkv_kernel", "_fwd_kernel", "_bwd_kernel")):
        direction = "fwd" if "fwd" in name else "bwd"
        k.update(tpu_kernel=name, body="tensor_core", body_source=f"{src}flash_attention_{direction}_mma.cuh", f32_body="tf32x3",
                 f32_body_source=f"{src}flash_attention_{direction}_tf32.cuh")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"slice": sl}))
    print(json.dumps({"train": tr}))
    print(json.dumps({"bench_attention": bench}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"sac": sac}))
    print(json.dumps({"ssl": ssl}))
    print(json.dumps({"ssl_distill": distill}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
