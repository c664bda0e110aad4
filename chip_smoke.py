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
11. V-JEPA pretraining, then the downstream probes over the pretrained ViT-small, at full width:
   (a) one f32 V-JEPA step (config/experiment/vjepa_vit.yaml: the tubelet ViT-small on two
   224 x 224 x 3 frames at tubelet 2, 196 tokens, tube masks at 0.75 so the context encoder runs on
   49 gathered tokens and the predictor, 6 layers at 384 wide with 12 heads of 32, on 49 + 147) on
   the card against the same weights, batch and tube masks on the CPU at batch 8 (VJEPA_F32_TOL:
   the loss and its two parts, the trainable gradients, the parameters after AdamW, the target
   encoder after the EMA); (b) ``cli.pretrain.main`` on vjepa_vit.yaml at its defaults plus
   ``data.out_format=video``, 197 frames, 2 epochs, batch 64: exactly 30 forward + 18 backward
   launches a step, none with a key mask, all on the tf32x3 bodies (VJEPA_LAUNCHES); (c) a resume
   bit-equal with the target encoder, the predictor and AdamW's moments; (d) ``cli.evaluate.main
   --task force`` on config/experiment/downstream_task/force/digit_mae.yaml with
   ``task.checkpoint_encoder`` = phase 9's last.ckpt (kept for this phase as MAE_CKPT), 197
   synthetic frames, 2 epochs, batch 64: the loaded encoder equals the checkpoint's ``encoder.*``
   bit for bit before and after training, every Trainer step launches 12 forward and no backward,
   every evaluation batch 12 forward, the metrics are finite; (e) the same with ``--task slip``
   (slip/digit_mae.yaml) and with force/digit_e2e.yaml (``train_encoder: true``, 12 + 12 a step,
   the encoder moves); (f) one f32 ForceSLModule step (frozen encoder) card vs CPU at batch 8
   (PROBE_F32_TOL). Each run prints steps/s, images/s or the probe's steps/s, the loader's ms per
   batch and the peak memory. Cut as phase 9: the data and the epochs.
12. the force-field task, VTDINO and the multimodal transformer, at full width: (a) one f32
   GeometricForceFieldModule step (config/experiment/downstream_task/forcefield/digit_dino.yaml:
   ViT-small on 224 x 224 x 6, hooks (2, 5, 8, 11), the DPT decoder at fusion 128, the pose
   ResNet-18; frozen) on the card against the CPU at batch 4 on synthetic DIGIT windows (FF_F32_TOL),
   24 + 0 launches; (b) the same config through the Trainer over phase 9's MAE encoder
   (``task.checkpoint_encoder``, no register token) on 192 windows of ``synth_digit_trajectories(size=224)``,
   batch 64: 24 + 0 launches a step, the encoder bit-equal to the checkpoint before and after; then
   two fine-tuned steps of forcefield/digit_e2e.yaml (24 + 24, the encoder moves); step ms, loader
   ms, images/s and peak memory; (c) the demo's model (``cli.demo_forcefield._build_module_structure``
   at its defaults: dim 192, depth 6, 3 heads, hooks 1,3,4,5, fusion 64, bf16, 96 x 96) runs
   ``forward_fields`` over 30 synthetic frames on the card, one at a time, on the tensor-core body;
   its fields must match the same model on the same frames with the attention's plain version
   (DEMO_BF16_TOL); (d) one f32 VTDINO step at MultimodalVTT's and VTDINOModule's defaults (dim 384,
   depth 4, 6 heads, 70 x 70 at patch 14, the 65536-wide head) on the card against the CPU at batch
   8 (VTDINO_F32_TOL), then 3 f32 Trainer steps at batch 64 (12 + 8 launches a step, all
   key-masked) and 2 bf16 steps at scripts/vtdino_experiment.py's recipe (dim 128, frame stack 2,
   the probe, batch 256: 18 + 10, 12 + 8 key-masked), whose first batch's loss and gradients must
   match the same step with the attention's plain version (VTDINO_BF16_TOL); (e) the multimodal
   transformer (ViT-base width, 4 blocks, shared and factored attention) forward and backward on
   the card against the CPU (MM_F32_TOL) at its launches.
13. the PPO feature variants and the RL side's evaluation, at full width: (a) one f32 minibatch
   update of each variant's CLI model (``cli.traindino``: PPO over the frozen ViT-S/14 with 4
   registers on 70 x 70 crops, dim 384; ``cli.train_dino_cat_mae`` and ``cli.train_dino_tac_mae``:
   the 70 x 70 VTT at patch 14 and dim 384, mask 0.8, fused with the frozen DINO feature of the
   middle frame; ``cli.train_cnn``: the CNN-variant MAE at the flagship's widths; the DINO from
   ``--dinov2_weights``, a seeded state dict with LayerScales of a trained model's size) on the card
   against the same weights, batch and mask on the CPU at minibatch 64 (VARIANT_F32_TOL), all on the
   tf32x3 bodies; (b) each CLI's ``main`` at its defaults (bf16) on FakeInsertion for 2 iterations (cut:
   the rollout, 1024 of 32768 samples; the epochs, 2 of 10; train_cnn's envs, 8 of 1, for speed):
   every rollout and train() at its exact launches (VARIANT_LAUNCHES), the frozen DINO bit-equal
   through learn on the card, update ms and env-steps/s printed; (c) f32 ``VTMAE.reconstruct`` on
   the card against the CPU (the training CLI's early-conv MAE and the fusion CLI's patch MAE, 7
   forward launches each, RECON_F32_TOL) and one ``EvalCallback`` episode of traindino's model
   (13 forward launches a step; a video where cv2 is installed).

Phase 3 also holds both packed kernels to their plain versions at the shapes of the SSL, probe,
force-field, VTDINO, multimodal and PPO-variant paths (SSL_SHAPES, f32 and bf16, with and without a random key
mask) and times them there and at the training shape (512, 192, 4, 64); on each side of each body's
whole-head limit (LENGTH_CASES, B=2, H=4, with and without a key mask: a longer head streams in
tiles, with the bits it would have staged whole), timing bf16 and f32 at B=2, N=784, Dh=64 (3b);
and under the key masks of the self-distillation paths (3c, DISTILL_MASKED: DINO's global block at
(64, 197, 6, 64), its local blocks at (256, 197, 6, 64), I-JEPA's cut context at (64, 392, 12,
32), and VTDINO's block masks tiled over its three modalities at its defaults and at its bf16
recipe), f32 and bf16, each timed beside SDPA under the same mask, its bound counting only the kept
keys. It prints err/tol for each case.

Each phase after the kernel checks runs with the launch counts set to 0 just before it and read
just after; phases 4-8 also fail unless every bf16 forward launch, and in phases 5-8 every bf16
backward launch, took the tensor-core body; phases 9-11 hold every launch to its dtype's body
and count the launches with a key mask (``MASKED_LAUNCHES``); so do phases 12 and 13.
The last lines are a {"kernels": [...]} JSON line, {"slice": ...}, {"train": ...},
{"bench_attention": ...}, {"cli": ...}, {"sac": ...}, {"ssl": ...}, {"ssl_distill": ...},
{"ssl_vjepa": ...}, {"evaluate": ...}, {"forcefield": ...}, {"vtdino": ...} and {"variants": ...}
JSON lines, the card line as nvidia-smi prints it, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from m3l_tpu_torch import bench_attention
from m3l_tpu_torch.cli import demo_forcefield as demo_cli
from m3l_tpu_torch.cli import evaluate as evaluate_cli
from m3l_tpu_torch.cli import pretrain as pretrain_cli
from m3l_tpu_torch.cli import train as train_cli
from m3l_tpu_torch.cli import train_sacmae as sac_cli_module
from m3l_tpu_torch.data import ArrayDataset, DataLoader, forcefield_windows, synth_digit_trajectories
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
from m3l_tpu_torch.profile_paths import VARIANTS, random_minibatch, variant_masks, variant_model
from m3l_tpu_torch.models import VTMAE, VTT, MultimodalTransformer, MultimodalVTT, VTTConfig, dinov2_vits14
from m3l_tpu_torch.rl import PPOMAE, SACMAE, MAEFeatures, SACActorCritic
from m3l_tpu_torch.rl import DinoCatMAEFeatures, FrozenEncoderFeatures
from m3l_tpu_torch.rl.callbacks import EvalCallback
from m3l_tpu_torch.serve import PolicyServer, build_policy, random_obs
from m3l_tpu_torch.ssl import MAEModule, VTDINOModule, sample_block_masks, sample_block_masks_constrained
from m3l_tpu_torch.ssl.ijepa import cut_context
from m3l_tpu_torch.eval import TestTaskSL
from m3l_tpu_torch.train import Trainer, load_checkpoint
from m3l_tpu_torch.train.builders import _seeded, build_task_module
from m3l_tpu_torch.utils.config import instantiate, load_config
from m3l_tpu_torch.utils.obs import vt_load

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
# patches + 1 register), the I-JEPA predictor (196 context + 196 mask tokens, 12 heads of 32) and
# the V-JEPA predictor (49 context + 147 target tokens, 12 heads of 32). Then phase 12's: the
# force-field check step's encoder (batch 4); the bf16 demo's encoder (one frame of 36 patches + 1
# register, 3 heads); VTDINO at its defaults (1 register + 3 modalities x 25 patches; the global
# view at batch 64, the four local views at once) and at its bf16 recipe (1 + 3 x 64 at batch 256
# and 1024, 4 heads) with the recipe's probe decoder (64 tokens, 8 heads of 32); the multimodal
# transformer's factored blocks (1 register + 196 image or 49 tactile tokens) and its shared ones
# (1 + 196 + 2 x 49), 12 heads, batch 4. Then phase 13's: the frozen ViT-S/14 on 1 CLS + 4 registers
# + 25 patches of a 70 x 70 crop, 3 crops a sample, at minibatch 512 and at a 64-env policy step;
# the post transformer over those 3 crop features; the fusion VTT on 75 tokens (70 x 70 image and
# two tactile maps at patch 14), its MAE encoder on the 15 kept at mask 0.8, and the tactile-only
# MAE's decoder on 50 (its encoder's 10 kept are the training shape's N = 10)
SSL_SHAPES = [(64, 49, 6, 64), (64, 196, 6, 64), (64, 196, 16, 32), (64, 197, 6, 64), (64, 392, 12, 32), (64, 196, 12, 32),
              (4, 197, 6, 64), (1, 37, 3, 64), (64, 76, 6, 64), (256, 76, 6, 64), (256, 193, 4, 64), (1024, 193, 4, 64),
              (256, 64, 8, 32), (4, 197, 12, 64), (4, 50, 12, 64), (4, 295, 12, 64),
              (1536, 30, 6, 64), (192, 30, 6, 64), (512, 3, 4, 64), (512, 75, 4, 64), (512, 15, 4, 64), (512, 50, 4, 64)]
# the same kernels under the key masks the self-distillation paths give them (distill_mask): DINO's
# global view and its four local views at once, the I-JEPA predictor's context, and VTDINO's global
# and local views at its defaults and at its bf16 recipe
DISTILL_MASKED = [("global block", (64, 197, 6, 64)), ("local blocks", (256, 197, 6, 64)), ("context", (64, 392, 12, 32)),
                  ("VTDINO global block", (64, 76, 6, 64)), ("VTDINO local blocks", (256, 76, 6, 64)),
                  ("VTDINO recipe global block", (256, 193, 4, 64)), ("VTDINO recipe local blocks", (1024, 193, 4, 64))]
# each timed in f32 and bf16, unmasked: the SSL shapes, DINO's four local views at once, the training shape
TIMED_SHAPES = SSL_SHAPES + [(256, 197, 6, 64), (SERVE_B, SERVE_N, SERVE_H, SERVE_DH)]
ALL_KERNELS = (KERNEL, BWD_KERNEL, V1_KERNEL, V1_BWD_KERNEL)
CKPT_DIR = Path(__file__).resolve().parent / "smoke_checkpoints"
MAE_CKPT = CKPT_DIR / "mae_vit_last.ckpt"  # phase 9's last.ckpt, kept for phase 11 and removed at the end


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


def distill_mask(kind: str, b: int, n: int, seed: int) -> torch.Tensor:
    """A key mask (B, N) of the self-distillation paths, drawn by the port's samplers. "context":
    the I-JEPA context block on the 14 x 14 grid cut by four target blocks, then 196 visible mask
    tokens (the predictor, N = 392). Otherwise the register key, then block masks on the square
    patch grid (DINO: 14 x 14; "VTDINO ...": per modality, tiled over the image and two tactile
    segments as ``MultimodalVTT`` does): "... global block", one global block avoiding four local
    ones, as ``DINOModule.sample_masks`` draws it; "... local blocks", local blocks, 4 per sample (B
    / 4 samples, mask-major)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ones = torch.ones(b, 1, dtype=torch.bool, device="cuda")
    if kind == "context":
        grid = (14, 14)
        tgt = sample_block_masks(g, b, grid, (0.15, 0.2), 4)
        ctx = cut_context(sample_block_masks(g, b, grid, (0.85, 1.0), 1)[0], tgt)
        return torch.cat([ctx, ones.expand(b, 196)], dim=1)
    modalities = 3 if kind.startswith("VTDINO") else 1
    side = math.isqrt((n - 1) // modalities)
    grid = (side, side)
    if kind.endswith("global block"):
        local = sample_block_masks(g, b, grid, (0.2, 0.8), 4)
        keep = sample_block_masks_constrained(g, b, grid, (0.2, 0.8), 1, local.any(0), 4)[0]
    else:
        keep = sample_block_masks(g, b // 4, grid, (0.2, 0.8), 4).reshape(b, side * side)
    return torch.cat([ones, keep.repeat(1, modalities)], dim=1)


def check_distill_masks() -> dict:
    """Both packed kernels against their plain versions under the self-distillation key masks,
    f32 and bf16; returns err/tol by case."""
    worst = {}
    for i, (kind, (b, n, h, dh)) in enumerate(DISTILL_MASKED):
        mask = distill_mask(kind, b, n, seed=i)
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
    """One minibatch update on the whole of ``mb`` (``mask`` None without MAE updates); returns its
    metrics and the flat pre-clip gradient."""
    n = mb["advantages"].shape[0]
    idx = torch.arange(n, device=model.device)
    mask = None if mask is None else type(mask)(*(t.to(model.device) for t in mask))
    metrics = model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], mask)
    return {k: float(v) for k, v in metrics.items()}, model.optimizer.flat_grad()


def model_minibatch(model: PPOMAE, rng: np.random.Generator, batch: int) -> dict:
    """A random minibatch of ``batch`` samples shaped as ``model``'s envs observe."""
    space = model.env.observation_space
    return random_minibatch(rng, batch, model.device, model.frame_stack, space["image"].shape[1], space["tactile"].shape[-1])


def update_errors(a: PPOMAE, b: PPOMAE, batch: int, seed: int = 0) -> dict:
    """One minibatch update of ``a`` and ``b`` (same weights, same batch and mask, over the
    modalities the features' MAE sees; none without MAE updates): the largest loss difference
    relative to the loss, the gradient difference relative to the gradient's norm, and the largest
    parameter difference after the step relative to the learning rate."""
    mask = variant_masks(b, 1, seed)[0]
    results = [update_once(m, model_minibatch(m, np.random.default_rng(seed), batch), mask) for m in (a, b)]
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


def counting_train_step(steps: list, last_end: list):
    """A ``Trainer.train_step`` that appends each step's synchronised time, the time since the end
    of the step before (``last_end[0]``: the loader and the copy), and its launches (by kernel, by
    body, with a key mask) to ``steps``."""
    train_step = Trainer.train_step

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

    return counted_step


def check_steps(name: str, steps: list, launches: tuple[int, int], body: str, masked: tuple[int, int] = (0, 0)) -> tuple[dict, dict]:
    """Fails unless every step of ``steps`` (from ``counting_train_step``) launched ``launches``
    (forward, backward) packed kernels, all on ``body``, ``masked`` of them with a key mask; returns
    the launches and the masked launches a step."""
    fwd, bwd = launches
    want = {KERNEL: fwd, BWD_KERNEL: bwd, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
    want_masked = {KERNEL: masked[0], BWD_KERNEL: masked[1]}
    bodies = ({body: fwd} if fwd else {}, {body: bwd} if bwd else {})
    for i, st in enumerate(steps):
        if st["launches"] != want or (st["fwd_bodies"], st["bwd_bodies"]) != bodies or st["masked"] != want_masked:
            fail(f"{name}: step {i} launched {st['launches']} ({st['masked']} with a key mask) on bodies {st['fwd_bodies']} / "
                 f"{st['bwd_bodies']}, expected {want} ({want_masked}) on {body}")
    return want, want_masked


def ssl_run(name: str, overrides: list, launches: tuple[int, int], body: str, ckpt: Path, epochs: int = 2, resume_check=None,
            config: str = SSL_CONFIG, masked: tuple[int, int] = (0, 0)) -> dict:
    """``cli.pretrain.main`` on the card at ``config``'s defaults plus ``overrides``: every Trainer
    step must launch ``launches`` (forward, backward) packed kernels, all on ``body``, of which
    ``masked`` carry a key mask. Returns the history, the launches, the synchronised step times
    and the peak device memory."""
    steps, train_step, try_resume = [], Trainer.train_step, Trainer._try_resume
    last_end = [time.perf_counter()]

    def checked_resume(self, module, optimizer):
        resumed = try_resume(self, module, optimizer)
        if resume_check is not None:
            resume_check(self, module, optimizer, resumed)
        last_end[0] = time.perf_counter()
        return resumed

    argv = ["--config", config, "--synthetic", str(SSL_SYNTHETIC), f"trainer.max_epochs={epochs}", f"ckpt_dir={ckpt}", *overrides]
    Trainer.train_step, Trainer._try_resume = counting_train_step(steps, last_end), checked_resume
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
    want, want_masked = check_steps(f"ssl {name}", steps, launches, body, masked)
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
        shutil.copy(ckpt / "last.ckpt", MAE_CKPT)  # the pretrained encoder of phase 11's probes
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


def dino_step(module, batch: dict, masks: tuple):
    """One Trainer step of the DINO ``module`` by hand (loss, backward, AdamW, the post-update
    hook) on ``batch`` under ``masks`` at step 0: the loss, the trainable gradients, and the state
    after it."""
    device = batch["image"].device
    module.setup_schedules(3, 2)
    module.sample_masks = lambda generator, b: tuple(m.to(device) for m in masks)
    opt = module.configure_optimizer(3, 2)
    loss, aux = module.training_loss(batch, None, 0)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone() for n, p in module.trainable_parameters().items()}
    opt.step()
    module.on_train_batch_end(aux, 0)
    return loss.item(), grads, {n: v.detach() for n, v in module.state_dict().items()}, opt


def self_distill_errors(cpu, batch: dict, masks: tuple, launches_want: tuple, label: str) -> dict:
    """One f32 step of the DINO-style module ``cpu`` and of its copy on the card, on ``batch`` under
    ``masks``: the card's step must launch ``launches_want`` (forward, backward); returns the loss
    error relative to the loss, the gradient errors relative to their norms, the parameters after
    AdamW relative to the learning rate beyond the implied Adam step difference, the teachers after
    the EMA beyond (1 - momentum) times it, and the center's absolute error."""
    card = copy.deepcopy(cpu).to("cuda")
    reset_launches()
    la, ga, sa, opt = dino_step(card, {k: v.cuda() for k, v in batch.items()}, masks)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in (KERNEL, BWD_KERNEL)}
    if launches != dict(zip((KERNEL, BWD_KERNEL), launches_want)):
        fail(f"the {label} check step launched {launches}, expected {launches_want}")
    lb, gb, sb, _ = dino_step(cpu, batch, masks)
    lr, eps = opt.learning_rate(0), opt.adamw.param_groups[0]["eps"]
    momentum = cpu._momentum_fn(0)
    grad_rel, param_per_lr, implied = step_errors(ga, gb, sa, sb, lr, eps)
    teacher_per_lr = 0.0
    for name in sb:
        if name.startswith("teacher_"):
            step = (1.0 - momentum) * implied["student_" + name[len("teacher_"):]]
            teacher_per_lr = max(teacher_per_lr, ((sa[name].cpu() - sb[name]).abs() - step).max().item() / lr)
    center_abs = (sa["center"].cpu() - sb["center"]).abs().max().item()
    return dict(loss_rel=abs(la - lb) / abs(lb), grad_rel=grad_rel, param_per_lr=param_per_lr, teacher_per_lr=teacher_per_lr,
                center_abs=center_abs, center_max=sb["center"].abs().max().item(), loss=lb, lr=lr, momentum=momentum,
                batch=batch["image"].shape[0], launches=launches)


def distill_check() -> dict:
    """(a) One f32 DINO step at full width on the card against the CPU."""
    cpu = distill_models("dino", ["model.algorithm.warmup_epochs=0"])
    enc = cpu.student_backbone
    x = torch.from_numpy(np.random.default_rng(2).random((DISTILL_CHECK_BATCH, *enc.img_size, enc.in_chans), dtype=np.float32))
    masks = cpu.sample_masks(torch.Generator().manual_seed(3), DISTILL_CHECK_BATCH)
    return self_distill_errors(cpu, {"image": x}, masks, DISTILL_LAUNCHES["dino"][0], "DINO")


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

VJEPA_CONFIG = str(EXPERIMENTS / "vjepa_vit.yaml")
VJEPA_OVERRIDES = ["data.out_format=video"]  # the tubelet encoder takes (B, T, H, W, C), not 6-channel images
VJEPA_CHECK_BATCH = 8
# Packed launches per V-JEPA Trainer step at the config's depths (forward, backward): the target
# encoder (12, no gradient), the context encoder on the 49 gathered kept tokens (12 + 12) and the
# predictor on 49 + 147 tokens (6 + 6); the token counts are fixed, so no launch carries a key mask.
VJEPA_LAUNCHES = (30, 18)
# One f32 V-JEPA step at full width, card vs CPU (TF32 off), the same weights, batch and tube
# masks: the loss and its two parts relative to their magnitudes, each trainable gradient relative
# to its norm, each trainable parameter after AdamW relative to the learning rate beyond the
# difference of Adam's first steps that the two gradients imply, and the target encoder after
# the EMA beyond (1 - momentum) times that difference, relative to the learning rate. The L1 loss
# differentiates to sign(z - h): an element of z within f32 noise of its target would flip its
# sign and move the gradients far more than the noise does; these seeds flip none (the gradients
# agree to f32 noise). On the H100 these seeds gave 7.211e-8 (about one ulp of the loss),
# 4.123e-7, 1.192e-3 (one ulp of a parameter near 1, at lr 1e-4) and 3.725e-5: the same f32
# arithmetic in another summation order; each bound is about 10x its value.
VJEPA_F32_TOL = dict(loss_rel=1e-6, grad_rel=4e-6, param_per_lr=1.2e-2, target_per_lr=4e-4)
DOWNSTREAM = EXPERIMENTS / "downstream_task"
PROBE_CHECK_BATCH = 8
# One f32 ForceSLModule step at full width (the frozen ViT-small of phase 9's checkpoint, the
# attentive probe), card vs CPU (TF32 off), the same weights and batch: the loss and the three
# RMSEs relative to their magnitudes, each probe gradient relative to its norm, each probe
# parameter after AdamW relative to the learning rate beyond the difference of Adam's first steps
# that the two gradients imply. On the H100 these seeds gave 1.131e-7, 0 (the RMSEs equal),
# 6.288e-6 (the frozen encoder's tokens differ by f32 noise through 12 layers, and the probe's
# gradients carry it) and 1.191e-3 (one ulp of a parameter near 1, at lr 1e-4); the bounds are
# about ten ulps of the loss and of the RMSEs and ~10x the other two.
PROBE_F32_TOL = dict(loss_rel=1e-6, rmse_rel=1e-6, grad_rel=6e-5, param_per_lr=1.2e-2)


def step_errors(ga: dict, gb: dict, sa: dict, sb: dict, lr: float, eps: float):
    """(gradient error over its norm, parameter error over lr beyond the implied Adam step, the
    implied steps) of the card's gradients ``ga`` and state ``sa`` against the CPU's."""
    implied, grad_rel, param_per_lr = {}, 0.0, 0.0
    for name, g in gb.items():
        a = ga[name].cpu()
        grad_rel = max(grad_rel, ((a - g).norm() / g.norm()).item() if g.norm() > 0 else (float("inf") if a.norm() > 0 else 0.0))
        implied[name] = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        param_per_lr = max(param_per_lr, ((sa[name].cpu() - sb[name]).abs() - implied[name]).max().item() / lr)
    return grad_rel, param_per_lr, implied


def vjepa_step(module, x: torch.Tensor, keeps: torch.Tensor):
    """One Trainer step of the V-JEPA ``module`` by hand (loss, backward, AdamW, the EMA) on ``x``
    under the tube masks ``keeps`` at step 0: the loss parts, the trainable gradients (zero where
    a parameter is unused: the predictor's patch embedding), and the state after it."""
    module.setup_schedules(3, 2)
    module.sample_masks = lambda generator, batch: keeps.to(x.device)
    opt = module.configure_optimizer(3, 2)
    loss, aux = module.training_loss({"image": x}, None, 0)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone() for n, p in module.trainable_parameters().items()}
    opt.step()
    module.on_train_batch_end(aux, 0)
    return {k: aux[k].item() for k in ("loss", "loss_jepa", "loss_reg")}, grads, {n: v.detach() for n, v in module.state_dict().items()}, opt


def vjepa_check() -> dict:
    """(a) One f32 V-JEPA step at full width on the card against the CPU."""
    cpu = distill_models("vjepa", ["model.algorithm.warmup_epochs=0"])
    card = copy.deepcopy(cpu).to("cuda")
    enc = cpu.context_encoder
    x = torch.from_numpy(np.random.default_rng(4).random((VJEPA_CHECK_BATCH, enc.num_frames, *enc.img_size, enc.in_chans), dtype=np.float32))
    keeps = cpu.sample_masks(torch.Generator().manual_seed(5), VJEPA_CHECK_BATCH)
    reset_launches()
    la, ga, sa, opt = vjepa_step(card, x.cuda(), keeps)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in (KERNEL, BWD_KERNEL)}
    if launches != dict(zip((KERNEL, BWD_KERNEL), VJEPA_LAUNCHES)) or any(MASKED_LAUNCHES.values()):
        fail(f"the V-JEPA check step launched {launches} ({dict(MASKED_LAUNCHES)} with a key mask), expected {VJEPA_LAUNCHES} unmasked")
    lb, gb, sb, _ = vjepa_step(cpu, x, keeps)
    lr, eps, momentum = opt.learning_rate(0), opt.adamw.param_groups[0]["eps"], cpu._momentum_fn(0)
    grad_rel, param_per_lr, implied = step_errors(ga, gb, sa, sb, lr, eps)
    target_per_lr = 0.0
    for name in sb:
        if name.startswith("target_encoder."):
            step = (1.0 - momentum) * implied["context_encoder." + name[len("target_encoder."):]]
            target_per_lr = max(target_per_lr, ((sa[name].cpu() - sb[name]).abs() - step).max().item() / lr)
    loss_rel = max(abs(la[k] - lb[k]) / abs(lb[k]) for k in lb)
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, param_per_lr=param_per_lr, target_per_lr=target_per_lr, losses=lb, lr=lr,
                momentum=momentum, batch=VJEPA_CHECK_BATCH, launches=launches, n_context=cpu.n_context, n_target=cpu.n_target)


def vjepa_phase() -> dict:
    """Phase 11 (a)-(c): V-JEPA at full width, card vs CPU, then through cli.pretrain and its Trainer."""
    out = {}
    t0 = time.perf_counter()
    e = out["f32_check"] = vjepa_check()
    print(f"  vjepa (a): one f32 step at batch {VJEPA_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): losses {e['losses']}, "
          f"loss rel err {e['loss_rel']:.3e}, grad err/|grad| {e['grad_rel']:.3e}, param err/lr {e['param_per_lr']:.3e}, target err/lr "
          f"{e['target_per_lr']:.3e}; tol {VJEPA_F32_TOL}")
    if any(e[k] > VJEPA_F32_TOL[k] for k in VJEPA_F32_TOL):
        fail("the f32 V-JEPA step on the card disagrees with the CPU")
    e["tol"] = VJEPA_F32_TOL
    ckpt = CKPT_DIR / "vjepa"

    def run(label, **kw):
        r = ssl_run(label, VJEPA_OVERRIDES, VJEPA_LAUNCHES, "tf32x3", ckpt, config=VJEPA_CONFIG, **kw)
        del r["trainer"], r["module"]
        torch.cuda.empty_cache()
        return r

    try:
        out["cli"] = run("(b) V-JEPA")
        steps = out["cli"]["global_step"]  # 2 epochs
        saved = load_checkpoint(ckpt / "last.ckpt", map_location="cuda")
        if not all(any(k.startswith(p) for k in saved["model"]) for p in ("context_encoder.", "predictor.", "target_encoder.")):
            fail("the V-JEPA checkpoint lacks the context encoder, the predictor or the target encoder")
        restored = {}
        out["resume"] = run("(c) V-JEPA resume", epochs=3, resume_check=resume_checker(saved, restored))
        del saved
        if restored != dict(resumed=True, step=steps, epoch=2, model=True, moments=True, count=True) or out["resume"]["global_step"] != steps * 3 // 2:
            fail(f"V-JEPA resume: restored {restored}, ended at step {out['resume']['global_step']}")
        print(f"  vjepa (c): restored global_step {steps} and epoch 2; context encoder, predictor, target encoder and AdamW moments "
              "equal the saved ones on the card")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def probe_models(config: Path, device: str):
    """The downstream config's encoder and SL module with phase 9's pretrained encoder, warm-up 0 so
    the first step moves the probe."""
    cfg = load_config(str(config), [f"task.checkpoint_encoder={MAE_CKPT}"])
    kw = {k: v for k, v in cfg["task"].items() if k in evaluate_cli.MODULE_KEYS}
    return build_task_module(instantiate(cfg["model"]["encoder"]), "force", warmup_epochs=0, **kw).to(device)


def probe_step(module, batch: dict):
    """One optimizer step of the SL ``module`` by hand at step 0: the scalar aux values, the
    trainable gradients (zero where a parameter is unused), and the state after AdamW."""
    opt = module.configure_optimizer(3, 2)
    loss, aux = module.training_loss(batch, None, 0)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone() for n, p in module.trainable_parameters().items()}
    opt.step()
    return {k: v.item() for k, v in aux.items() if v.dim() == 0}, grads, {n: v.detach() for n, v in module.state_dict().items()}, opt


def probe_check() -> dict:
    """(f) One f32 ForceSLModule step (frozen encoder) at full width on the card against the CPU."""
    cpu = probe_models(DOWNSTREAM / "force" / "digit_mae.yaml", "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    enc = cpu.model_encoder.encoder
    rng = np.random.default_rng(6)
    batch = {"image": rng.random((PROBE_CHECK_BATCH, *enc.img_size, enc.in_chans), dtype=np.float32),
             "force": rng.uniform(-1, 1, (PROBE_CHECK_BATCH, 3)).astype(np.float32),
             "force_scale": np.tile(np.float32([[5.0, 5.0, 10.0]]), (PROBE_CHECK_BATCH, 1))}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    encoder_before = {k: v.clone() for k, v in card.model_encoder.state_dict().items()}
    reset_launches()
    la, ga, sa, opt = probe_step(card, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in (KERNEL, BWD_KERNEL)}
    if launches != {KERNEL: 12, BWD_KERNEL: 0}:
        fail(f"the frozen probe step launched {launches}, expected 12 forward and no backward")
    if not all(torch.equal(v, encoder_before[k]) for k, v in card.model_encoder.state_dict().items()):
        fail("the frozen probe step moved the encoder on the card")
    lb, gb, sb, _ = probe_step(cpu, batch)
    grad_rel, param_per_lr, _ = step_errors(ga, gb, sa, sb, opt.learning_rate(0), opt.adamw.param_groups[0]["eps"])
    return dict(loss_rel=abs(la["loss"] - lb["loss"]) / abs(lb["loss"]), rmse_rel=max(abs(la[k] - lb[k]) / abs(lb[k]) for k in lb if k.startswith("rmse")),
                grad_rel=grad_rel, param_per_lr=param_per_lr, aux=lb, lr=opt.learning_rate(0), batch=PROBE_CHECK_BATCH, launches=launches,
                trainable=len(gb))


def finite(value) -> bool:
    if isinstance(value, (list, tuple)):
        return all(finite(v) for v in value)
    return bool(np.isfinite(value))


def probe_run(name: str, config: Path, task: str, launches: tuple[int, int], ckpt: Path, encoder_want: dict) -> dict:
    """``cli.evaluate.main`` on the card at ``config`` with phase 9's encoder, 197 frames, 2 epochs:
    every Trainer step must launch ``launches`` (forward, backward) packed kernels on the tf32x3
    bodies and every evaluation batch 12 forward; the encoder must equal ``encoder_want`` when it
    is loaded and, frozen, after training (fine-tuned, it must move); the metrics must be finite."""
    steps, evals, fits = [], [], []
    train_step, fit, predict = Trainer.train_step, Trainer.fit, TestTaskSL.predict
    last_end = [time.perf_counter()]

    def recording_fit(self, module, loader, *args, **kw):
        loaded = module.model_encoder.encoder.state_dict()
        fits.append(dict(loaded=all(torch.equal(loaded[k], v) for k, v in encoder_want.items()) and sorted(loaded) == sorted(encoder_want)))
        last_end[0] = time.perf_counter()
        history = fit(self, module, loader, *args, **kw)
        fits[-1].update(trainer=self, module=module, history=history)
        return history

    def counted_predict(self, batch):
        start = Counter(LAUNCHES)
        t0 = time.perf_counter()
        out = predict(self, batch)  # returns numpy: synchronised
        evals.append(dict(ms=(time.perf_counter() - t0) * 1e3, launches={k: LAUNCHES[k] - start[k] for k in ALL_KERNELS}))
        return out

    argv = ["--config", str(config), "--task", task, "--synthetic", str(SSL_SYNTHETIC), "--epochs", "2", f"ckpt_dir={ckpt}",
            f"task.checkpoint_encoder={MAE_CKPT}"]
    Trainer.train_step, Trainer.fit, TestTaskSL.predict = counting_train_step(steps, last_end), recording_fit, counted_predict
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        metrics = evaluate_cli.main(argv)
    finally:
        Trainer.train_step, Trainer.fit, TestTaskSL.predict = train_step, fit, predict
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    (run,) = fits
    module, history = run["module"], run["history"]
    fwd, bwd = launches
    want, _ = check_steps(f"evaluate {name}", steps, launches, "tf32x3")
    want_eval = {KERNEL: 12, BWD_KERNEL: 0, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
    if not evals or any(ev["launches"] != want_eval for ev in evals):
        fail(f"evaluate {name}: evaluation batches launched {[ev['launches'] for ev in evals]}, expected {want_eval} each")
    trained = module.model_encoder.encoder.state_dict()
    kept = all(torch.equal(trained[k].cpu(), v) for k, v in encoder_want.items())
    frozen = bwd == 0
    if not run["loaded"] or kept != frozen or module.train_encoder == frozen:
        fail(f"evaluate {name}: encoder loaded equal {run['loaded']}, equal after training {kept}, train_encoder {module.train_encoder}")
    scalars = {k: v for k, v in metrics.items() if not isinstance(v, list)}
    losses = [h["train_loss"] for h in history]
    if len(steps) != 6 or not finite(losses) or not all(finite(v) for v in scalars.values()):
        fail(f"evaluate {name}: {len(steps)} steps, losses {losses}, metrics {scalars}")
    timed = steps[1:]  # the first step pays cuBLAS set-up and allocation
    step_s = statistics.mean(st["step_s"] for st in timed)
    out = dict(main_s=main_s, steps=len(steps), losses=losses, metrics=scalars, launches={k: LAUNCHES[k] for k in ALL_KERNELS},
               launches_per_step=want, launches_per_eval_batch=want_eval, eval_batches=len(evals), encoder_loaded_equal=run["loaded"],
               encoder_equal_after=kept, step_ms=[st["step_s"] * 1e3 for st in steps], fetch_ms=[st["fetch_s"] * 1e3 for st in steps],
               eval_ms=[ev["ms"] for ev in evals], steps_per_s=1.0 / step_s, images_per_s=SSL_BATCH / step_s, batch=SSL_BATCH,
               max_memory_allocated=peak)
    print(f"  evaluate {name}: main() {main_s:.1f} s, {len(steps)} steps, losses {[round(v, 4) for v in losses]}; probe step "
          f"{step_s * 1e3:.2f} ms ({out['steps_per_s']:.2f} steps/s, {out['images_per_s']:.1f} images/s, first step excluded); loader + copy "
          f"{statistics.median(out['fetch_ms'][1:]):.1f} ms median; evaluation {statistics.median(out['eval_ms']):.2f} ms a batch of "
          f"{SSL_BATCH} ({len(evals)} batches); {fwd} + {bwd} launches a step, 12 an evaluation batch; encoder loaded equal, "
          f"{'unchanged' if kept else 'moved'} after training; peak memory {peak / 2**30:.2f} GiB; metrics "
          f"{ {k: v for k, v in scalars.items() if k in ('rmse', 'accuracy', 'balanced_accuracy')} }")
    return out


def evaluate_phase() -> dict:
    """Phase 11 (d)-(f): the downstream probes over phase 9's pretrained encoder through cli.evaluate."""
    out = {}
    t0 = time.perf_counter()
    e = out["f32_check"] = probe_check()
    print(f"  evaluate (f): one f32 frozen force-probe step at batch {PROBE_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): "
          f"loss rel err {e['loss_rel']:.3e}, rmse rel err {e['rmse_rel']:.3e}, grad err/|grad| {e['grad_rel']:.3e}, param err/lr "
          f"{e['param_per_lr']:.3e}; 12 + 0 launches, the encoder unchanged; tol {PROBE_F32_TOL}")
    if any(e[k] > PROBE_F32_TOL[k] for k in PROBE_F32_TOL):
        fail("the f32 probe step on the card disagrees with the CPU")
    e["tol"] = PROBE_F32_TOL
    saved = load_checkpoint(MAE_CKPT)["model"]
    encoder_want = {k[len("encoder."):]: v for k, v in saved.items() if k.startswith("encoder.")}
    ckpt = CKPT_DIR / "evaluate"
    try:
        out["force"] = probe_run("(d) force, frozen", DOWNSTREAM / "force" / "digit_mae.yaml", "force", (12, 0), ckpt / "force", encoder_want)
        out["slip"] = probe_run("(e) slip, frozen", DOWNSTREAM / "slip" / "digit_mae.yaml", "slip", (12, 0), ckpt / "slip", encoder_want)
        out["e2e"] = probe_run("(e) force, fine-tuned", DOWNSTREAM / "force" / "digit_e2e.yaml", "force", (12, 12), ckpt / "e2e", encoder_want)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out



FORCEFIELD = DOWNSTREAM / "forcefield"
FF_CHECK_BATCH, FF_BATCH = 4, 64
# the encoder of phase 9's MAE checkpoint: no register token, the "encoder" subtree
FF_MAE = ["task.encoder_type=mae", "model.encoder.num_register_tokens=0", f"task.checkpoint_encoder={MAE_CKPT}"]
# Packed launches per force-field Trainer step at ViT-small (forward, backward): two decoder passes
# (forward_fields: the normal on image_bg, the shear on image), each through all 12 blocks; a
# frozen encoder runs them without autograd.
FF_LAUNCHES = {"frozen": (24, 0), "e2e": (24, 24)}
# One f32 GeometricForceFieldModule step at full width (ViT-small on 224 x 224 x 6, hooks (2, 5, 8,
# 11), the DPT decoder at fusion 128 up to 112 x 112, the pose ResNet-18), card vs CPU (TF32 off),
# the same weights and batch: the loss and each part relative to its magnitude, each trainable
# gradient relative to its norm, each trainable parameter after AdamW relative to the learning rate
# beyond the difference of Adam's first steps that the two gradients imply. The reprojection term's
# SSIM, var = E[x^2] - E[x]^2 over 3 x 3 windows of smooth gel images, keeps ~1e-3 of f32 rounding
# in its map and its gradient on any device, and the pose network's and the disparity's gradients
# reach the loss only through it. On the H100 these seeds gave 1.096e-4 (1.176e-4 in another
# call), 7.665e-5 and 1.189e-3; the CPU's own f32 step lies 5.495e-5, 1.669e-5 and 1.192e-3 from
# the same step with its SSIM in f64 (chip_numerics.py), so the card's error is f32 rounding of
# that size. The bounds are ~2.5x the card's readings (the parameter's ~10x, one ulp near 1 at lr
# 1e-4); cuDNN's TF32 in the decoder's convolutions put the gradients at 1.0e-2 (chip_numerics.py),
# and a wrong SSIM window backward at 3.5e-2.
FF_F32_TOL = dict(loss_rel=2.5e-4, grad_rel=2e-4, param_per_lr=1.2e-2)
# The demo's bf16 model and the bf16 VTDINO recipe against the same model, weights and inputs with
# the attention's plain version (f32 softmax, probabilities rounded to bf16) in place of the
# kernels: the demo's 30 frames of fields relative to their norm; the recipe's first loss relative
# to its magnitude and its flat trainable gradient relative to its norm. The two differ by bf16
# rounding in the attention, carried through bf16 layers, so these are coarse checks. On the H100
# these seeds gave 4.680e-3 (fields), 4.233e-5 and 4.026e-3 (the recipe); the bounds are ~2x and
# ~3x that. The plain attention with a fault in place of the kernel, on the same model
# (chip_numerics.py): the register key dropped from every row gave 1.077e-2 (fields), 5.309e-4 and
# 1.227e-1 (the recipe); the softmax scale doubled 2.344e-2, 5.404e-4 and 1.896e-1; the recipe's
# key masks ignored 2.501e-2 and 5.505e-1. The last patch key dropped stays inside bf16's noise
# (7.532e-3; 1.051e-4 and 7.686e-3): phase 3 holds the kernels element by element at these shapes.
DEMO_BF16_TOL = dict(field_rel=9e-3)
VTDINO_BF16_TOL = dict(loss_rel=1.5e-4, grad_rel=1.2e-2)
# VTDINO at MultimodalVTT's and VTDINOModule's defaults (dim 384, depth 4, 6 heads x 64, 70 x 70 at
# patch 14 so 25 patches a modality and 76 tokens, the 65536-wide head, no probe), f32: forward,
# the student's global and local passes and the teacher's global pass (4 each, all key-masked);
# backward, the student's two passes. With the probe (the bf16 recipe): plus the teacher's full
# pass (4, unmasked) and the probe decoder (2 + 2).
VTDINO_LAUNCHES = {"f32": ((12, 8), (12, 8)), "bf16": ((18, 10), (12, 8))}
VTDINO_CHECK_BATCH, VTDINO_BATCH, VTDINO_BF16_BATCH = 8, 64, 256
# one f32 VTDINO step card vs CPU: the quantities of DISTILL_F32_TOL
VTDINO_F32_TOL = dict(loss_rel=1e-6, grad_rel=2e-5, param_per_lr=1.2e-2, teacher_per_lr=7e-4, center_abs=1.2e-7)
# the multimodal transformer (three modalities: 196 tokens of 768 and two of 49 x 256; ViT-base
# width, 12 heads x 64, one register token, 4 blocks), f32 forward and backward card vs CPU: the
# patch tokens absolute, each gradient relative to its norm
MM_F32_TOL = dict(out_abs=5e-5, grad_rel=2e-5)  # ~10x the 5.603e-6 and 1.820e-6 measured on the H100


def forcefield_module(config: Path, overrides, device):
    """The force-field config's encoder and GeometricForceFieldModule (f32, seeded weights)."""
    cfg = load_config(str(config), list(overrides))
    return instantiate(cfg["task"])(instantiate(cfg["model"]["encoder"])).to(device)


def forcefield_data(n_traj: int, traj_len: int, size: int, seed: int) -> dict:
    """Force-field windows (image, image_bg, mask, force) of synthetic DIGIT trajectories."""
    w = forcefield_windows(synth_digit_trajectories(n_traj, traj_len, size=size, seed=seed))
    return {k: w[k] for k in ("image", "image_bg", "mask", "force")}


@contextlib.contextmanager
def plain_attention():
    """The packed attention's plain PyTorch versions in place of its kernels on the card (nothing
    launched, nothing counted): the reference a bf16 path is held to."""
    launch, launch_bwd = fa._launch, fa._launch_bwd
    fa._launch, fa._launch_bwd = fa._fwd_plain, fa._bwd_plain
    try:
        yield
    finally:
        fa._launch, fa._launch_bwd = launch, launch_bwd


def forcefield_check() -> dict:
    """(a) One f32 GeometricForceFieldModule step (frozen ViT-small) at full width on the card
    against the CPU, on synthetic DIGIT windows at 224 x 224."""
    cpu = forcefield_module(FORCEFIELD / "digit_dino.yaml", ["task.warmup_epochs=0"], "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = {k: torch.from_numpy(v[:FF_CHECK_BATCH]) for k, v in forcefield_data(1, FF_CHECK_BATCH + 1, 224, 7).items()}
    encoder_before = {k: v.clone() for k, v in card.model_task.encoder.state_dict().items()}
    reset_launches()
    la, ga, sa, opt = probe_step(card, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in (KERNEL, BWD_KERNEL)}
    if launches != dict(zip((KERNEL, BWD_KERNEL), FF_LAUNCHES["frozen"])):
        fail(f"the frozen force-field check step launched {launches}, expected {FF_LAUNCHES['frozen']}")
    if not all(torch.equal(v, encoder_before[k]) for k, v in card.model_task.encoder.state_dict().items()):
        fail("the frozen force-field step moved the encoder on the card")
    lb, gb, sb, _ = probe_step(cpu, batch)
    lr = opt.learning_rate(0)
    grad_rel, param_per_lr, _ = step_errors(ga, gb, sa, sb, lr, opt.adamw.param_groups[0]["eps"])
    return dict(loss_rel=max(abs(la[k] - lb[k]) / abs(lb[k]) for k in lb), grad_rel=grad_rel, param_per_lr=param_per_lr,
                losses=lb, lr=lr, batch=FF_CHECK_BATCH, launches=launches, trainable=len(gb))


def held(e: dict, tol: dict) -> dict:
    """Each error of ``e`` over its tolerance in ``tol``."""
    return {k: e[k] / tol[k] for k in tol}


def forcefield_run(name: str, config: Path, overrides: list, launches: tuple[int, int], data: dict, encoder_want: dict, ckpt: Path) -> dict:
    """The force-field config's module over phase 9's encoder through the Trainer on the card: every
    step must launch ``launches`` (forward, backward) on the 3xTF32 bodies, unmasked; the encoder
    equals ``encoder_want`` when loaded and, frozen, after training (fine-tuned, it moves)."""
    cfg = load_config(str(config), [*FF_MAE, f"ckpt_dir={ckpt}", "trainer.max_epochs=1", *overrides])
    trainer = instantiate(cfg["trainer"], device="cuda")
    module = instantiate(cfg["task"])(instantiate(cfg["model"]["encoder"]))
    loaded = module.model_task.encoder.state_dict()
    loaded_equal = sorted(loaded) == sorted(encoder_want) and all(torch.equal(loaded[k], v) for k, v in encoder_want.items())
    loader = DataLoader(ArrayDataset(data), batch_size=FF_BATCH)
    steps, train_step = [], Trainer.train_step
    last_end = [time.perf_counter()]
    Trainer.train_step = counting_train_step(steps, last_end)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        history = trainer.fit(module, loader)
    finally:
        Trainer.train_step = train_step
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = launches
    want, _ = check_steps(f"forcefield {name}", steps, launches, "tf32x3")
    trained = module.model_task.encoder.state_dict()
    kept = all(torch.equal(trained[k].cpu(), v) for k, v in encoder_want.items())
    losses = [h["train_loss"] for h in history]
    if not loaded_equal or kept != (bwd == 0) or not steps or not finite(losses):
        fail(f"forcefield {name}: encoder loaded equal {loaded_equal}, equal after training {kept}, {len(steps)} steps, losses {losses}")
    timed = steps[1:] or steps  # the first step pays cuDNN's algorithm search and allocation
    step_s = statistics.mean(st["step_s"] for st in timed)
    out = dict(steps=len(steps), losses=losses, launches={k: LAUNCHES[k] for k in ALL_KERNELS}, launches_per_step=want,
               encoder_loaded_equal=loaded_equal, encoder_equal_after=kept, step_ms=[st["step_s"] * 1e3 for st in steps],
               fetch_ms=[st["fetch_s"] * 1e3 for st in steps], steps_per_s=1.0 / step_s, images_per_s=FF_BATCH / step_s, batch=FF_BATCH,
               max_memory_allocated=peak)
    print(f"  forcefield {name}: {len(steps)} steps, losses {[round(v, 4) for v in losses]}; step {step_s * 1e3:.2f} ms "
          f"({out['images_per_s']:.1f} images/s at batch {FF_BATCH}{', first step excluded' if len(steps) > 1 else ''}); loader + copy "
          f"{statistics.median(out['fetch_ms']):.1f} ms median; {fwd} + {bwd} launches a step on tf32x3; encoder loaded equal, "
          f"{'unchanged' if kept else 'moved'} after training; peak memory {peak / 2**30:.2f} GiB")
    return out


def demo_bf16() -> dict:
    """(c) The demo's model (dim 192, depth 6, 3 heads, hooks 1,3,4,5, fusion 64, bf16, 96 x 96) on the
    card: forward_fields over 30 synthetic frames one at a time, as the demo loop runs them."""
    args = SimpleNamespace(dim=192, depth=6, heads=3, hooks="1,3,4,5", fusion_ch=64, dtype="bfloat16")
    module = demo_cli._build_module_structure(args, 96).to("cuda").eval()
    w = forcefield_data(1, 31, 96, 99)
    x, xb = (torch.from_numpy(w[k]).cuda().float() / 255.0 for k in ("image", "image_bg"))
    reset_launches()
    frame_ms, fields = [], []
    with torch.no_grad():
        for i in range(len(x)):
            t0 = time.perf_counter()
            disp, shear = module.forward_fields(x[i : i + 1], xb[i : i + 1])
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            fields.append(torch.cat([disp, shear], -1))
    field = torch.cat(fields)
    launches = {k: LAUNCHES[k] for k in ALL_KERNELS}
    want = {KERNEL: 2 * args.depth * len(x), BWD_KERNEL: 0, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
    if launches != want or dict(FWD_BODY_LAUNCHES) != {"tensor_core": want[KERNEL]}:
        fail(f"the bf16 demo model launched {launches} on {dict(FWD_BODY_LAUNCHES)}, expected {want} on the tensor cores")
    if field.shape != (len(x), 96, 96, 3) or not torch.isfinite(field).all():
        fail(f"the bf16 demo fields: shape {tuple(field.shape)}, finite {bool(torch.isfinite(field).all())}")
    with torch.no_grad(), plain_attention():
        plain = torch.cat([torch.cat(module.forward_fields(x[i : i + 1], xb[i : i + 1]), -1) for i in range(len(x))])
    diff = field.float() - plain.float()
    e = dict(field_rel=(diff.norm() / plain.float().norm()).item())
    out = dict(frames=len(x), launches=launches, frame_ms=frame_ms, field_abs_max=field.abs().max().item(), **e,
               field_abs=diff.abs().max().item(), tol=DEMO_BF16_TOL, err_per_tol=held(e, DEMO_BF16_TOL))
    print(f"  forcefield (c) bf16 demo model: {len(x)} frames, {launches[KERNEL]} launches on the tensor cores, finite fields (|max| "
          f"{out['field_abs_max']:.3f}); against the same model on the plain attention {e['field_rel']:.3e} of their norm (tol "
          f"{DEMO_BF16_TOL['field_rel']}), {out['field_abs']:.3e} absolute; {statistics.median(frame_ms[1:]):.2f} ms a frame (median, first excluded)")
    if e["field_rel"] > DEMO_BF16_TOL["field_rel"]:
        fail("the bf16 demo model's fields disagree with the same model on the plain attention")
    return out


def forcefield_phase() -> dict:
    """Phase 12 (a)-(c): the force-field task at full width."""
    out = {}
    t0 = time.perf_counter()
    e = out["f32_check"] = forcefield_check()
    e["tol"], e["err_per_tol"] = FF_F32_TOL, held(e, FF_F32_TOL)
    print(f"  forcefield (a): one f32 frozen step at batch {FF_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): losses "
          f"{ {k: round(v, 5) for k, v in e['losses'].items()} }, loss rel err {e['loss_rel']:.3e}, grad err/|grad| {e['grad_rel']:.3e}, "
          f"param err/lr {e['param_per_lr']:.3e}; err/tol {json.dumps({k: round(v, 3) for k, v in e['err_per_tol'].items()})}; "
          f"{FF_LAUNCHES['frozen']} launches, the encoder unchanged; tol {FF_F32_TOL}")
    if any(e[k] > FF_F32_TOL[k] for k in FF_F32_TOL):
        fail("the f32 force-field step on the card disagrees with the CPU")
    saved = load_checkpoint(MAE_CKPT)["model"]
    encoder_want = {k[len("encoder."):]: v for k, v in saved.items() if k.startswith("encoder.")}
    t0 = time.perf_counter()
    data = forcefield_data(4, 49, 224, 11)  # 192 windows: 3 batches of 64
    out["data_s"] = time.perf_counter() - t0
    try:
        out["frozen"] = forcefield_run("(b) digit_dino, frozen", FORCEFIELD / "digit_dino.yaml", [], FF_LAUNCHES["frozen"], data, encoder_want,
                                       CKPT_DIR / "forcefield" / "frozen")
        two = {k: v[: 2 * FF_BATCH] for k, v in data.items()}  # two steps: the first pays cuDNN's algorithm search
        out["e2e"] = forcefield_run("(b) digit_e2e, fine-tuned", FORCEFIELD / "digit_e2e.yaml", ["task.warmup_epochs=0"], FF_LAUNCHES["e2e"], two,
                                    encoder_want, CKPT_DIR / "forcefield" / "e2e")
    finally:
        shutil.rmtree(CKPT_DIR / "forcefield", ignore_errors=True)
    out["demo_bf16"] = demo_bf16()
    return out


def vtdino_batch(b: int, seed: int, image=(70, 70, 3), tactile=(70, 70, 3)) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.random((b, *image), dtype=np.float32), **{f"tactile{i}": rng.random((b, *tactile), dtype=np.float32) for i in (1, 2)}}


def vtdino_run(name: str, module, batches: list, launches: tuple, masked: tuple, body: str) -> dict:
    """``module`` through the Trainer on the card, one epoch over ``batches``: every step must launch
    ``launches`` (forward, backward), ``masked`` of them with a key mask, all on ``body``."""
    steps, train_step = [], Trainer.train_step
    last_end = [time.perf_counter()]
    Trainer.train_step = counting_train_step(steps, last_end)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        history = Trainer(max_epochs=1, verbose=0, device="cuda").fit(module, batches)
    finally:
        Trainer.train_step = train_step
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = launches
    want, want_masked = check_steps(f"vtdino {name}", steps, launches, body, masked)
    losses = [h["train_loss"] for h in history]
    if len(steps) != len(batches) or not finite(losses) or not module.center.abs().max().item() > 0:
        fail(f"vtdino {name}: {len(steps)} steps, losses {losses}, |center| max {module.center.abs().max().item()}")
    b = batches[0]["image"].shape[0]
    timed = steps[1:] or steps
    step_s = statistics.mean(st["step_s"] for st in timed)
    out = dict(steps=len(steps), losses=losses, launches={k: LAUNCHES[k] for k in ALL_KERNELS}, launches_per_step=want,
               masked_per_step=want_masked, body=body, step_ms=[st["step_s"] * 1e3 for st in steps], steps_per_s=1.0 / step_s,
               samples_per_s=b / step_s, batch=b, max_memory_allocated=peak)
    print(f"  vtdino {name}: {len(steps)} steps at batch {b}, losses {[round(v, 4) for v in losses]}; step {step_s * 1e3:.2f} ms "
          f"({out['samples_per_s']:.1f} samples/s{', first step excluded' if len(steps) > 1 else ''}); {fwd} + {bwd} launches a step on "
          f"{body}, {masked[0]} + {masked[1]} with a key mask; peak memory {peak / 2**30:.2f} GiB")
    return out


def vtdino_bf16_check(module, batch: dict) -> dict:
    """(d) The bf16 recipe's loss and flat trainable gradient on ``batch`` with the kernels, against
    the same step of the same weights under the same masks with the attention's plain version."""
    twin = copy.deepcopy(module).to("cuda")
    x = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    masks = twin.sample_masks(torch.Generator(device="cuda").manual_seed(40), x["image"].shape[0])
    twin.sample_masks = lambda generator, b: masks
    steps = []
    for plain in (False, True):
        with plain_attention() if plain else contextlib.nullcontext():
            loss, _ = twin.training_loss(x, None, 0)
            loss.backward()
        grads = [p.grad.float().flatten() for p in twin.trainable_parameters().values() if p.grad is not None]
        steps.append((loss.item(), torch.cat(grads)))
        twin.zero_grad(set_to_none=True)
    (la, ga), (lb, gb) = steps
    e = dict(loss_rel=abs(la - lb) / abs(lb), grad_rel=((ga - gb).norm() / gb.norm()).item())
    return dict(e, loss=lb, grad_norm=gb.norm().item(), tol=VTDINO_BF16_TOL, err_per_tol=held(e, VTDINO_BF16_TOL))


def mm_transformer_check() -> dict:
    """(e) The multimodal transformer, shared and factored attention, f32 forward and backward on the
    card against the CPU, with its launches."""
    out = {}
    dims, lens = [768, 256, 256], [196, 49, 49]
    rng = np.random.default_rng(12)
    xs = [torch.from_numpy(rng.normal(size=(4, n, d)).astype(np.float32)) for d, n in zip(dims, lens)]
    cot = torch.from_numpy(rng.normal(size=(4, sum(lens), 768)).astype(np.float32))
    for shared in (True, False):
        cpu = _seeded(0, lambda: MultimodalTransformer(dims, lens, 768, depth=4, num_heads=12, num_register_tokens=1, shared_attn=shared))
        card = copy.deepcopy(cpu).to("cuda")
        reset_launches()
        got = card([x.cuda() for x in xs])
        (got * cot.cuda()).sum().backward()
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in ALL_KERNELS}
        n = 4 if shared else 12
        want = {KERNEL: n, BWD_KERNEL: n, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
        if launches != want or dict(FWD_BODY_LAUNCHES) != {"tf32x3": n} or dict(BWD_BODY_LAUNCHES) != {"tf32x3": n}:
            fail(f"the multimodal transformer ({'shared' if shared else 'factored'}) launched {launches}, expected {want} on tf32x3")
        ref = cpu(xs)
        (ref * cot).sum().backward()
        out_abs = (got.detach().cpu() - ref.detach()).abs().max().item()
        grad_rel = max(((a.grad.cpu() - b.grad).norm() / b.grad.norm()).item() for a, b in zip(card.parameters(), cpu.parameters()))
        e = dict(out_abs=out_abs, grad_rel=grad_rel, launches=launches)
        e["err_per_tol"] = held(e, MM_F32_TOL)
        print(f"  vtdino (e) multimodal transformer, {'shared' if shared else 'factored'} attention: {n} + {n} launches; out abs err "
              f"{out_abs:.3e}, grad err/|grad| {grad_rel:.3e}; err/tol {json.dumps({k: round(v, 3) for k, v in e['err_per_tol'].items()})}; "
              f"tol {MM_F32_TOL}")
        if any(e[k] > MM_F32_TOL[k] for k in MM_F32_TOL):
            fail("the multimodal transformer on the card disagrees with the CPU")
        out["shared" if shared else "factored"] = e
    return out


def vtdino_phase() -> dict:
    """Phase 12 (d)-(e): VTDINO on the multimodal VTT, then the multimodal transformer."""
    out = {}
    t0 = time.perf_counter()
    cpu = _seeded(0, lambda: VTDINOModule(MultimodalVTT(), warmup_epochs=0))
    masks = cpu.sample_masks(torch.Generator().manual_seed(9), VTDINO_CHECK_BATCH)
    batch = {k: torch.from_numpy(v) for k, v in vtdino_batch(VTDINO_CHECK_BATCH, 10).items()}
    e = out["f32_check"] = self_distill_errors(cpu, batch, masks, VTDINO_LAUNCHES["f32"][0], "VTDINO")
    e["err_per_tol"] = held(e, VTDINO_F32_TOL)
    print(f"  vtdino (d): one f32 step at batch {VTDINO_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): loss rel err "
          f"{e['loss_rel']:.3e}, grad err/|grad| {e['grad_rel']:.3e}, param err/lr {e['param_per_lr']:.3e}, teacher err/lr "
          f"{e['teacher_per_lr']:.3e}, center abs err {e['center_abs']:.3e}; err/tol {json.dumps({k: round(v, 3) for k, v in e['err_per_tol'].items()})}; "
          f"tol {VTDINO_F32_TOL}")
    if any(e[k] > VTDINO_F32_TOL[k] for k in VTDINO_F32_TOL):
        fail("the f32 VTDINO step on the card disagrees with the CPU")
    e["tol"] = VTDINO_F32_TOL
    del cpu
    (fwd, bwd), masked = VTDINO_LAUNCHES["f32"]
    module = _seeded(1, lambda: VTDINOModule(MultimodalVTT()))
    out["f32"] = vtdino_run("(d) f32 defaults", module, [vtdino_batch(VTDINO_BATCH, 20 + i) for i in range(3)], (fwd, bwd), masked, "tf32x3")
    del module
    torch.cuda.empty_cache()
    # scripts/vtdino_experiment.py's recipe: 64 x 64 images and 32 x 32 tactile maps at frame stack 2
    # (what vt_load gives it), dim 128, depth 4, 4 heads x 64, the probe, bf16, batch 256
    recipe = _seeded(2, lambda: VTDINOModule(
        MultimodalVTT(image_size=(64, 64), tactile_size=(32, 32), image_patch_size=8, tactile_patch_size=4, dim=128, depth=4, heads=4,
                      mlp_dim=256, num_tactiles=2, frame_stack=2, num_register_tokens=1, dtype=torch.bfloat16),
        dino_out_dim=4096, dino_hidden_dim=1024, dino_bottleneck_dim=128, num_global_masks=1, num_local_masks=4,
        moving_average_decay=(0.99, 0.999), teacher_warmup_epochs=2, warmup_epochs=2, base_lr=5e-4, with_reconstruction_probe=True,
        dtype=torch.bfloat16))
    launches, masked = VTDINO_LAUNCHES["bf16"]
    batches = [vtdino_batch(VTDINO_BF16_BATCH, 30 + i, (64, 64, 6), (32, 32, 6)) for i in range(2)]
    e = out["bf16_check"] = vtdino_bf16_check(recipe, batches[0])
    print(f"  vtdino (d): the bf16 recipe's first batch against the plain attention: loss {e['loss']:.5f}, rel err {e['loss_rel']:.3e}, "
          f"grad err/|grad| {e['grad_rel']:.3e}; err/tol {json.dumps({k: round(v, 3) for k, v in e['err_per_tol'].items()})}; tol {VTDINO_BF16_TOL}")
    if any(e[k] > VTDINO_BF16_TOL[k] for k in VTDINO_BF16_TOL):
        fail("the bf16 VTDINO recipe disagrees with the same step on the plain attention")
    out["bf16"] = vtdino_run("(d) bf16 recipe", recipe, batches, launches, masked, "tensor_core")
    del recipe
    torch.cuda.empty_cache()
    out["multimodal_transformer"] = mm_transformer_check()
    return out


VARIANT_CLIS = ("traindino", "train_dino_cat_mae", "train_dino_tac_mae", "train_cnn")
# Packed launches of each variant at its CLI's defaults: ((forward, backward) a minibatch update,
# forward a policy step). traindino: the frozen ViT-S/14 (12 layers, forward only, on B x 3 crops of
# 1 CLS + 4 registers + 25 patches) and the post transformer over the 3 crop features (1 + 1). The
# fusion variants: the VTT encoder (4) on the 75 tokens (tactile-only: 50) and the post (1) for the
# policy, the frozen DINO (12) on the middle frame, the MAE encoder (4) on the 15 (10) kept tokens
# and the decoder (3) on 75 (50); the backward skips the DINO. The CNN variant: the flagship's
# 12 + 12 through the shared pipeline, but a policy step runs the post transformer alone over the
# raw conv tokens. train() adds one policy step's forwards for the last values.
VARIANT_LAUNCHES = {"traindino": ((13, 1), 13), "train_dino_cat_mae": ((24, 12), 17), "train_dino_tac_mae": ((24, 12), 17),
                    "train_cnn": ((12, 12), 1)}
VARIANT_CHECK_BATCH = 64
# One f32 minibatch update of each variant's CLI model at full width, card vs CPU (TF32 off), the
# same weights (the DINO from seeded_dinov2_weights), batch and mask: each loss relative to its
# magnitude, the flat pre-clip gradient relative to its norm, the updated parameters relative to
# the learning rate (as TRAIN_F32_TOL). About 10x the values these seeds gave on the H100, the same
# in two runs (loss 1.120e-7, 1.136e-7, 1.120e-7, 1.120e-7; gradients 7.208e-7, 2.171e-7, 2.064e-7,
# 1.583e-7; parameters 1.192e-3 lr, one ulp of a parameter near 1, for the three DINO variants and
# 1.490e-4 lr for the CNN variant): the same f32 arithmetic in another summation order.
# tests/test_torch_dino_variants.py shows that one key dropped from every attention layer exceeds
# all three.
VARIANT_F32_TOL = {
    "traindino": dict(loss_rel=1.2e-6, grad_rel=7.5e-6, param_per_lr=1.2e-2),
    "train_dino_cat_mae": dict(loss_rel=1.2e-6, grad_rel=2.2e-6, param_per_lr=1.2e-2),
    "train_dino_tac_mae": dict(loss_rel=1.2e-6, grad_rel=2.1e-6, param_per_lr=1.2e-2),
    "train_cnn": dict(loss_rel=1.2e-6, grad_rel=1.6e-6, param_per_lr=1.5e-3),
}
# The CLIs' runs on the card: 2 iterations of a 1024-sample rollout (of the defaults' 32768) and
# 2 epochs (of 10) of minibatch 512; train_cnn with 8 envs (its default is 1), for speed. Every
# other flag is the CLI's default: bf16, frame stack (1 for traindino, 4 otherwise), widths,
# depths, the envs (64 for traindino, 8 for the fusion variants) in process workers.
VARIANT_ROLLOUT, VARIANT_EPOCHS, VARIANT_TIMED_UPDATES = 1024, 2, 5
# f32 reconstructions card vs CPU (TF32 off), absolute over the finite entries (pixels in [0, 1],
# losses ~0.6): about 10x the largest errors these seeds gave on the H100 (1.431e-6 early conv,
# 1.788e-6 patches).
RECON_F32_TOL = 2e-5
EVAL_MAX_STEPS = 100


def seeded_dinov2_weights(path: Path, seed: int = 0) -> str:
    """Writes a torch-hub-layout ViT-S/14 state dict for 70 x 70 crops to ``path``: the seeded init
    with every LayerScale drawn in [0.1, 0.6] (a trained DINOv2's are of that size; at the 1e-5 init
    the blocks are near the identity and the frozen features barely depend on attention)."""
    g = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    sd = dinov2_vits14(img_size=(70, 70)).state_dict()
    for k in sd:
        if k.endswith(("ls1.gamma", "ls2.gamma")):
            sd[k] = 0.1 + 0.5 * torch.rand(sd[k].shape, generator=g)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": sd}, path)
    return str(path)


def frozen_encoder(model: PPOMAE):
    """The variant's frozen DINO encoder, or None."""
    features = model.policy.features
    if isinstance(features, DinoCatMAEFeatures):
        return features.dino_encoder
    return features.encoder if isinstance(features, FrozenEncoderFeatures) else None


def variant_check(name: str, weights: str) -> dict:
    """Phase 13 (a): one f32 minibatch update of the variant's CLI model at full width, card vs CPU,
    at minibatch VARIANT_CHECK_BATCH, the frozen DINO from ``weights`` (``--dinov2_weights``); every
    launch on the 3xTF32 bodies."""
    t0 = time.perf_counter()
    argv = () if name == "train_cnn" else ("--dinov2_weights", weights)
    gpu = variant_model(name, "cuda", "float32", VARIANT_CHECK_BATCH, argv)
    cpu = variant_model(name, "cpu", "float32", VARIANT_CHECK_BATCH, argv)
    reset_launches()
    errs = update_errors(gpu, cpu, VARIANT_CHECK_BATCH)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in ALL_KERNELS if LAUNCHES[k]}
    (fwd, bwd), _ = VARIANT_LAUNCHES[name]
    bodies = {"fwd": dict(FWD_BODY_LAUNCHES), "bwd": dict(BWD_BODY_LAUNCHES)}
    tol = VARIANT_F32_TOL[name]
    print(f"  {name}: one f32 update at minibatch {VARIANT_CHECK_BATCH}, card vs CPU ({time.perf_counter() - t0:.1f} s): loss rel err "
          f"{errs['loss_rel']:.3e}, grad err/|grad| {errs['grad_rel']:.3e} (|grad| {errs['grad_norm']:.3e}), param err/lr "
          f"{errs['param_per_lr']:.3e}; tol {tol}; launches {launches}")
    if launches != {KERNEL: fwd, BWD_KERNEL: bwd} or bodies != {"fwd": {"tf32x3": fwd}, "bwd": {"tf32x3": bwd}}:
        fail(f"{name}: the f32 update launched {launches} by body {bodies}, expected {fwd} + {bwd} on tf32x3")
    if any(errs[k] > tol[k] for k in tol):
        fail(f"{name}: the f32 minibatch update on the card disagrees with the CPU")
    return dict(errs, tol=tol, minibatch=VARIANT_CHECK_BATCH, launches=launches)


def variant_cli(name: str) -> tuple[PPOMAE, dict]:
    """Phase 13 (b): ``cli.<name>.main`` on the card at its defaults (cut: VARIANT_ROLLOUT,
    VARIANT_EPOCHS, train_cnn's env count) for 2 iterations; every rollout and train() held to
    VARIANT_LAUNCHES on the tensor-core bodies, the frozen DINO bit-equal through learn."""
    import importlib

    cli = importlib.import_module(f"m3l_tpu_torch.cli.{name}")
    argv = ["--env", "FakeInsertion", "--rollout_length", str(VARIANT_ROLLOUT), "--ppo_epochs", str(VARIANT_EPOCHS),
            "--total_timesteps", str(2 * VARIANT_ROLLOUT), "--seed", "0"] + (["--n_envs", "8"] if name == "train_cnn" else [])
    (fwd, bwd), step = VARIANT_LAUNCHES[name]
    per_collect, per_train, entries = [], [], []
    collect, train, learn = PPOMAE.collect_rollouts, PPOMAE.train, PPOMAE.learn

    def counted(fn, record):
        def wrapped(self):
            start = Counter(LAUNCHES)
            out = fn(self)
            torch.cuda.synchronize()
            record.append({k: LAUNCHES[k] - start[k] for k in ALL_KERNELS})
            return out
        return wrapped

    def recorded_learn(self, *args, **kwargs):
        frozen = frozen_encoder(self)
        entries.append(dict(params=[p.detach().clone() for p in self.policy.parameters()],
                            frozen=None if frozen is None else [p.detach().clone() for p in frozen.parameters()]))
        return learn(self, *args, **kwargs)

    PPOMAE.collect_rollouts, PPOMAE.train, PPOMAE.learn = counted(collect, per_collect), counted(train, per_train), recorded_learn
    try:
        reset_launches()
        t0 = time.perf_counter()
        model = cli.main(argv)
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        PPOMAE.collect_rollouts, PPOMAE.train, PPOMAE.learn = collect, train, learn
    updates = model.n_epochs * model.n_minibatches
    want_collect = {KERNEL: step * model.n_steps, BWD_KERNEL: 0, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
    want_train = {KERNEL: fwd * updates + step, BWD_KERNEL: bwd * updates, V1_KERNEL: 0, V1_BWD_KERNEL: 0}
    if len(per_collect) != 2 or len(per_train) != 2 or any(c != want_collect for c in per_collect) or any(c != want_train for c in per_train):
        fail(f"{name}: rollouts launched {per_collect} (expected 2 of {want_collect}), train() {per_train} (expected 2 of {want_train})")
    bodies = tensor_core_only(f"cli {name}")
    m = model.last_metrics
    moved = max((p.detach() - b).abs().max().item() for p, b in zip(model.policy.parameters(), entries[0]["params"]))
    finite = all(np.isfinite(m[k]) for k in m if k != "explained_variance") and all(torch.isfinite(p).all() for p in model.policy.parameters())
    if model.iteration != 2 or not finite or not moved > 0 or (m["mae_loss"] == 0) != (name == "traindino"):
        fail(f"{name}: {model.iteration} iterations, metrics {m}, max parameter move {moved}")
    frozen = frozen_encoder(model)
    frozen_equal = frozen is None or all(torch.equal(p, b) for p, b in zip(frozen.parameters(), entries[0]["frozen"]))
    if not frozen_equal or (frozen is not None and not all(p.device.type == "cuda" for p in frozen.parameters())):
        fail(f"{name}: the frozen DINO moved through learn, or left the card")

    # milliseconds per minibatch update (bf16, minibatch 512), synchronised, after one warm-up update
    mb = model_minibatch(model, np.random.default_rng(3), model.batch_size)
    idx = torch.arange(model.batch_size, device=model.device)
    masks = variant_masks(model, VARIANT_TIMED_UPDATES + 1, seed=3)
    model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], masks[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for mask in masks[1:]:
        model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], mask)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / VARIANT_TIMED_UPDATES * 1e3
    its = [dict(collect_s=t["collect"], train_s=t["train"]) for t in model.iteration_seconds]
    samples = model.n_steps * model.n_envs
    steps_per_s = samples / its[-1]["collect_s"]
    print(f"  {name}: " + "; ".join(f"collect {i['collect_s']:.2f} s, train {i['train_s']:.2f} s" for i in its)
          + f"; main() {seconds:.1f} s; {model.n_envs} envs, {steps_per_s:.1f} env-steps/s collecting (2nd iteration); "
          f"update {update_ms:.3f} ms at minibatch {model.batch_size}; launches per rollout {per_collect[0]}, per train() {per_train[0]}; "
          + ("frozen DINO bit-equal through learn" if frozen is not None else "no frozen encoder"))
    return model, dict(iterations=its, main_s=seconds, n_envs=model.n_envs, updates_per_train=updates, launches_per_rollout=per_collect,
                       launches_per_train=per_train, launches={k: sum(c[k] for c in per_collect + per_train) for k in ALL_KERNELS},
                       bodies=bodies, last_metrics=m, max_param_move=moved, frozen_bit_equal=frozen is not None,
                       update_ms=update_ms, update_obs_frames_per_s=model.batch_size * model.frame_stack / update_ms * 1e3,
                       rollout_env_steps_per_s=steps_per_s)


def reconstruct_check(label: str, mae: VTMAE, frame_stack: int, image: int, tactile: int) -> dict:
    """Phase 13 (c): f32 ``VTMAE.reconstruct`` at batch 8 on the card against the CPU, the same
    weights and mask at ``reconstruct_counts``: 4 encoder + 3 decoder forward launches."""
    rng = np.random.default_rng(6)
    x = vt_load({k: torch.from_numpy(v) for k, v in random_obs(rng, 8, frame_stack, image, tactile).items()}, frame_stack=frame_stack)
    mask = mae.sample_mask(torch.Generator().manual_seed(6), 8, masked=mae.reconstruct_counts())
    twin = copy.deepcopy(mae).cuda()
    reset_launches()
    with torch.no_grad():
        got = twin.reconstruct({k: v.cuda() for k, v in x.items()}, type(mask)(*(t.cuda() for t in mask)))
        torch.cuda.synchronize()
        launches = {k: LAUNCHES[k] for k in ALL_KERNELS if LAUNCHES[k]}
        want = mae.reconstruct(x, mask)
    err = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if g.shape != w.shape or not torch.equal(g.isinf(), w.isinf()) or not torch.isfinite(g[~g.isinf()]).all():
            fail(f"reconstruct ({label}): {k} malformed on the card: {tuple(g.shape)} against {tuple(w.shape)}")
        fin = ~w.isinf()
        err = max(err, (g[fin] - w[fin]).abs().max().item())
    print(f"  reconstruct ({label}): f32 card vs CPU max abs err {err:.3e} (tol {RECON_F32_TOL}); launches {launches}; "
          f"losses {float(got['recon_loss_image']):.4f} / {float(got['recon_loss_tactile']):.4f}")
    if err > RECON_F32_TOL or launches != {KERNEL: 7}:
        fail(f"reconstruct ({label}): error {err} or launches {launches} (expected 7 forward)")
    return dict(max_abs_err=err, tol=RECON_F32_TOL, launches=launches, keys=sorted(want))


def eval_episode(model: PPOMAE, name: str) -> dict:
    """Phase 13 (c): one EvalCallback episode of ``model`` on a fresh FakeInsertion env (at most
    EVAL_MAX_STEPS steps), every step held to the variant's forward launches; a video where cv2
    is installed."""
    try:
        import cv2  # noqa: F401
        video_dir = str(CKPT_DIR / "videos")
    except ImportError:
        video_dir = None
    image, tactile = VARIANTS[name]
    cb = EvalCallback(make_env("FakeInsertion", 0, seed=1, frame_stack=model.frame_stack, image_size=image, tactile_size=tactile),
                      eval_every=1, max_steps=EVAL_MAX_STEPS, video_dir=video_dir)
    reset_launches()
    t0 = time.perf_counter()
    cb(model)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    (result,) = cb.history
    steps = result["eval/ep_length"]
    launches = {k: LAUNCHES[k] for k in ALL_KERNELS if LAUNCHES[k]}
    want = {KERNEL: VARIANT_LAUNCHES[name][1] * steps}
    ok = np.isfinite(result["eval/ep_reward"]) and (steps == EVAL_MAX_STEPS or result["eval/success"] == 1.0)
    print(f"  EvalCallback ({name}): {steps} steps in {seconds:.2f} s, reward {result['eval/ep_reward']:.3f}, success "
          f"{result['eval/success']}, video {result.get('eval/video', 'not written (no cv2)')}; launches {launches}")
    if not ok or launches != want:
        fail(f"EvalCallback ({name}): {result}, launches {launches}, expected {want}")
    return dict(result, seconds=seconds, launches=launches)


def variants_phase() -> dict:
    """Phase 13: the PPO feature variants through their CLIs, then the RL side's evaluation."""
    out = {"f32_check": {}}
    weights = seeded_dinov2_weights(CKPT_DIR / "dinov2_vits14_seeded.pth")
    for name in VARIANT_CLIS:
        out["f32_check"][name] = variant_check(name, weights)
    models = {}
    for name in VARIANT_CLIS:
        models[name], out[name] = variant_cli(name)
    torch.manual_seed(5)
    flagship = build_policy(dtype=torch.float32, device="cpu").features.mae
    out["reconstruct_early_conv"] = reconstruct_check("the training CLI's MAE, early conv", flagship, FRAME_STACK, 64, 32)
    cat = variant_model("train_dino_cat_mae", "cpu", "float32", 8).policy.features.mae
    out["reconstruct_patch"] = reconstruct_check("the fusion CLI's MAE, 70 x 70 patches", cat, cat.config.frame_stack, 70, 70)
    out["eval_callback"] = eval_episode(models["traindino"], "traindino")
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

    print("[3c] the self-distillation key masks")
    distill_worst = check_distill_masks()
    print(f"  largest err/tol: {json.dumps(distill_worst)}")
    for i, (kind, (b, n, h, dh)) in enumerate(DISTILL_MASKED):
        mask = distill_mask(kind, b, n, seed=i)
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

    try:
        print("[9] SSL pretraining slice")
        ssl = ssl_phase()

        print("[10] self-distillation and latent-prediction pretraining (DINO, DINOv2, I-JEPA)")
        distill = distill_phase()

        print("[11] V-JEPA pretraining, then the downstream probes over phase 9's encoder")
        vjepa = vjepa_phase()
        probes = evaluate_phase()

        print("[12] the force-field task over phase 9's encoder, VTDINO, the multimodal transformer")
        forcefield = forcefield_phase()
        vtdino = vtdino_phase()

        print("[13] the PPO feature variants through their CLIs, then the RL side's evaluation and reconstruction")
        variants = variants_phase()
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)  # MAE_CKPT and whatever a failed phase left

    def by_path(name):
        """The kernel's launches in each path's run (counts set to 0 just before it)."""
        return dict(serve=sl["attention_launches"] if name == KERNEL else 0, train=tr["launches"].get(name, 0),
                    bench_v2=bench["v2"]["launches"].get(name, 0), bench_v1=bench["v1"]["launches"].get(name, 0),
                    **{f"cli_{mode}": cli[mode]["launches"][name] for mode in ("joint", "separate", "plain", "resume")},
                    **{f"sac_{run}": sac[run]["launches"][name] for run in ("separate_host", "separate_device", "joint_host", "joint_device", "cli")},
                    **{f"ssl_{run}": ssl[run]["launches"][name] for run in ("cli", "resume", "bf16", "he", "full_image")},
                    **{f"distill_{run}": distill[run]["launches"][name] for run in ("dino", "dino_resume", "dinov2", "ijepa")},
                    **{f"vjepa_{run}": vjepa[run]["launches"][name] for run in ("cli", "resume")},
                    **{f"evaluate_{run}": probes[run]["launches"][name] for run in ("force", "slip", "e2e")},
                    forcefield_check=forcefield["f32_check"]["launches"].get(name, 0),
                    **{f"forcefield_{run}": forcefield[run]["launches"][name] for run in ("frozen", "e2e", "demo_bf16")},
                    vtdino_check=vtdino["f32_check"]["launches"].get(name, 0),
                    **{f"vtdino_{run}": vtdino[run]["launches"][name] for run in ("f32", "bf16")},
                    **{f"multimodal_transformer_{run}": vtdino["multimodal_transformer"][run]["launches"][name] for run in ("shared", "factored")},
                    variants_check=sum(c["launches"].get(name, 0) for c in variants["f32_check"].values()),
                    **{f"variant_{cli}": variants[cli]["launches"][name] for cli in VARIANT_CLIS},
                    **{run: variants[run]["launches"].get(name, 0) for run in ("reconstruct_early_conv", "reconstruct_patch", "eval_callback")})

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
    print(json.dumps({"ssl_vjepa": vjepa}))
    print(json.dumps({"evaluate": probes}))
    print(json.dumps({"forcefield": forcefield}))
    print(json.dumps({"vtdino": vtdino}))
    print(json.dumps({"variants": variants}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
