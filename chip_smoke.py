#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (m3l_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) if it fails:

1. the card's name and power limit, and the matmul precision flags;
2. build every CUDA source of m3l_tpu_torch/csrc (one nvcc each);
3. each kernel against its plain PyTorch version on the card, at the serving shapes and a few
   more, then timed beside its plain version, its byte/FLOP bound and one PyTorch library call
   that computes the same function (timed as a yardstick only; the port never calls it);
4. the serving slice: the full-width PPO+MAE policy (dim 256, 4 encoder layers + 1 post layer,
   bf16 compute, random weights from a seed) serves 8 requests of batch 8 and one of batch 512
   through PolicyServer; every forward must launch the attention kernel 5 times, and the
   batch-8 actions and values, in bf16 and in f32 on the card, must match the same weights
   run in f32 on the CPU.

The last lines are a {"kernels": [...]} JSON line, a {"slice": ...} JSON line, the card line as
nvidia-smi prints it, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from m3l_tpu_torch.kernels import LAUNCHES, reset_launches
from m3l_tpu_torch.kernels.build import build_all
from m3l_tpu_torch.nn.flash_attention import (
    KERNEL,
    flash_attention_qkv,
    flash_attention_qkv_reference,
    flash_attention_qkv_tolerance,
)
from m3l_tpu_torch.serve import PolicyServer, build_policy, random_obs

# H100 SXM data sheet: HBM rate and dense peak rates per compute type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# The kernel against its plain version: the elementwise bound of flash_attention_qkv_tolerance
# (f32 1e-5; bf16 one ulp of the output plus one ulp of each probability times |v|).
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

FRAME_STACK = 4
ACTION_DIM = 3
SERVE_B, SERVE_N, SERVE_H, SERVE_DH = 512, 192, 4, 64  # attention at the batch-512 forward


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
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = torch.rand(b, n, generator=g, device="cuda") > 0.3
        mask[:, 0] = True
    return qkv, mask


def check_attention() -> float:
    """Kernel against plain at every listed shape, each element within its bound; returns the max
    abs error at the serving shape."""
    cases = [(b, n, 4, 64, dt, m) for b in (8, 512) for n in (10, 192) for dt in (torch.bfloat16, torch.float32) for m in (False, True)]
    cases += [(64, 196, 16, 64, torch.bfloat16, True), (64, 196, 16, 64, torch.float32, False)]
    serve_err = None
    for i, (b, n, h, dh, dtype, masked) in enumerate(cases):
        qkv, mask = packed_qkv(b, n, h, dh, dtype, masked, seed=i)
        out = flash_attention_qkv(qkv, h, key_mask=mask)
        ref = flash_attention_qkv_reference(qkv, h, key_mask=mask)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != dtype or not torch.isfinite(out).all():
            fail(f"attention output malformed at {(b, n, h, dh, dtype)}")
        diff = (out.float() - ref.float()).abs()
        tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
        err, ratio = diff.max().item(), (diff / tol).max().item()
        ref_max = ref.float().abs().max().item()
        ok = ratio <= 1.0
        print(f"  attention B={b} N={n} H={h} Dh={dh} {str(dtype)[6:]} mask={masked}: max_abs_err={err:.3e} "
              f"max|ref|={ref_max:.3e} rel_err={err / ref_max:.3e} tol in [{tol.min().item():.3e}, {tol.max().item():.3e}] "
              f"max err/tol={ratio:.3f} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"attention kernel disagrees with its plain version at {(b, n, h, dh, dtype, masked)}")
        if (b, n, h, dh, dtype, masked) == (SERVE_B, SERVE_N, SERVE_H, SERVE_DH, torch.bfloat16, False):
            serve_err = err
    return serve_err


def time_attention(b, n, h, dh, dtype) -> dict:
    qkv, _ = packed_qkv(b, n, h, dh, dtype, False, seed=100)
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4))
    ms = cuda_ms(lambda: flash_attention_qkv(qkv, h))
    plain_ms = cuda_ms(lambda: flash_attention_qkv_reference(qkv, h))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    elem = qkv.element_size()
    nbytes = qkv.numel() * elem + b * n * h * dh * elem  # qkv read once, output written once
    flops = 4 * b * h * n * n * dh  # QK^T and AV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes, flops=flops)


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
    if launches != 5 * forwards:
        fail(f"attention kernel launched {launches} times in {forwards} forwards, expected 5 per forward")

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
        forwards=forwards, attention_launches=launches, **errs, **scale,
    )


def outputs(server: PolicyServer, batches: list) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic actions and values of ``server`` on each batch, concatenated."""
    acts, vals = [], []
    for obs in batches:
        acts.append(server(obs))
        with torch.inference_mode():
            vals.append(server.policy.predict_values(server.to_device(obs)).float().cpu().numpy())
    return np.concatenate(acts), np.concatenate(vals)


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
    serve_err = check_attention()
    timed = {}
    for b in (8, SERVE_B):
        timed[b] = time_attention(b, SERVE_N, SERVE_H, SERVE_DH, torch.bfloat16)
        t = timed[b]
        print(f"  attention B={b} N={SERVE_N} H={SERVE_H} Dh={SERVE_DH} bf16: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"sdpa {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B, {t['flops']} FLOP)")

    print("[4] serving slice")
    sl = serve_slice()
    print(f"  batch 8: p50 {sl['batch8_latency_ms_p50']:.3f} ms per request; batch 512: {sl['batch512_ms']:.3f} ms, "
          f"{sl['batch512_obs_frames_per_s']:.1f} obs-frames/s; {sl['attention_launches']} attention launches in {sl['forwards']} forwards")

    t = timed[SERVE_B]
    kernels = [dict(
        name=KERNEL, route="cuda", source="m3l_tpu_torch/csrc/flash_attention_qkv_fwd.cu",
        replaces="m3l_tpu/nn/flash_attention.py:263", launches=sl["attention_launches"],
        max_abs_err=serve_err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], shape=dict(B=SERVE_B, N=SERVE_N, H=SERVE_H, Dh=SERVE_DH, dtype="bfloat16"),
        batch8_ms=timed[8]["ms"], batch8_plain_ms=timed[8]["plain_ms"], batch8_library_ms=timed[8]["library_ms"],
        batch8_bound_ms=timed[8]["bound_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"slice": sl}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
