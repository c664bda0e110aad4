"""The numerics behind chip_smoke.py's settings and bounds, measured on one NVIDIA card.

    python3 chip_numerics.py

A measurement, not a check: it fails on nothing it reads.

1. cuDNN's TF32. PyTorch runs cuDNN's convolutions in TF32 by default; the CLIs turn that off for
   f32 configurations (``utils.device.f32_numerics``). The f32 card-vs-CPU steps of chip_smoke.py's
   MAE (phase 9 (a)), V-JEPA (phase 11 (a)), frozen force probe (phase 11 (f)) and force field
   (phase 12 (a)) rerun with it on, each error over its bound; the MAE step and the frozen probe
   step at batch 64 are timed with it off and on, in turns (off, on, on, off).
2. ``allow_bf16_reduced_precision_reduction``: one bf16 PPO update and the batch-8 serving outputs
   against the f32 CPU with it on (PyTorch's default) and off.
3. The force field's f32 conditioning: phase 12 (a)'s CPU step against the same step with its
   SSIM in f64 (the CPU's own f32 error, beside which ``FF_F32_TOL`` is set).
4. The bf16 plain-attention checks of phase 12 (c) and (d): the demo's fields and the VTDINO
   recipe's first loss and gradient with the kernels, and with the plain attention carrying a fault
   (the last key dropped, the register key dropped, the softmax scale doubled, the recipe's key
   masks ignored), each against the plain attention (``DEMO_BF16_TOL``, ``VTDINO_BF16_TOL``).

The probe runs over a seeded, untrained MAE encoder saved as a checkpoint under
``smoke_checkpoints/`` (gitignored; removed at the end). Prints one {"numerics": ...} JSON line,
then the card line as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it.
"""
from __future__ import annotations

import contextlib
import copy
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke
from chip_smoke import fa
from m3l_tpu_torch.rl import PPOMAE
from m3l_tpu_torch.serve import PolicyServer, build_policy, random_obs
from m3l_tpu_torch.tasks import forcefield_geometry
from m3l_tpu_torch.train import save_checkpoint

STEPS = 5  # timed optimizer steps per setting, after one warm-up


def step_ms(module, batch: dict, generator=None) -> float:
    """Milliseconds per synchronised optimizer step of ``module`` on ``batch``, after one warm-up."""
    opt = module.configure_optimizer(3, 200)

    def step():
        loss, _ = module.training_loss(batch, generator, 0)
        loss.backward()
        opt.step()
        opt.zero_grad()

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / STEPS


def tf32_errors() -> dict:
    """The four f32 card-vs-CPU steps with cuDNN's TF32 on: each error, and each over its bound."""
    checks = dict(mae=(smoke.ssl_check, smoke.SSL_F32_TOL), vjepa=(smoke.vjepa_check, smoke.VJEPA_F32_TOL),
                  probe=(smoke.probe_check, smoke.PROBE_F32_TOL), forcefield=(smoke.forcefield_check, smoke.FF_F32_TOL))
    out = {}
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, (check, tol) in checks.items():
            e = check()
            out[name] = dict(err_per_tol=smoke.held(e, tol), tol=tol, **{k: e[k] for k in tol})
            print(f"  {name} with cuDNN TF32 on: err/tol {json.dumps({k: round(v, 3) for k, v in out[name]['err_per_tol'].items()})}")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return out


def tf32_cost() -> dict:
    """ms a step of the MAE step and the frozen probe step at batch 64, cuDNN's TF32 off and on in turns."""
    mae = smoke.ssl_models().to("cuda")
    image = torch.from_numpy(np.random.default_rng(8).random((smoke.SSL_BATCH, *mae.encoder.img_size, mae.encoder.in_chans), dtype=np.float32)).cuda()
    probe = smoke.probe_models(smoke.DOWNSTREAM / "force" / "digit_mae.yaml", "cuda")
    ones = torch.ones(smoke.SSL_BATCH, 3, device="cuda")
    probe_batch = {"image": image, "force": torch.rand(smoke.SSL_BATCH, 3, device="cuda"), "force_scale": ones}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, module, batch in (("mae_step", mae, {"image": image}), ("frozen_probe_step", probe, probe_batch)):
        runs = []
        for on in (False, True, True, False):
            torch.backends.cudnn.allow_tf32 = on
            runs.append((on, step_ms(module, batch, gen)))
        torch.backends.cudnn.allow_tf32 = False
        out[name] = dict(tf32_off_ms=[ms for on, ms in runs if not on], tf32_on_ms=[ms for on, ms in runs if on], batch=smoke.SSL_BATCH)
        print(f"  {name} at batch {smoke.SSL_BATCH}: cuDNN TF32 off {out[name]['tf32_off_ms']} ms, on {out[name]['tf32_on_ms']} ms")
    return out


def bf16_reduction() -> dict:
    """One bf16 PPO update and batch-8 serving against the f32 CPU, the reduced-precision flag on and off."""
    out = {}
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        try:
            torch.manual_seed(1)
            policy = build_policy(dtype=torch.bfloat16, device="cuda")
            twin = build_policy(dtype=torch.float32, device="cpu")
            twin.load_state_dict(policy.state_dict())
            kw = dict(learning_rate=1e-4, n_steps=smoke.CHECK_BATCH // smoke.TRAIN_ENVS, batch_size=smoke.CHECK_BATCH, frame_stack=smoke.FRAME_STACK)
            update = smoke.update_errors(PPOMAE(policy, smoke.train_env(), device="cuda", **kw),
                                         PPOMAE(twin, smoke.train_env(), device="cpu", **kw), smoke.CHECK_BATCH)
            obs = [random_obs(np.random.default_rng(2), 8, smoke.FRAME_STACK) for _ in range(4)]
            got, ref = smoke.outputs(PolicyServer(policy), obs), smoke.outputs(PolicyServer(twin), obs)
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        serve = dict(actions_max_abs_err=float(np.abs(got[0] - ref[0]).max()), values_max_abs_err=float(np.abs(got[1] - ref[1]).max()),
                     tol=smoke.SLICE_TOL)
        out["on" if flag else "off"] = dict(update={k: update[k] for k in ("loss_rel", "grad_rel", "param_per_lr")}, serve=serve)
        print(f"  bf16 reduced-precision reductions {'on (default)' if flag else 'off'}: update vs f32 CPU loss rel "
              f"{update['loss_rel']:.3e}, grad rel {update['grad_rel']:.3e}, param/lr {update['param_per_lr']:.3e}; batch-8 serving "
              f"actions {serve['actions_max_abs_err']:.3e}, values {serve['values_max_abs_err']:.3e} (tol {smoke.SLICE_TOL})")
    return out


@contextlib.contextmanager
def ssim_in_f64():
    """The force-field reprojection's SSIM evaluated in f64 (its result rounded back to f32)."""
    f32 = forcefield_geometry.ssim
    forcefield_geometry.ssim = lambda a, b: f32(a.double(), b.double()).to(a.dtype)
    try:
        yield
    finally:
        forcefield_geometry.ssim = f32


def forcefield_f32_error() -> dict:
    """Phase 12 (a)'s CPU step against the same step with the SSIM in f64."""
    cpu = smoke.forcefield_module(smoke.FORCEFIELD / "digit_dino.yaml", ["task.warmup_epochs=0"], "cpu")
    exact = copy.deepcopy(cpu)
    data = smoke.forcefield_data(1, smoke.FF_CHECK_BATCH + 1, 224, 7)
    batch = {k: torch.from_numpy(v[: smoke.FF_CHECK_BATCH]) for k, v in data.items()}
    lb, gb, sb, opt = smoke.probe_step(cpu, batch)
    with ssim_in_f64():
        lx, gx, sx, _ = smoke.probe_step(exact, batch)
    grad_rel, param_per_lr, _ = smoke.step_errors(gx, gb, sx, sb, opt.learning_rate(0), opt.adamw.param_groups[0]["eps"])
    out = dict(loss_rel=max(abs(lx[k] - lb[k]) / abs(lb[k]) for k in lb), grad_rel=grad_rel, param_per_lr=param_per_lr)
    print(f"  the CPU's f32 step against its SSIM in f64: loss rel {out['loss_rel']:.3e}, grad err/|grad| {grad_rel:.3e}, "
          f"param err/lr {param_per_lr:.3e}")
    return out


FAULTS = ("last key dropped", "register key dropped", "scale doubled", "mask ignored")


@contextlib.contextmanager
def faulty_attention(fault: str):
    """The plain attention with ``fault`` in place of the kernels on the card."""
    launch, launch_bwd = fa._launch, fa._launch_bwd

    def bias_of(qkv, bias):
        if fault == "scale doubled":
            return bias
        if fault == "mask ignored":
            return None
        extra = torch.zeros(qkv.shape[:2], device=qkv.device)
        extra[:, -1 if fault == "last key dropped" else 0] = float("-inf")
        return extra if bias is None else bias + extra

    factor = 2.0 if fault == "scale doubled" else 1.0
    fa._launch = lambda qkv, h, bias, scale: fa._fwd_plain(qkv, h, bias_of(qkv, bias), factor * scale)
    fa._launch_bwd = lambda qkv, g, h, bias, scale: fa._bwd_plain(qkv, g, h, bias_of(qkv, bias), factor * scale)
    try:
        yield
    finally:
        fa._launch, fa._launch_bwd = launch, launch_bwd


def plain_path_controls() -> dict:
    """Phase 12 (c) and (d)'s bf16 comparisons with the kernels and with each fault, against the
    plain attention."""
    args = smoke.SimpleNamespace(dim=192, depth=6, heads=3, hooks="1,3,4,5", fusion_ch=64, dtype="bfloat16")
    module = smoke.demo_cli._build_module_structure(args, 96).to("cuda").eval()
    w = smoke.forcefield_data(1, 31, 96, 99)
    x, xb = (torch.from_numpy(w[k]).cuda().float() / 255.0 for k in ("image", "image_bg"))

    def fields(ctx):
        with torch.no_grad(), ctx:
            return torch.cat([torch.cat(module.forward_fields(x[i : i + 1], xb[i : i + 1]), -1) for i in range(len(x))]).float()

    ref = fields(smoke.plain_attention())
    demo = {name: ((f - ref).norm() / ref.norm()).item()
            for name, f in [("kernel", fields(contextlib.nullcontext()))] + [(k, fields(faulty_attention(k))) for k in FAULTS[:3]]}
    print(f"  the demo's fields against the plain attention, relative to their norm (tol {smoke.DEMO_BF16_TOL['field_rel']}): "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in demo.items()})}")
    recipe = smoke._seeded(2, lambda: smoke.VTDINOModule(
        smoke.MultimodalVTT(image_size=(64, 64), tactile_size=(32, 32), image_patch_size=8, tactile_patch_size=4, dim=128, depth=4, heads=4,
                            mlp_dim=256, num_tactiles=2, frame_stack=2, num_register_tokens=1, dtype=torch.bfloat16),
        dino_out_dim=4096, dino_hidden_dim=1024, dino_bottleneck_dim=128, num_global_masks=1, num_local_masks=4,
        moving_average_decay=(0.99, 0.999), teacher_warmup_epochs=2, warmup_epochs=2, base_lr=5e-4, with_reconstruction_probe=True,
        dtype=torch.bfloat16))
    batch = smoke.vtdino_batch(smoke.VTDINO_BF16_BATCH, 30, (64, 64, 6), (32, 32, 6))
    vtdino = {"kernel": smoke.vtdino_bf16_check(recipe, batch)}
    plain = smoke.plain_attention
    try:
        for fault in FAULTS:
            smoke.plain_attention = lambda fault=fault: faulty_attention(fault)  # the step that vtdino_bf16_check compares
            vtdino[fault] = smoke.vtdino_bf16_check(recipe, batch)
    finally:
        smoke.plain_attention = plain
    vtdino = {k: {m: e[m] for m in ("loss_rel", "grad_rel")} for k, e in vtdino.items()}
    print(f"  the VTDINO recipe's first step against the plain attention (tol {smoke.VTDINO_BF16_TOL}): "
          f"{json.dumps({k: {m: float(f'{v:.4g}') for m, v in e.items()} for k, e in vtdino.items()})}")
    return dict(demo_field_rel=demo, vtdino_recipe=vtdino)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_numerics: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smoke.MAE_CKPT = smoke.CKPT_DIR / "numerics_mae.ckpt"
    save_checkpoint(smoke.MAE_CKPT, {"model": smoke.ssl_models().state_dict()})
    try:
        print("the f32 card-vs-CPU steps with cuDNN's TF32 on")
        errors = tf32_errors()
        print("the cost of cuDNN's TF32 off")
        cost = tf32_cost()
        print("bf16 reduced-precision reductions")
        bf16 = bf16_reduction()
    finally:
        shutil.rmtree(smoke.CKPT_DIR, ignore_errors=True)
    print("the force field's f32 conditioning")
    ff = forcefield_f32_error()
    print("the bf16 plain-attention checks with faults")
    controls = plain_path_controls()
    print(json.dumps({"numerics": dict(cudnn_tf32_on=errors, tf32_cost=cost, bf16_reduced_precision_reduction=bf16,
                                       forcefield_cpu_f32_vs_f64_ssim=ff, plain_path_controls=controls)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
