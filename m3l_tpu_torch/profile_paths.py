"""Where the time goes on the card: the full-width policy's serving requests and training
minibatch updates, the SSL pretraining steps (MAE, DINO, V-JEPA) and a frozen downstream-probe
step, under ``torch.profiler``.

    python -m m3l_tpu_torch.profile_paths [serve train ssl dino vjepa probe forcefield traindino train_dino_cat_mae]

Serving, for batch 8 (the CLI's default env count) and batch 512 (the PPO minibatch): the host
time per request (``PolicyServer.__call__``, raw numpy obs in, numpy actions out). Training:
one joint PPO+MAE minibatch update (``PPOMAE.minibatch_update``, batch 512, bf16, a rollout
minibatch already on the device), ending in a synchronise. SSL pretraining: one
``Trainer.train_step`` of the MAE of ``config/experiment/mae_vit.yaml`` (ViT-small, f32, batch
64, a batch already on the device), with the masked-query decoder and with the He-style one,
ending in a synchronise; and one ``Trainer.train_step`` of the DINO of
``config/experiment/dino_vit.yaml`` (ViT-small, 1 + 4 masked views at N = 197, the 65536-wide
head, the probe; f32, batch 64), with its 65536-wide heads (the student's forward and backward on
every view's CLS token, the teacher's forward) and its post-update hook (center and teacher EMA)
also timed alone by CUDA events; one ``Trainer.train_step`` of the V-JEPA of
``config/experiment/vjepa_vit.yaml`` (two 224 x 224 x 3 frames at tubelet 2, 49 context and 147
target tokens; f32, batch 64) and of the frozen force probe of
``config/experiment/downstream_task/force/digit_mae.yaml`` (the ViT-small forward without autograd,
the attentive probe trained; f32, batch 64), and of the frozen force-field module of
``config/experiment/downstream_task/forcefield/digit_dino.yaml`` (two ViT-small passes without
autograd, the DPT decoder at fusion 128 up to 112 x 112 and the pose ResNet-18 trained; f32, batch
64 of synthetic DIGIT windows, uint8); and one minibatch update (batch 512, bf16) of the PPO
feature variants' CLI models at their defaults: ``cli/traindino.py`` (plain PPO over the frozen
ViT-S/14) and ``cli/train_dino_cat_mae.py`` (the joint update of the MAE fused with the frozen
DINO feature). With path names as arguments, only those run. For each: the host time per call untraced and traced, the device
time per call summed over the kernels and copies the profiler saw, the device's idle share of
the untraced call (1 - device / host), the device time by kind of kernel (``KINDS``: the
attention bodies, cuDNN's convolutions (forward, data and weight gradients), GEMMs, softmaxes, the optimizer's and the EMA's foreach kernels, LayerNorm, copies,
the rest), and the top kernels by device time. Weights and inputs are random from seed 0; timing does not depend on them. The
profiled calls follow one warm-up call. Prints one JSON line per profile.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .envs import SyncVecEnv, make_env
from .rl import PPOMAE
from .serve import PolicyServer, build_policy, random_obs
from .train import Trainer
from .utils.config import instantiate, load_config
from .utils.device import f32_numerics

FRAME_STACK = 4
ACTION_DIM = 3
BATCHES = (8, 512)
REQUESTS = 5
TRAIN_BATCH = 512
UPDATES = 3
TOP = 12
EXPERIMENTS = Path(__file__).resolve().parent.parent / "config" / "experiment"
SSL_CONFIG = EXPERIMENTS / "mae_vit.yaml"
SSL_BATCH = 64
# kinds of device kernel, by a substring of the lower-cased name (the first kind that matches)
KINDS = (
    ("attention", ("fwd_tf32_kernel", "bwd_tf32_kernel", "fwd_mma_kernel", "bwd_mma_kernel")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),  # nvjet: the cuBLAS bf16 kernels of torch 2.11
    ("softmax", ("softmax",)),
    ("foreach (optimizer, EMA)", ("multi_tensor", "foreach")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("copies", ("memcpy", "memset", "copy")),
)


def kind_of(name: str) -> str:
    name = name.lower()
    return next((kind for kind, keys in KINDS if any(k in name for k in keys)), "other")


def random_minibatch(rng: np.random.Generator, batch: int, device, frame_stack: int = FRAME_STACK, image_size: int = 64,
                     tactile_size: int = 32) -> dict:
    """A rollout minibatch drawn from ``rng`` on ``device``: raw obs (uint8 image), actions, old
    values and log-probs, advantages and returns. For timing and checks."""
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    normal = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(
        data={"obs": {k: put(v) for k, v in random_obs(rng, batch, frame_stack, image_size, tactile_size).items()},
              "actions": put(normal(batch, ACTION_DIM)), "values": put(normal(batch)), "log_probs": put(normal(batch) - 3.0)},
        advantages=put(normal(batch)), returns=put(normal(batch)),
    )


def profiled(fn, calls: int, label: str) -> dict:
    """Time ``calls`` calls of ``fn`` untraced, then traced; summarize the trace."""
    fn()  # warm-up
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0  # untraced
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        traced_s = time.perf_counter() - t0
    per_kernel: dict[str, float] = defaultdict(float)
    n_device = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] += evt.time_range.elapsed_us()
            n_device += 1
    device_us = sum(per_kernel.values())
    by_kind: dict[str, float] = defaultdict(float)
    for name, us in per_kernel.items():
        by_kind[kind_of(name)] += us / 1e3 / calls
    host_ms = host_s * 1e3 / calls
    device_ms = device_us / 1e3 / calls
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        path=label, calls=calls, host_ms_per_call=host_ms, traced_host_ms_per_call=traced_s * 1e3 / calls,
        device_ms_per_call=device_ms, device_idle_share=1.0 - device_ms / host_ms, device_ops_per_call=n_device / calls,
        device_ms_by_kind=dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=k[:120], ms_per_call=v / 1e3 / calls, share_of_device=v / device_us) for k, v in ranked],
    )


def profile_serving(server: PolicyServer, batch: int, rng: np.random.Generator) -> dict:
    obs = iter([random_obs(rng, batch, FRAME_STACK) for _ in range(2 * REQUESTS + 1)])
    return profiled(lambda: server(next(obs)), REQUESTS, f"serve batch {batch}")


def profile_training(rng: np.random.Generator) -> dict:
    policy = build_policy(dtype=torch.bfloat16, device="cuda")
    env = SyncVecEnv([make_env("FakeInsertion", i, frame_stack=FRAME_STACK) for i in range(8)])
    model = PPOMAE(policy, env, n_steps=TRAIN_BATCH // 8, batch_size=TRAIN_BATCH, frame_stack=FRAME_STACK, device="cuda")
    mb = random_minibatch(rng, TRAIN_BATCH, model.device)
    idx = torch.arange(TRAIN_BATCH, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    masks = iter([policy.features.mae.sample_mask(gen, TRAIN_BATCH) for _ in range(2 * UPDATES + 1)])

    def update():
        model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], next(masks))
        torch.cuda.synchronize()

    return profiled(update, UPDATES, f"train update batch {TRAIN_BATCH}")


# the PPO feature variants' CLIs, each with the size of its envs' image and tactile maps
VARIANTS = {"traindino": (64, 32), "train_dino_cat_mae": (70, 70), "train_dino_tac_mae": (70, 70), "train_cnn": (64, 32)}


def variant_model(name: str, device: str, compute_dtype: str = "bfloat16", batch: int = TRAIN_BATCH, argv=()) -> PPOMAE:
    """The PPOMAE that ``m3l_tpu_torch.cli.<name>`` builds at its defaults (width, depth, frame stack,
    masking), at ``compute_dtype`` on ``device``, over 8 in-process FakeInsertion envs at the
    variant's sizes and a rollout of ``batch`` samples (one minibatch of ``batch``). Weights are
    seeded by the CLI's ``--seed``: two calls build the same weights."""
    import importlib

    cli = importlib.import_module(f"m3l_tpu_torch.cli.{name}")
    config = cli.build_parser().parse_args(["--env", "FakeInsertion", "--n_envs", "8", "--rollout_length", str(batch),
                                            "--batch_size", str(batch), "--compute_dtype", compute_dtype, "--device", device,
                                            "--verbose", "0", *argv])
    image, tactile = VARIANTS[name]
    env = SyncVecEnv([make_env("FakeInsertion", i, frame_stack=config.frame_stack, image_size=image, tactile_size=tactile)
                      for i in range(config.n_envs)])
    return cli.build_model(config, env)


def variant_masks(model: PPOMAE, n: int, seed: int = 0) -> list:
    """``n`` MAE masks of one minibatch over the modalities the variant's MAE sees (None without
    MAE updates), drawn on the model's device."""
    if not model.train_mae:
        return [None] * n
    features = model.policy.features
    use_vision, use_tactile = features.mae_modalities(("image", "tactile"))
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return [features.mae.sample_mask(gen, model.batch_size, use_vision, use_tactile) for _ in range(n)]


def profile_variant(name: str, rng: np.random.Generator) -> dict:
    """One minibatch update of the variant's CLI model at its defaults (bf16, batch 512)."""
    model = variant_model(name, "cuda")
    image, tactile = VARIANTS[name]
    mb = random_minibatch(rng, TRAIN_BATCH, model.device, model.frame_stack, image, tactile)
    idx = torch.arange(TRAIN_BATCH, device=model.device)
    masks = iter(variant_masks(model, 2 * UPDATES + 1))

    def update():
        model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], next(masks))
        torch.cuda.synchronize()

    out = profiled(update, UPDATES, f"{name} update batch {TRAIN_BATCH}")
    # the policy's flat Adam over every parameter, the frozen DINO's zero gradients included (as
    # JAX's), against one over the parameters that get a gradient; each timed on the gradients the
    # last update left (the steps move the parameters: this model serves timing only)
    from .train.optim import FlatAdam

    trained = FlatAdam([p for p in model.policy.parameters() if p.grad is not None], model.optimizer.learning_rate, eps=1e-5,
                       max_grad_norm=model.optimizer.max_grad_norm)
    out["parts_ms"] = dict(flat_adam_step_all_parameters=event_ms(model.optimizer.step), flat_adam_step_with_gradients=event_ms(trained.step))
    out["parameters"] = dict(all=sum(p.numel() for p in model.policy.parameters()), with_gradients=sum(p.numel() for p in trained.params))
    return out


def profile_step(module, batch: dict, label: str) -> dict:
    """``profiled`` over one synchronised ``Trainer.train_step`` of ``module`` on ``batch``."""
    trainer = Trainer(device="cuda", verbose=0)
    if hasattr(module, "setup_schedules"):
        module.setup_schedules(3, 200)
    optimizer = module.configure_optimizer(3, 200)

    def step():
        trainer.train_step(module, optimizer, batch)
        torch.cuda.synchronize()

    return profiled(step, UPDATES, label)


def profile_ssl(rng: np.random.Generator, overrides=()) -> dict:
    cfg = load_config(str(SSL_CONFIG), list(overrides))
    module = instantiate(cfg["model"]["algorithm"])(instantiate(cfg["model"]["encoder"])).to("cuda")
    enc = module.encoder
    batch = {"image": torch.from_numpy(rng.random((SSL_BATCH, *enc.img_size, enc.in_chans), dtype=np.float32)).cuda()}
    decoder = "masked-query" if module.decode_masked_only else "He-style"
    return profile_step(module, batch, f"ssl step batch {SSL_BATCH}, {decoder} decoder")


def event_ms(fn, calls: int = UPDATES) -> float:
    """Mean device time of ``fn()`` by CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def profile_dino(rng: np.random.Generator) -> dict:
    cfg = load_config(str(EXPERIMENTS / "dino_vit.yaml"))
    module = instantiate(cfg["model"]["algorithm"])(instantiate(cfg["model"]["encoder"])).to("cuda")
    enc = module.student_backbone
    batch = {"image": torch.from_numpy(rng.random((SSL_BATCH, *enc.img_size, enc.in_chans), dtype=np.float32)).cuda()}
    out = profile_step(module, batch, f"dino step batch {SSL_BATCH}")
    with torch.no_grad():
        _, aux = module.training_loss(batch, torch.Generator(device="cuda").manual_seed(0), 0)
    views = (module.num_global_masks + module.num_local_masks) * SSL_BATCH
    cls = torch.randn(views, enc.embed_dim, device="cuda", requires_grad=True)
    teacher_cls = torch.randn(module.num_global_masks * SSL_BATCH, enc.embed_dim, device="cuda")

    def heads():
        module.student_head(cls).sum().backward()
        with torch.no_grad():
            module.teacher_head(teacher_cls)

    out["parts_ms"] = dict(heads_fwd_bwd=event_ms(heads), post_update_hook=event_ms(lambda: module.on_train_batch_end(aux, 0)))
    return out


def profile_vjepa(rng: np.random.Generator) -> dict:
    cfg = load_config(str(EXPERIMENTS / "vjepa_vit.yaml"))
    module = instantiate(cfg["model"]["algorithm"])(instantiate(cfg["model"]["encoder"])).to("cuda")
    enc = module.context_encoder
    x = rng.random((SSL_BATCH, enc.num_frames, *enc.img_size, enc.in_chans), dtype=np.float32)
    return profile_step(module, {"image": torch.from_numpy(x).cuda()}, f"vjepa step batch {SSL_BATCH}")


def profile_probe(rng: np.random.Generator) -> dict:
    from .train.builders import build_task_module

    cfg = load_config(str(EXPERIMENTS / "downstream_task" / "force" / "digit_mae.yaml"))
    module = build_task_module(instantiate(cfg["model"]["encoder"]), "force").to("cuda")
    enc = module.model_encoder.encoder
    batch = {
        "image": rng.random((SSL_BATCH, *enc.img_size, enc.in_chans), dtype=np.float32),
        "force": rng.uniform(-1, 1, (SSL_BATCH, 3)).astype(np.float32),
        "force_scale": np.ones((SSL_BATCH, 3), np.float32),
    }
    return profile_step(module, {k: torch.from_numpy(v).cuda() for k, v in batch.items()}, f"frozen force probe step batch {SSL_BATCH}")


def profile_forcefield(rng: np.random.Generator) -> dict:
    from .data import forcefield_windows, synth_digit_trajectories

    cfg = load_config(str(EXPERIMENTS / "downstream_task" / "forcefield" / "digit_dino.yaml"))
    module = instantiate(cfg["task"])(instantiate(cfg["model"]["encoder"])).to("cuda")
    w = forcefield_windows(synth_digit_trajectories(1, SSL_BATCH + 1, size=module.model_task.img_size[0], seed=int(rng.integers(1 << 30))))
    batch = {k: torch.from_numpy(w[k]).cuda() for k in ("image", "image_bg", "mask", "force")}
    return profile_step(module, batch, f"frozen force-field step batch {SSL_BATCH}")


def main(argv: list[str] | None = None) -> None:
    """Profiles every path, or only those named: serve, train, ssl, dino, vjepa, probe, forcefield,
    traindino, train_dino_cat_mae (the variants' updates)."""
    import sys

    names = set(sys.argv[1:] if argv is None else argv)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    f32_numerics("float32")  # the f32 paths as the CLIs run them: no TF32 in cuDNN or cuBLAS
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    print(f"device: {torch.cuda.get_device_name(0)}")

    def wanted(name):
        return not names or name in names

    results = []
    if wanted("serve"):
        server = PolicyServer(build_policy(dtype=torch.bfloat16, device="cuda"))
        results += [profile_serving(server, batch, rng) for batch in BATCHES]
    if wanted("train"):
        results.append(profile_training(rng))
    if wanted("ssl"):
        results += [profile_ssl(rng, ov) for ov in ((), ("model.algorithm.decode_masked_only=false",))]
    for name, fn in (("dino", profile_dino), ("vjepa", profile_vjepa), ("probe", profile_probe), ("forcefield", profile_forcefield)):
        if wanted(name):
            results.append(fn(rng))
    results += [profile_variant(name, rng) for name in ("traindino", "train_dino_cat_mae") if wanted(name)]
    for r in results:
        print(f"{r['path']}: host {r['host_ms_per_call']:.3f} ms/call ({r['traced_host_ms_per_call']:.3f} traced), device "
              f"{r['device_ms_per_call']:.3f} ms/call, idle share {r['device_idle_share']:.3f}, {r['device_ops_per_call']:.0f} device ops/call")
        print("  by kind: " + ", ".join(f"{k} {v:.3f} ms" for k, v in r["device_ms_by_kind"].items()))
        if "parts_ms" in r:
            print("  timed alone: " + ", ".join(f"{k} {v:.3f} ms" for k, v in r["parts_ms"].items()))
        for k in r["top_kernels"]:
            print(f"  {k['ms_per_call']:9.4f} ms  {k['share_of_device']:6.1%}  {k['name']}")
        print(json.dumps(r))


if __name__ == "__main__":
    main()
