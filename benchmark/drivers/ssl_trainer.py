"""The SSL Trainer's inner loop (``train/trainer.py`` ``Trainer.fit``): a batch from the port's
``DataLoader``, placed on the card by ``Trainer._place``, then ``Trainer.train_step``.

The traffic's ``task`` picks what trains: ``dino`` (``train.builders.build_dino`` over
``build_vit``, ``cli/pretrain.py``'s ``VisionTactileDataset`` with background removal), or
``force`` (``build_task_module`` over a frozen ViT, ``cli/evaluate.py``'s ``make_task_dataset``
with force labels); any other task is refused, and needs a driver of its own. Schedules and the optimizer are set up as ``fit`` sets
them. Frames are made on the card from the seed (uint8, uniform over 0-254, as the CLIs'
``--synthetic`` frames); there are ``epoch_batches`` batches an epoch.

DINO's teachers start where a resumed fit's stand, behind their students: 0.9 x the student's
weights + 0.1 x a draw of their own, so that each step's EMA moves them by a share of that lag
that the check can read. Set-up runs the first ``check_steps`` steps (the warm-up, and the check's
steps, whose losses, first gradients from AdamW's first moment, and trainable parameters, centre
and teachers after the last are kept). The
window then runs steps until the window's length has passed and synchronises; the benchmark's
span ``loader`` times each ``next()`` of the loader on the host.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, counting, stats
from ..devtrace import record
from ..reference.numerics import numerics
from ..reference.vit import dino_steps, force_probe_steps, frames_to_images
from ..weights import load_into, make_weights, parameter_shapes, stream_seed


LOADER_SEED = 0  # the DataLoader's default, which cli/pretrain.py and cli/evaluate.py keep
TASKS = ("dino", "force")
TEACHER_LAG = 0.1  # the teachers' share of a draw apart from their students


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_frames(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The recording: (T, H, W, 3) uint8 on the card, T = epoch_batches x batch + the window's span."""
    n = traffic["epoch_batches"] * cfg["batch_size"] + (cfg["num_frames"] - 1) * cfg["frame_stride"]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    s = cfg["img_size"]
    return torch.randint(0, 255, (n, s, s, 3), generator=gen, device=device, dtype=torch.uint8)


def build(ctx):
    """The module, its loader, the benchmark's weights (loaded) and, for a probe, the labels."""
    from m3l_tpu_torch.data import DataLoader, VisionTactileDataset, make_task_dataset
    from m3l_tpu_torch.train.builders import build_dino, build_task_module, build_vit
    from m3l_tpu_torch.utils.device import f32_numerics

    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    if tr["task"] not in TASKS:
        raise ValueError(f"the ssl_trainer driver runs the tasks {TASKS}, not {tr['task']!r}")
    f32_numerics(cfg["compute_dtype"])
    encoder = build_vit(cfg["model_size"], patch_size=cfg["patch_size"], img_size=[cfg["img_size"]] * 2,
                        in_chans=cfg["in_chans"], num_register_tokens=cfg["num_register_tokens"], pos_embed_fn=cfg["pos_embed_fn"],
                        depth=cfg["depth"], compute_dtype=cfg["compute_dtype"], seed=ctx.seed % (1 << 31))
    frames_dev = make_frames(cfg, tr, ctx.seed, device)
    frames = frames_dev.cpu().numpy()
    extra = {}
    if tr["task"] == "dino":
        module = build_dino(encoder, dino_out_dim=cfg["dino_out_dim"], dino_hidden_dim=cfg["dino_hidden_dim"],
                            dino_bottleneck_dim=cfg["dino_bottleneck_dim"], num_global_masks=cfg["num_global_masks"],
                            num_local_masks=cfg["num_local_masks"], local_mask_scale=cfg["local_mask_scale"],
                            global_mask_scale=cfg["global_mask_scale"], min_keep_num_sensors=cfg["min_keep_num_sensors"],
                            moving_average_decay=cfg["moving_average_decay"], teacher_temp=cfg["teacher_temp"],
                            teacher_warmup_epochs=cfg["teacher_warmup_epochs"], student_temp=cfg["student_temp"],
                            base_lr=cfg["base_lr"], weight_decay=cfg["weight_decay"], warmup_epochs=cfg["warmup_epochs"])
        ds = VisionTactileDataset(frames, num_frames=cfg["num_frames"], frame_stride=cfg["frame_stride"], out_format="concat_ch_img",
                                  remove_background=cfg["remove_background"])
        skip = ("teacher_",)
        epochs = cfg["max_epochs"]
    else:
        module = build_task_module(encoder, tr["task"], encoder_type="dino", train_encoder=False, num_heads=cfg["force_probe_num_heads"],
                                   seed=ctx.seed % (1 << 31), base_lr=cfg["force_probe_base_lr"],
                                   weight_decay=cfg["force_probe_weight_decay"], warmup_epochs=cfg["force_probe_warmup_epochs"])
        gen = torch.Generator(device=device).manual_seed(stream_seed(ctx.seed, 3))
        force = (torch.rand((len(frames), 3), generator=gen, device=device) * 2.0 - 1.0).cpu().numpy()
        ds = make_task_dataset({"frames": frames, "force": force}, "force", num_frames=cfg["num_frames"], frame_stride=cfg["frame_stride"],
                               out_format="concat_ch_img", remove_background=cfg["force_remove_background"])
        extra["force"] = force
        skip = ()
        epochs = cfg["force_probe_max_epochs"]
    loader = DataLoader(ds, batch_size=cfg["batch_size"])
    shapes = parameter_shapes(module, skip)
    weights = make_weights(shapes, ctx.seed, device)
    load_into(module, weights)
    if tr["task"] == "dino":  # the teachers lag their students, as in a resumed fit
        student = {k: shape for k, shape in shapes.items() if k.startswith("student_")}
        lag = make_weights(student, ctx.seed, device, stream=4)
        teachers = {"teacher_" + k[len("student_"):]: (1.0 - TEACHER_LAG) * weights[k] + TEACHER_LAG * lag[k] for k in student}
        load_into(module, teachers)
        weights.update(teachers)
    return module, loader, frames_dev, weights, epochs, extra


def setup(ctx):
    from m3l_tpu_torch.train.trainer import Trainer

    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    t0 = time.perf_counter()
    module, loader, frames_dev, weights, epochs, extra = build(ctx)
    t1 = time.perf_counter()
    trainer = Trainer(max_epochs=epochs, seed=ctx.seed % (1 << 63), verbose=0, device=device)
    spe = len(loader)
    # Trainer.fit's set-up (trainer.py): module on the device, schedules, optimizer, accumulation
    module.to(device)
    if hasattr(module, "setup_schedules"):
        module.setup_schedules(spe, epochs)
    optimizer = module.configure_optimizer(spe, epochs)
    optimizer.set_mesh(None)
    optimizer.every_k = 1
    if ctx.fault == "state_unchanged":
        optimizer._apply = lambda grads: None
    elif ctx.fault == "teacher_unchanged":
        module._teacher_ema = lambda step: None
    elif ctx.fault == "half_batch":
        place = trainer._place
        trainer._place = lambda batch: place({k: v[: len(v) // 2] for k, v in batch.items()})
    elif ctx.fault is not None:
        raise ValueError(f"no fault {ctx.fault!r} in this cell")

    def batches():
        while True:
            yield from loader

    state = {"module": module, "trainer": trainer, "optimizer": optimizer, "it": batches(), "spe": spe, "weights": weights,
             "frames": frames_dev, "extra": extra, "masks": [], "kept": {"losses": []}}
    if ctx.trace and tr["task"] == "dino":  # keep each step's masks: the kept keys of the attention's roofline
        draw = module.sample_masks

        def sample_masks(generator, batch):
            out = draw(generator, batch)
            state["masks"].append(out)
            return out

        module.sample_masks = sample_masks

    trainable = dict(module.trainable_parameters())
    kept = state["kept"]
    for i in range(tr["check_steps"]):
        loss, _ = step(state, ctx)
        kept["losses"].append(loss)
        if i == 0:
            kept["first"] = first_gradients(optimizer, trainable)
    kept["params"] = {k: p.detach().clone() for k, p in trainable.items()}
    if tr["task"] == "dino":
        kept["center"] = module.center.detach().clone()
        kept["teachers"] = {k: p.detach().clone() for k, p in module.named_parameters() if k.startswith("teacher_")}
    state["masks"].clear()
    ctx.spans.pop("loader", None)  # the window's loader spans only
    ctx.span("setup.build", t1 - t0)
    ctx.span("setup.first_steps", time.perf_counter() - t1)
    return state


def first_gradients(optimizer, trainable: dict) -> dict:
    """The first gradient as the optimizer took it: AdamW's first moment after one step / (1 - b1)."""
    adamw = getattr(optimizer, "adamw", None)
    if adamw is None:  # the planted unchanged state: no step was taken
        return {k: torch.zeros_like(p) for k, p in trainable.items()}
    b1 = adamw.param_groups[0]["betas"][0]
    out = {}
    for k, p in trainable.items():
        st = adamw.state.get(p, {})
        out[k] = st["exp_avg"] / (1.0 - b1) if "exp_avg" in st else torch.zeros_like(p)
    return out


def step(state, ctx):
    trainer = state["trainer"]
    t0 = time.perf_counter()
    batch = next(state["it"])
    ctx.span("loader", time.perf_counter() - t0)
    loss, _ = trainer.train_step(state["module"], state["optimizer"], trainer._place(batch))
    trainer.global_step += 1
    return loss, batch


def kept_keys(ctx, masks) -> dict:
    """Mean kept keys per row (registers included) of the global and the local passes of the
    steps whose masks are ``masks``, by name and by the passes' (rows, length)."""
    cfg = ctx.config
    n_tok = (cfg["img_size"] // cfg["patch_size"]) ** 2 + cfg["num_register_tokens"]
    out = {}
    for which, name in ((0, "global"), (1, "local")):
        ms = torch.stack([m[which] for m in masks]).float()  # (steps, M, B, N)
        out[name] = out[(ms.shape[1] * cfg["batch_size"], n_tok)] = float(ms.sum(-1).mean()) + cfg["num_register_tokens"]
    return out


def window(state, ctx, seconds):
    _sync(ctx.device)
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        step(state, ctx)
        steps += 1
    _sync(ctx.device)
    elapsed = time.perf_counter() - t0
    kept = kept_keys(ctx, state["masks"]) if state["masks"] else None
    flops = counting.vit_step_flops(ctx.config, ctx.traffic["task"], ctx.config["batch_size"], kept)
    ctx.counts.update(steps=steps, window_s=elapsed, model_flops=steps * flops)
    metric = "pretrain_images_per_s" if ctx.traffic["task"] == "dino" else "task_images_per_s"
    return {metric: stats.rate(steps * ctx.config["batch_size"], elapsed)}, steps, 0


def traced(state, ctx):
    """``trace_steps`` more steps traced with device activity alone, then as many with host
    operators (the kept keys of the attention's roofline come from these)."""
    n = ctx.traffic["trace_steps"]

    def run():
        for _ in range(n):
            step(state, ctx)

    timeline = record(ctx.device, False, run)
    state["masks"].clear()
    detail = record(ctx.device, True, run)
    if state["masks"]:
        ctx.counts["kept_keys"] = kept_keys(ctx, state["masks"])
    ctx.counts["steps_traced"] = n
    return timeline, detail


def _check_batches(ctx, state):
    """The loader's first batches, worked out again from the frames and the loader's seed."""
    cfg = ctx.config
    frames = state["frames"]
    span = (cfg["num_frames"] - 1) * cfg["frame_stride"]
    n = frames.shape[0] - span
    order = np.random.default_rng(LOADER_SEED).permutation(n)
    dino = ctx.traffic["task"] == "dino"
    background = frames[0] if (cfg["remove_background"] if dino else cfg["force_remove_background"]) else torch.full_like(frames[0], 127)
    if not dino:
        force = torch.as_tensor(state["extra"]["force"], device=frames.device)
        scale = force.abs().max(dim=0, keepdim=True).values + 1e-8
    b = cfg["batch_size"]
    for i in range(ctx.traffic["check_steps"]):
        starts = torch.as_tensor(order[i * b : (i + 1) * b], device=frames.device)
        x = frames_to_images(frames, starts, cfg["num_frames"], cfg["frame_stride"], background)
        yield x if dino else (x, force[starts + span] / scale)


def reference_numbers(ctx, state, losses, first, after, center=None, teachers=None, kind: str = "f32") -> dict:
    cfg, weights = ctx.config, state["weights"]
    steps = ctx.traffic["check_steps"]
    with numerics(kind) as num:
        if ctx.traffic["task"] == "dino":
            r_losses, r_first, r_after, r_center, r_teachers = dino_steps(cfg, num, weights, _check_batches(ctx, state), ctx.seed % (1 << 63),
                                                              state["spe"], steps, ctx.device)
        else:
            r_losses, r_first, r_after = force_probe_steps(cfg, num, weights, _check_batches(ctx, state), state["spe"], steps, ctx.device)
    moved = compare.moved_leaves(r_first)
    before = {k: weights[k] for k in r_after}
    grad_gap, grad_leaf = compare.leaf_norm_gap(first, r_first)
    update_gap, update_leaf = compare.leaf_norm_gap(compare.change(after, before), compare.change(r_after, before), moved)
    ctx.counts["worst_leaves"] = {"grad_gap": grad_leaf, "update_gap": update_leaf}
    out = {"loss_gap": compare.loss_gap(losses, r_losses), "grad_gap": grad_gap, "update_gap": update_gap}
    if center is not None:
        c, r = float(center.double().norm()), float(r_center.double().norm())  # norms taken in double, not rounded to f32
        out["center_gap"] = abs(c - r) / max(r, 1e-30)
    if teachers is not None:  # the teachers' change by the EMA over the check's steps, by the worst leaf
        t0 = {k: weights[k] for k in r_teachers}
        out["teacher_gap"], ctx.counts["worst_leaves"]["teacher_gap"] = compare.leaf_norm_gap(
            compare.change(teachers, t0), compare.change(r_teachers, t0))
    return out


def check(state, ctx) -> dict:
    kept = state["kept"]
    losses = [float(x) for x in kept["losses"]]
    frozen = {}
    if ctx.traffic["task"] != "dino":  # a frozen encoder stays bit-equal to its weights
        params = dict(state["module"].named_parameters())
        frozen["encoder_change"] = max(float((params[k].detach() - w).abs().max()) for k, w in state["weights"].items()
                                       if k.startswith("model_encoder."))
    for k in ("module", "trainer", "optimizer", "it"):
        state[k] = None  # the program's state is freed before the reference runs
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return {**reference_numbers(ctx, state, losses, kept["first"], kept["params"], kept.get("center"), kept.get("teachers")), **frozen}


def control(state, ctx, kind: str) -> dict:
    """The reference in ``kind`` put in the program's place, held to the same numbers."""
    cfg, steps = ctx.config, ctx.traffic["check_steps"]
    with numerics(kind) as num:
        if ctx.traffic["task"] == "dino":
            losses, first, after, center, teachers = dino_steps(cfg, num, state["weights"], _check_batches(ctx, state), ctx.seed % (1 << 63),
                                                                state["spe"], steps, ctx.device)
        else:
            center = teachers = None
            losses, first, after = force_probe_steps(cfg, num, state["weights"], _check_batches(ctx, state), state["spe"], steps, ctx.device)
    return reference_numbers(ctx, state, losses, first, after, center, teachers)
