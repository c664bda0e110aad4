"""V-JEPA pretraining through the SSL Trainer's inner loop (``train/trainer.py`` ``Trainer.fit``): a
batch of uint8 clips from the port's ``DataLoader`` (``VisionTactileDataset`` in its ``video``
format), placed on the card by ``Trainer._place``, then ``Trainer.train_step`` on the module that
``train.builders.build_vjepa`` builds over ``build_vit``, with the configuration's multi-block mask
generators (``config["mask"]``).

The schedules and the optimizer are set up as ``fit`` sets them, with the published horizon: ``ipe``
steps an epoch for ``epochs`` x ``ipe_scale`` epochs, and the Trainer's global-norm clip at
``clip_grad``. Frames are made on the card from the seed (uint8, uniform over 0-254); there are
``epoch_batches`` batches an epoch. The target starts behind its encoder: 0.9 x the encoder's
weights + 0.1 x a draw of its own, so that each step's EMA moves it by a share of that lag that the
check can read.

Set-up runs the first ``check_steps`` steps: the warm-up, and the check's steps, whose losses,
first gradients (AdamW's first moment), masks with the uniforms they came from, and trainable
parameters and target after the last are kept. The window then runs steps until its length has
passed and synchronises; the benchmark's span ``loader`` times each ``next()`` of the loader, and
each step's model operations are counted from the token counts the module kept for it. The traced
windows record the program's spans (``utils/trace.py``) too; those of ``vjepa.masks`` become the
benchmark's span of that name.

The check runs the plain reference (``reference/vjepa.py``) over the same clips from the same
weights, in chunks of ``reference_clips`` clips, its masks made by its own sampler from the
program's uniforms: ``mask_gap`` counts the (step, generator) pairs whose index lists or redraws
differ from the program's, and must be 0.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import compare, stats
from ..counting_vjepa import vjepa_step_flops
from ..devtrace import record
from ..reference.numerics import numerics
from ..reference.vjepa import vjepa_steps
from ..weights import load_into, make_weights, parameter_shapes
from .ssl_trainer import LOADER_SEED, TEACHER_LAG, first_gradients, make_frames

MASK_FIELDS = ("num_blocks", "spatial_scale", "aspect_ratio", "temporal_scale")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mask_generators(cfg: dict) -> list[dict]:
    """The generators as the module takes them; a context cut in time or capped is not modelled."""
    out = []
    for g in cfg["mask"]:
        if g.get("max_temporal_keep", 1.0) != 1.0 or g.get("max_keep") is not None:
            raise ValueError(f"the vjepa_trainer driver models no max_temporal_keep or max_keep: {g}")
        out.append({k: g[k] for k in MASK_FIELDS})
    return out


def build(ctx):
    """The module, its loader, the frames on the card and the benchmark's weights (loaded)."""
    from m3l_tpu_torch.data import DataLoader, VisionTactileDataset
    from m3l_tpu_torch.train.builders import build_vit, build_vjepa

    cfg, device = ctx.config, ctx.device
    seed = ctx.seed % (1 << 31)
    encoder = build_vit(cfg["model_size"], patch_size=cfg["patch_size"], img_size=[cfg["img_size"]] * 2, in_chans=cfg["in_chans"],
                        num_register_tokens=cfg["num_register_tokens"], pos_embed_fn=cfg["pos_embed_fn"], num_frames=cfg["num_frames"],
                        tubelet_size=cfg["tubelet_size"], depth=cfg["depth"], init_values=cfg["init_values"],
                        compute_dtype=cfg["compute_dtype"], seed=seed)
    module = build_vjepa(encoder, predictor_depth=cfg["pred_depth"], predictor_dim=cfg["pred_embed_dim"],
                         predictor_num_heads=cfg["pred_num_heads"], predictor_init_values=cfg["init_values"],
                         predictor_compute_dtype=cfg["compute_dtype"], zero_init_mask_tokens=cfg["zero_init_mask_tokens"],
                         mask_generators=mask_generators(cfg), mask_seed=ctx.seed, loss_exp=cfg["loss_exp"], reg_coeff=cfg["reg_coeff"],
                         moving_average_decay=tuple(cfg["ema"]), base_lr=cfg["lr"], start_lr=cfg["start_lr"], final_lr=cfg["final_lr"],
                         weight_decay=cfg["weight_decay"], final_weight_decay=cfg["final_weight_decay"], warmup_epochs=cfg["warmup"], seed=seed)
    pred, blk = module.predictor, encoder.blocks[0]
    built = (encoder.embed_dim, len(encoder.blocks), encoder.num_heads, blk.mlp.fc1.out_features, blk.ls1 is not None, tuple(encoder.patch_embed.grid),
             pred.embed_dim, len(pred.blocks), pred.num_heads, pred.num_mask_tokens, pred.blocks[0].ls1 is not None, encoder.dtype, pred.dtype)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]
    grid = (cfg["num_frames"] // cfg["tubelet_size"], cfg["img_size"] // cfg["patch_size"], cfg["img_size"] // cfg["patch_size"])
    wanted = (cfg["embed_dim"], cfg["depth"], cfg["num_heads"], int(cfg["embed_dim"] * cfg["mlp_ratio"]), cfg["init_values"] is not None, grid,
              cfg["pred_embed_dim"], cfg["pred_depth"], cfg["pred_num_heads"], len(cfg["mask"]), cfg["init_values"] is not None, dtype, dtype)
    if built != wanted:
        raise RuntimeError(f"build_vit and build_vjepa made {built}, the configuration states {wanted}")
    frames_dev = make_frames(cfg, ctx.traffic, ctx.seed, device)
    ds = VisionTactileDataset(frames_dev.cpu().numpy(), num_frames=cfg["num_frames"], frame_stride=cfg["frame_stride"], out_format="video")
    loader = DataLoader(ds, batch_size=cfg["batch_size"], seed=LOADER_SEED)
    shapes = parameter_shapes(module, ("target_encoder.",))
    weights = make_weights(shapes, ctx.seed, device)
    load_into(module, weights)
    encoder_shapes = {k: s for k, s in shapes.items() if k.startswith("context_encoder.")}
    lag = make_weights(encoder_shapes, ctx.seed, device, stream=4)
    target = {"target_encoder." + k[len("context_encoder."):]: (1.0 - TEACHER_LAG) * weights[k] + TEACHER_LAG * lag[k] for k in encoder_shapes}
    load_into(module, target)
    weights.update(target)
    return module, loader, frames_dev, weights


def _plant(ctx, module, trainer, optimizer) -> None:
    """A fault planted in the timed path (the tests and the readings of limits only)."""
    if ctx.fault is None:
        return
    if ctx.fault == "state_unchanged":  # every optimizer step leaves the parameters and moments as they were
        optimizer._apply = lambda grads: None
    elif ctx.fault == "half_batch":  # each step sees the first half of its clips
        place = trainer._place
        trainer._place = lambda batch: place({k: v[: len(v) // 2] for k, v in batch.items()})
    elif ctx.fault == "shared_mask_token":  # both generators' targets take the first generator's mask token
        pred = module.predictor
        pred._mask_token = lambda mask_index: pred.mask_tokens[0]
    elif ctx.fault == "target_unchanged":  # the target's EMA is never applied
        module.on_train_batch_end = lambda aux, step: None
    else:
        raise ValueError(f"no fault {ctx.fault!r} in this cell")


def setup(ctx):
    from m3l_tpu_torch.train.trainer import Trainer

    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    t0 = time.perf_counter()
    module, loader, frames_dev, weights = build(ctx)
    t1 = time.perf_counter()
    epochs = cfg["epochs"] * cfg["ipe_scale"]
    if epochs != int(epochs):
        raise ValueError(f"epochs x ipe_scale = {epochs} is not whole")
    epochs = int(epochs)
    trainer = Trainer(max_epochs=epochs, clip_gradients=cfg["clip_grad"], seed=ctx.seed % (1 << 63), verbose=0, device=device)
    # Trainer.fit(steps_per_epoch=ipe)'s set-up (trainer.py): module on the device, schedules, optimizer, clip, accumulation
    module.to(device)
    module.setup_schedules(cfg["ipe"], epochs)
    optimizer = module.configure_optimizer(cfg["ipe"], epochs)
    optimizer.set_mesh(None)
    optimizer.clip_norms = (trainer.clip_gradients, *optimizer.clip_norms)
    optimizer.every_k = 1
    _plant(ctx, module, trainer, optimizer)

    def batches():
        while True:
            yield from loader

    state = {"module": module, "trainer": trainer, "optimizer": optimizer, "it": batches(), "weights": weights, "frames": frames_dev,
             "kept": {"losses": [], "draws": []}}
    kept, trainable, draw = state["kept"], dict(module.trainable_parameters()), module.sample_multiblock
    # each check step's masks, with the uniforms they came from
    module.sample_multiblock = lambda generator, batch: kept["draws"].append(draw(generator, batch)) or kept["draws"][-1]
    for i in range(tr["check_steps"]):
        kept["losses"].append(step(state, ctx))
        if i == 0:
            kept["first"] = first_gradients(optimizer, trainable)
    del module.sample_multiblock
    kept["params"] = {k: p.detach().clone() for k, p in trainable.items()}
    kept["target"] = {k: p.detach().clone() for k, p in module.named_parameters() if k.startswith("target_encoder.")}
    ctx.spans.pop("loader", None)  # the window's loader spans only
    ctx.span("setup.build", t1 - t0)
    ctx.span("setup.first_steps", time.perf_counter() - t1)
    return state


def step(state, ctx):
    trainer, module = state["trainer"], state["module"]
    t0 = time.perf_counter()
    batch = next(state["it"])
    ctx.span("loader", time.perf_counter() - t0)
    loss, _ = trainer.train_step(module, state["optimizer"], trainer._place(batch))
    trainer.global_step += 1
    return loss


def window(state, ctx, seconds):
    cfg, module = ctx.config, state["module"]
    _sync(ctx.device)
    t0 = time.perf_counter()
    steps, flops = 0, 0.0
    while time.perf_counter() - t0 < seconds:
        step(state, ctx)
        steps += 1
        flops += vjepa_step_flops(cfg, cfg["batch_size"], module.mask_counts)
    _sync(ctx.device)
    elapsed = time.perf_counter() - t0
    ctx.counts.update(steps=steps, window_s=elapsed, model_flops=flops, mask_redraws=module.mask_redraws)
    return {"pretrain_images_per_s": stats.rate(steps * cfg["batch_size"], elapsed)}, steps, 0


def traced(state, ctx):
    """``trace_steps`` more steps traced with device activity alone, then as many with host
    operators; the program's spans are recorded over both."""
    from m3l_tpu_torch.utils import trace

    n = ctx.traffic["trace_steps"]

    def run():
        for _ in range(n):
            step(state, ctx)

    trace.start()
    try:
        timeline = record(ctx.device, False, run)
        detail = record(ctx.device, True, run)
    finally:
        spans = trace.stop()
    for s in spans:
        if s.name == "vjepa.masks":
            ctx.span(s.name, (s.end_ns - s.start_ns) * 1e-9)
    ctx.counts["steps_traced"] = n
    return timeline, detail


def check_batches(ctx, state):
    """The loader's first batches, worked out again from the frames and the loader's seed: clips
    (B, T, H, W, C) over 255."""
    cfg = ctx.config
    frames = state["frames"]
    n = frames.shape[0] - (cfg["num_frames"] - 1) * cfg["frame_stride"]
    order = np.random.default_rng(LOADER_SEED).permutation(n)
    b = cfg["batch_size"]
    offsets = cfg["frame_stride"] * torch.arange(cfg["num_frames"], device=frames.device)
    for i in range(ctx.traffic["check_steps"]):
        starts = torch.as_tensor(order[i * b : (i + 1) * b], device=frames.device)
        yield frames[starts[:, None] + offsets].float() / 255.0


def covering(uniforms: dict, batch: int) -> dict:
    """A generator's uniforms over ``batch`` clips: a draw for fewer (a fault's) widened by repeating
    its clips, which the program's context then stands for; its index lists count in ``mask_gap``."""
    have = uniforms["start"].shape[1]
    rows = torch.arange(batch) % have
    return {k: v if k == "size" else v[:, rows] for k, v in uniforms.items()}


def reference_numbers(ctx, state, losses, first, after, target, draws, kind: str = "f32") -> dict:
    cfg, weights = ctx.config, state["weights"]
    uniforms = [[covering(d.uniforms, cfg["batch_size"]) for d in drawn] for drawn in draws]
    with numerics(kind) as num:
        r_losses, r_first, r_after, r_target, r_masks = vjepa_steps(cfg, num, weights, check_batches(ctx, state), uniforms,
                                                                    ctx.traffic["check_steps"], ctx.device, ctx.traffic["reference_clips"])
    mask_gap = sum(not (torch.equal(d.context, c) and torch.equal(d.target, t) and d.redraws == r)
                   for drawn, made in zip(draws, r_masks) for d, (c, t, r) in zip(drawn, made))
    mask_gap += abs(len(draws) - len(r_masks))
    moved = compare.moved_leaves(r_first)
    before = {k: weights[k] for k in r_after}
    grad_gap, grad_leaf = compare.leaf_norm_gap(first, r_first)
    update_gap, update_leaf = compare.leaf_norm_gap(compare.change(after, before), compare.change(r_after, before), moved)
    t0 = {k: weights[k] for k in r_target}
    target_gap, target_leaf = compare.leaf_norm_gap(compare.change(target, t0), compare.change(r_target, t0))
    ctx.counts["worst_leaves"] = {"grad_gap": grad_leaf, "update_gap": update_leaf, "target_gap": target_leaf}
    return {"loss_gap": compare.loss_gap(losses, r_losses), "grad_gap": grad_gap, "update_gap": update_gap, "target_gap": target_gap,
            "mask_gap": float(mask_gap)}


def check(state, ctx) -> dict:
    kept = state["kept"]
    losses = [float(x) for x in kept["losses"]]
    for k in ("module", "trainer", "optimizer", "it"):
        state[k] = None  # the program's state is freed before the reference runs
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return reference_numbers(ctx, state, losses, kept["first"], kept["params"], kept["target"], kept["draws"])


def control(state, ctx, kind: str) -> dict:
    """The reference in ``kind`` put in the program's place, held to the same numbers (its masks
    made from the program's uniforms)."""
    cfg, drawn = ctx.config, state["kept"]["draws"]
    with numerics(kind) as num:
        losses, first, after, target, masks = vjepa_steps(cfg, num, state["weights"], check_batches(ctx, state),
                                                          [[covering(d.uniforms, cfg["batch_size"]) for d in step] for step in drawn],
                                                          ctx.traffic["check_steps"],
                                                          ctx.device, ctx.traffic["reference_clips"])
    made = [[SimpleNamespace(context=c, target=t, redraws=r, uniforms=d.uniforms) for (c, t, r), d in zip(step, ds)]
            for step, ds in zip(masks, drawn)]
    return reference_numbers(ctx, state, losses, first, after, target, made)
