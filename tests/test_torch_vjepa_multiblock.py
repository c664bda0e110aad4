"""V-JEPA's multi-block 3-D masks and its published training step in the port (ssl/masks.py,
ssl/vjepa.py, train/builders.py), against the benchmark's plain reference (benchmark/reference/vjepa.py)
on the CPU.

Tiny sizes for the step: clips of 4 frames of 32 x 32 x 3, tubelet 2, patch 8 (a 2 x 4 x 4 grid, 32
tokens); the encoder 64 wide, 2 blocks of 2 heads, no LayerScale; the predictor 48 wide, 2 blocks
of 2 heads of 24 (a head size that is no multiple of 16), one zero-initialised mask token for each
of two generators. f32, weights drawn by the benchmark's seeded draw, the target behind its encoder.
"""
import math

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import vjepa as ref
from benchmark.reference.numerics import numerics
from benchmark.weights import load_into, make_weights, parameter_shapes
from m3l_tpu_torch.data import DataLoader, VisionTactileDataset
from m3l_tpu_torch.models.vit import VisionTransformer
from m3l_tpu_torch.ssl import VJEPAModule, as_float_image
from m3l_tpu_torch.ssl import masks as tmasks
from m3l_tpu_torch.train import Trainer
from m3l_tpu_torch.train.builders import build_predictor, build_vit, build_vjepa
from m3l_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PUBLISHED = [  # configs/pretrain/vitl16.yaml
    dict(num_blocks=8, spatial_scale=(0.15, 0.15), aspect_ratio=(0.75, 1.5), temporal_scale=(1.0, 1.0)),
    dict(num_blocks=2, spatial_scale=(0.7, 0.7), aspect_ratio=(0.75, 1.5), temporal_scale=(1.0, 1.0)),
]
GRID = (8, 14, 14)
TINY_GRID = (2, 4, 4)
VIDEO = dict(img_size=(32, 32), patch_size=8, in_chans=3, num_frames=4, tubelet_size=2, pos_embed_fn="sinusoidal")
CFG = dict(  # the reference's view of the tiny model and the published recipe, with a clip that bites
    embed_dim=64, depth=2, num_heads=2, mlp_ratio=4.0, img_size=32, patch_size=8, num_frames=4, tubelet_size=2, in_chans=3,
    pred_embed_dim=48, pred_depth=2, pred_num_heads=2, mask=PUBLISHED, start_lr=2e-4, lr=6.25e-4, final_lr=1e-6, weight_decay=0.04,
    final_weight_decay=0.4, clip_grad=0.05, ema=(0.998, 1.0), ipe=300, ipe_scale=1.25, epochs=300, warmup=40,
)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("grid", [GRID, TINY_GRID, (4, 6, 5)])
def test_the_sampler_equals_the_reference_from_the_same_uniforms(seed, grid):
    gen = torch.Generator().manual_seed(seed)
    for spec in PUBLISHED + [dict(num_blocks=3, spatial_scale=(0.2, 0.6), aspect_ratio=(0.5, 2.0), temporal_scale=(0.5, 1.0))]:
        d = tmasks.sample_multiblock_masks(gen, 5, grid, tmasks.MultiBlock3D(**spec))
        context, target, redraws = ref.multiblock_masks(d.uniforms, grid, spec)
        assert torch.equal(d.context, context) and torch.equal(d.target, target) and d.redraws == redraws, spec
        again = tmasks.multiblock_masks_from_uniforms(d.uniforms["size"], d.uniforms["start"], d.uniforms["top"], d.uniforms["left"], grid,
                                                      tmasks.MultiBlock3D(**spec))
        assert torch.equal(again.context, d.context) and torch.equal(again.target, d.target) and again.redraws == d.redraws


def test_a_clip_without_context_is_drawn_again():
    """Two 4 x 3 blocks can cover the 4 x 4 grid: the clips whose first round does are drawn again,
    in both samplers alike."""
    spec = dict(num_blocks=2, spatial_scale=(0.7, 0.7), aspect_ratio=(0.75, 0.75), temporal_scale=(1.0, 1.0))
    gen = torch.Generator().manual_seed(3)
    redraws = 0
    for _ in range(20):
        d = tmasks.sample_multiblock_masks(gen, 8, TINY_GRID, tmasks.MultiBlock3D(**spec))
        redraws += d.redraws
        assert d.uniforms["start"].shape[0] >= 1 + (d.redraws > 0)
        assert ref.multiblock_masks(d.uniforms, TINY_GRID, spec)[2] == d.redraws
        assert d.context.shape[1] >= 1
    assert redraws > 0
    always = tmasks.MultiBlock3D(num_blocks=1, spatial_scale=(1.0, 1.0), aspect_ratio=(1.0, 1.0))
    with pytest.raises(ValueError, match="no context"):
        tmasks.sample_multiblock_masks(gen, 2, TINY_GRID, always)


@pytest.mark.parametrize("u_aspect,sizes", [(0.0, [(8, 5, 6), (8, 10, 14)]), (1.0, [(8, 7, 4), (8, 14, 10)]), (0.5, [(8, 6, 5), (8, 12, 11)])])
def test_published_block_sizes(u_aspect, sizes):
    """keep = int(196 s) is 29 at 0.15 and 137 at 0.7; h = round(sqrt(keep ar)), w = round(sqrt(keep / ar))."""
    assert (int(196 * 0.15), int(196 * 0.7)) == (29, 137)
    for spec, want in zip(PUBLISHED, sizes):
        u = torch.tensor([0.3, 0.6, u_aspect])
        got = tmasks.multiblock_size(u, GRID, tmasks.MultiBlock3D(**spec))
        assert got == want == ref.block_size(u, GRID, spec)
        keep = int(196 * spec["spatial_scale"][0])
        ar = 0.75 + u_aspect * 0.75
        assert got[1:] == (min(round(math.sqrt(keep * ar)), 14), min(round(math.sqrt(keep / ar)), 14))


def test_published_masks_keep_a_context_and_are_cut_to_the_batch_minimum():
    gen = torch.Generator().manual_seed(0)
    n = math.prod(GRID)
    for _ in range(4):
        for spec in PUBLISHED:
            d = tmasks.sample_multiblock_masks(gen, 24, GRID, tmasks.MultiBlock3D(**spec))
            context, target = ref.multiblock_masks(d.uniforms, GRID, spec)[:2]
            assert torch.equal(d.context, context) and torch.equal(d.target, target)
            size = ref.block_size(d.uniforms["size"], GRID, spec)
            full = []  # each clip's whole lists, from its chosen round
            for b in range(24):
                for r in range(d.uniforms["start"].shape[0]):
                    keep = torch.ones(GRID, dtype=torch.bool)
                    for j in range(spec["num_blocks"]):
                        s0, t0, l0 = (math.floor(float(d.uniforms[k][r, b, j]) * (g - e + 1)) for k, g, e in zip(("start", "top", "left"), GRID, size))
                        keep[s0 : s0 + size[0], t0 : t0 + size[1], l0 : l0 + size[2]] = False
                    if keep.any():
                        break
                full.append(keep.flatten())
            full = torch.stack(full)
            assert (full.sum(-1) > 0).all()  # no context is empty
            assert d.context.shape[1] == int(full.sum(-1).min()) and d.target.shape[1] == int((~full).sum(-1).min())
            assert d.context.max() < n and (d.context[:, 1:] > d.context[:, :-1]).all() and (d.target[:, 1:] > d.target[:, :-1]).all()
            assert not full.gather(1, d.target).any() and full.gather(1, d.context).all()


def tiny_module(**kw):
    encoder = VisionTransformer(**VIDEO, embed_dim=64, depth=2, num_heads=2, init_values=None)
    predictor = build_predictor(encoder, embed_dim=48, depth=2, num_heads=2, num_mask_tokens=2, zero_init_mask_tokens=True, init_values=None)
    return VJEPAModule(encoder, predictor, mask_generators=PUBLISHED, loss_exp=1.0, reg_coeff=0.0, moving_average_decay=CFG["ema"],
                       base_lr=CFG["lr"], start_lr=CFG["start_lr"], final_lr=CFG["final_lr"], weight_decay=CFG["weight_decay"],
                       final_weight_decay=CFG["final_weight_decay"], warmup_epochs=CFG["warmup"], **kw)


def seeded(module, seed):
    """The benchmark's weights, and the target 0.9 x the encoder + 0.1 x a draw of its own."""
    shapes = parameter_shapes(module, ("target_encoder.",))
    weights = make_weights(shapes, seed, "cpu")
    enc = {k: s for k, s in shapes.items() if k.startswith("context_encoder.")}
    lag = make_weights(enc, seed, "cpu", stream=4)
    weights.update({"target_encoder." + k[len("context_encoder."):]: 0.9 * weights[k] + 0.1 * lag[k] for k in enc})
    load_into(module, weights)
    return weights


def test_loss_gradients_adamw_clip_and_ema_equal_the_reference():
    module = tiny_module(mask_seed=11)
    assert module.predictor.blocks[0].attn.head_dim == 24
    weights = seeded(module, 5)
    epochs = int(CFG["epochs"] * CFG["ipe_scale"])
    trainer = Trainer(max_epochs=epochs, clip_gradients=CFG["clip_grad"], device="cpu")
    module.setup_schedules(CFG["ipe"], epochs)
    optimizer = module.configure_optimizer(CFG["ipe"], epochs)
    optimizer.clip_norms = (CFG["clip_grad"],)
    drawn, real = [], module.sample_multiblock
    module.sample_multiblock = lambda g, b: drawn.append(real(g, b)) or drawn[-1]
    x = torch.rand((3, 4, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    batches = [x, x.flip(0)]
    trainable = dict(module.trainable_parameters())
    losses, first = [], None
    for step, xb in enumerate(batches):
        loss, _ = trainer.train_step(module, optimizer, {"image": xb})
        if step == 0:
            first = {k: optimizer.adamw.state[p]["exp_avg"] / 0.1 for k, p in trainable.items()}
        trainer.global_step += 1
        losses.append(float(loss))
    with numerics("f32") as num:
        r_losses, r_first, r_after, r_target, r_masks = ref.vjepa_steps(CFG, num, weights, batches, [[d.uniforms for d in s] for s in drawn],
                                                                        2, "cpu", 2)
    for s, made in zip(drawn, r_masks):
        for d, (c, t, r) in zip(s, made):
            assert torch.equal(d.context, c) and torch.equal(d.target, t) and d.redraws == r
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    norm = math.sqrt(sum(float((g * g).sum()) for g in r_first.values()))
    assert abs(norm - CFG["clip_grad"]) < 1e-5  # the clip bit: the gradient AdamW took has the clip's norm
    assert compare.leaf_norm_gap(first, r_first)[0] < 1e-5
    scale = max(float(g.abs().max()) for g in r_first.values())
    for k, g in r_first.items():
        np.testing.assert_allclose(first[k].numpy(), g.numpy(), atol=1e-5 * scale, err_msg=k)
    assert not r_first["predictor.patch_embed.proj.weight"].any()  # the predictor's embedding is never used
    moved = compare.moved_leaves(r_first)
    after = {k: p.detach() for k, p in trainable.items()}
    before = {k: weights[k] for k in after}
    assert compare.leaf_norm_gap(compare.change(after, before), compare.change(r_after, before), moved)[0] < 1e-4
    target = {k: p.detach() for k, p in module.named_parameters() if k.startswith("target_encoder.")}
    t0 = {k: weights[k] for k in target}
    assert compare.leaf_norm_gap(compare.change(target, t0), compare.change(r_target, t0))[0] < 1e-4
    for k, v in r_target.items():
        np.testing.assert_allclose(target[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_the_module_counts_its_masks_and_names_its_spans():
    module = tiny_module(mask_seed=3)
    trace.start()
    loss, aux = module.training_loss({"image": torch.randint(0, 256, (4, 4, 32, 32, 3), dtype=torch.uint8)}, None, 7)
    spans = trace.stop()
    assert torch.isfinite(loss) and set(aux) == {"loss", "loss_jepa", "loss_reg"}
    assert len(module.mask_counts) == 2 and all(c > 0 and t > 0 and c + t <= 32 for c, t in module.mask_counts)
    assert [(s.name, s.ident) for s in spans] == [("vjepa.masks", None), ("vjepa.target", None), ("vjepa.context", 0), ("vjepa.predict", 0),
                                                  ("vjepa.context", 1), ("vjepa.predict", 1)]
    # the masks of a step come from (mask_seed, step): the same step draws them again, another does not
    a = module.sample_multiblock(module.mask_generator(7), 4)
    b = module.sample_multiblock(module.mask_generator(7), 4)
    c = module.sample_multiblock(module.mask_generator(8), 4)
    assert all(torch.equal(x.context, y.context) for x, y in zip(a, b))
    assert (a[0].context.shape[1], a[1].context.shape[1]) == tuple(n for n, _ in module.mask_counts)
    assert any(not torch.equal(x.target, y.target) for x, y in zip(a, c))
    redraws = module.mask_redraws
    for step in range(20):  # the counter adds each step's redrawn clips
        want = sum(d.redraws for d in module.sample_multiblock(module.mask_generator(step), 2))
        module.multiblock_loss(torch.rand(2, 4, 32, 32, 3), step)
        assert module.mask_redraws == redraws + want
        redraws = module.mask_redraws


def test_too_few_mask_tokens_are_refused():
    encoder = VisionTransformer(**VIDEO, embed_dim=64, depth=1, num_heads=2)
    with pytest.raises(ValueError, match="mask tokens"):
        VJEPAModule(encoder, build_predictor(encoder, embed_dim=48, depth=1, num_heads=2), mask_generators=PUBLISHED)


def test_builders_pass_the_published_settings():
    vit = build_vit("tiny", patch_size=8, img_size=(32, 32), in_chans=3, num_register_tokens=0, num_frames=4, depth=1, init_values=None,
                    compute_dtype="bfloat16")
    assert not [n for n, _ in vit.named_parameters() if "gamma" in n]
    default = build_vit("tiny", patch_size=8, img_size=(32, 32), depth=1)  # LayerScale on by default, as the DINO cell builds it
    assert sorted(n for n, _ in default.named_parameters() if "gamma" in n) == ["blocks.0.ls1.gamma", "blocks.0.ls2.gamma"]
    module = build_vjepa(vit, predictor_depth=2, predictor_dim=48, predictor_num_heads=2, predictor_init_values=None,
                         predictor_compute_dtype="bfloat16", zero_init_mask_tokens=True, mask_generators=PUBLISHED, seed=4)
    pred = module.predictor
    assert (pred.num_heads, pred.blocks[0].attn.head_dim, pred.num_mask_tokens, pred.dtype, module.mask_seed) == (2, 24, 2, torch.bfloat16, 4)
    assert all(not t.any() for t in pred.mask_tokens) and pred.blocks[0].ls1 is None
    assert build_vjepa(vit).predictor.num_mask_tokens == 1 and build_vjepa(vit).mask_generators is None


def test_the_uint8_video_batch_scales_to_the_float_batch():
    frames = np.random.default_rng(0).integers(0, 256, (40, 8, 8, 3), dtype=np.uint8)
    ds = VisionTactileDataset(frames, num_frames=4, frame_stride=3, out_format="video")
    for batch in DataLoader(ds, batch_size=5, seed=1):
        assert batch["image"].dtype == np.uint8 and batch["image"].shape == (5, 4, 8, 8, 3)
        starts = [int(np.flatnonzero((frames == b[0]).all(axis=(1, 2, 3)))[0]) for b in batch["image"]]
        before = np.stack([frames[[s + 3 * i for i in range(4)]].astype(np.float32) / 255.0 for s in starts])  # the float batch it replaced
        np.testing.assert_array_equal(as_float_image(torch.from_numpy(batch["image"])).numpy(), before)
