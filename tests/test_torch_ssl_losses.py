"""The port's SSL losses, EMA and mask samplers (ssl/losses.py, ssl/ema.py, ssl/masks.py) against
the JAX package on the CPU.

Every loss, its gradient where a module differentiates it, and the center updates take the same
numpy inputs on both sides (f32: rtol 1e-5). The mask helpers take the uniforms JAX drew and must
give equal masks; the samplers' own draws (a torch generator) are checked for their properties:
block shape and area, constrained masks that avoid the forbidden patches or fall back, and the
static keep count of tube masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_params import TOL, t
from m3l_tpu.ssl import ema as jema
from m3l_tpu.ssl import losses as jl
from m3l_tpu.ssl import masks as jm
from m3l_tpu_torch.ssl import ema as tema
from m3l_tpu_torch.ssl import losses as tl
from m3l_tpu_torch.ssl import masks as tm


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def close(out, ref, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("shape", [(5, 12), (3, 7, 12)], ids=["cls", "patch"])
def test_softmax_center_and_update_center(shape):
    logits, center = normal(shape, 0, 3.0), normal((1,) * (len(shape) - 1) + (12,), 1)
    close(tl.softmax_center_teacher(t(center), t(logits), 0.04), jl.softmax_center_teacher(jl.DINOLossState(jnp.asarray(center)), jnp.asarray(logits), 0.04))
    new = tl.update_center(t(center), t(logits), momentum=0.9)
    ref = jl.update_center(jl.DINOLossState(jnp.asarray(center)), jnp.asarray(logits), momentum=0.9).center
    assert new.shape == center.shape
    close(new, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_knopp(masked):
    logits = normal((24, 10), 2, 0.2)
    kw, tkw = {}, {}
    if masked:
        keep = np.random.default_rng(3).random(24) > 0.4
        kw = dict(n_samples=jnp.asarray(keep.sum()), sample_mask=jnp.asarray(keep))
        tkw = dict(n_samples=t(keep).sum(), sample_mask=t(keep))
    out = tl.sinkhorn_knopp_teacher(t(logits), 0.05, **tkw)
    close(out, jl.sinkhorn_knopp_teacher(jnp.asarray(logits), 0.05, **kw))
    if masked:
        assert (out.numpy()[~keep] == 0).all() and np.isfinite(out.numpy()).all()


def test_dino_cross_entropy_and_gradient():
    students = [normal((4, 16), s) for s in range(3)]
    teachers = [np.asarray(jax.nn.softmax(jnp.asarray(normal((4, 16), 10 + s)), -1)) for s in range(2)]
    ss = [t(s).requires_grad_(True) for s in students]
    loss = tl.dino_cross_entropy(ss, [t(x) for x in teachers], 0.1)
    loss.backward()
    ref, grads = jax.value_and_grad(lambda s: jl.dino_cross_entropy(s, [jnp.asarray(x) for x in teachers], 0.1))([jnp.asarray(s) for s in students])
    close(loss, ref)
    for s, g in zip(ss, grads):
        close(s.grad, g)


def test_ibot_patch_loss():
    logits, probs = normal((3, 6, 8), 4), np.asarray(jax.nn.softmax(jnp.asarray(normal((3, 6, 8), 5)), -1))
    mask = np.random.default_rng(6).random((3, 6)) > 0.5
    mask[1] = False  # a sample with nothing masked is weighted by 1 / max(0, 1)
    close(tl.ibot_patch_loss(t(logits), t(probs), t(mask)), jl.ibot_patch_loss(jnp.asarray(logits), jnp.asarray(probs), jnp.asarray(mask)))


def test_ibot_patch_loss_all_pairs_and_gradient():
    logits, probs = normal((2, 3, 6, 8), 7), np.asarray(jax.nn.softmax(jnp.asarray(normal((2, 3, 6, 8), 8)), -1))
    keep = np.random.default_rng(9).random((2, 3, 6)) > 0.5
    s = t(logits).requires_grad_(True)
    loss = tl.ibot_patch_loss_all_pairs(s, t(probs), t(keep), 0.1)
    loss.backward()
    ref, grad = jax.value_and_grad(lambda x: jl.ibot_patch_loss_all_pairs(x, jnp.asarray(probs), jnp.asarray(keep), 0.1))(jnp.asarray(logits))
    close(loss, ref)
    close(s.grad, grad)


def test_koleo_loss_and_gradient():
    x = normal((7, 12), 11)
    s = t(x).requires_grad_(True)
    loss = tl.koleo_loss(s)
    loss.backward()
    ref, grad = jax.value_and_grad(jl.koleo_loss)(jnp.asarray(x))
    close(loss, ref)
    close(s.grad, grad, dict(rtol=1e-4, atol=1e-6))


def test_koleo_gradient_is_finite_with_duplicate_and_zero_rows():
    x = normal((6, 8), 12)
    x[3] = x[1]  # two equal rows: distance 0 inside the square root
    x[5] = 0.0  # an all-zero row: norm 0 inside the normalisation
    s = t(x).requires_grad_(True)
    loss = tl.koleo_loss(s)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(s.grad).all()
    close(loss, jl.koleo_loss(jnp.asarray(x)))


@pytest.mark.parametrize("decay", [0.99, 0.9964999556541443, 0.5])
def test_ema_update_equals_jax(decay):
    teacher = [normal((5, 3), 13), normal((4,), 14)]
    student = [normal((5, 3), 15), normal((4,), 16)]
    params = [t(a) for a in teacher]
    tema.ema_update(params, [t(a) for a in student], decay)
    ref = jema.ema_update([jnp.asarray(a) for a in teacher], [jnp.asarray(a) for a in student], jnp.asarray(decay, jnp.float32))
    for p, r in zip(params, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_ema_update_rejects_unmatched_lists():
    with pytest.raises(ValueError, match="teacher tensors"):
        tema.ema_update([torch.zeros(2)], [], 0.9)


# ---------------------------------------------------------------- masks #
MASK_CASES = [((4, 4), (0.2, 0.8), 3, 5, 0), ((14, 14), (0.15, 0.2), 4, 3, 1), ((14, 14), (0.85, 1.0), 1, 6, 2), ((3, 5), (0.1, 0.9), 2, 4, 3)]


def jax_block_uniforms(key, batch, n_masks):
    """The uniforms m3l_tpu/ssl/masks.py:sample_block_masks draws from ``key``."""
    k_size, k_top, k_left = jax.random.split(key, 3)
    return (t(np.asarray(jax.random.uniform(k_size))), t(np.asarray(jax.random.uniform(k_top, (n_masks, batch)))),
            t(np.asarray(jax.random.uniform(k_left, (n_masks, batch)))))


@pytest.mark.parametrize("grid,scale,n_masks,batch,seed", MASK_CASES)
def test_block_masks_from_jax_uniforms_equal_jax(grid, scale, n_masks, batch, seed):
    key = jax.random.PRNGKey(seed)
    out = tm.block_masks_from_uniforms(*jax_block_uniforms(key, batch, n_masks), grid, scale)
    ref = jm.sample_block_masks(key, batch, grid, scale, n_masks)
    assert out.dtype == torch.bool and out.shape == (n_masks, batch, grid[0] * grid[1])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("grid,scale,n_masks,batch,seed", MASK_CASES)
def test_constrained_masks_from_jax_uniforms_equal_jax(grid, scale, n_masks, batch, seed):
    key = jax.random.PRNGKey(seed + 100)
    forbidden = np.random.default_rng(seed).random((batch, grid[0] * grid[1])) > 0.6
    raw = tm.block_masks_from_uniforms(*jax_block_uniforms(key, batch, n_masks), grid, scale)
    out = tm.constrain(raw, t(forbidden), 2)
    ref = jm.sample_block_masks_constrained(key, batch, grid, scale, n_masks, jnp.asarray(forbidden), 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_tube_masks_from_jax_noise_equal_jax():
    key = jax.random.PRNGKey(4)
    noise = t(np.asarray(jax.random.uniform(key, (2, 3, 16))))
    np.testing.assert_array_equal(tm.tube_masks_from_noise(noise, 4, 0.75).numpy(), np.asarray(jm.random_tube_masks(key, 3, (4, 4, 4), 0.75, 2)))


def rectangle(mask: np.ndarray, grid) -> tuple[int, int]:
    """(h, w) of the one axis-aligned rectangle ``mask`` (N,) holds; fails otherwise."""
    rows, cols = np.nonzero(mask.reshape(grid))
    h, w = rows.max() - rows.min() + 1, cols.max() - cols.min() + 1
    assert mask.sum() == h * w, "not a rectangle"
    return h, w


@pytest.mark.parametrize("grid,scale", [((14, 14), (0.2, 0.8)), ((14, 14), (0.15, 0.2)), ((8, 12), (0.3, 0.5))])
def test_block_mask_sampler_shape_and_area(grid, scale):
    gen = torch.Generator().manual_seed(0)
    n = grid[0] * grid[1]
    for _ in range(20):
        masks = tm.sample_block_masks(gen, 6, grid, scale, 3).numpy()
        sizes = {rectangle(m, grid) for m in masks.reshape(-1, n)}
        assert len(sizes) == 1  # one block size per call
        h, w = sizes.pop()
        # the side is round(sqrt(area * N)), clipped to the grid
        lo, hi = np.sqrt(scale[0] * n), np.sqrt(scale[1] * n)
        for side, g in ((h, grid[0]), (w, grid[1])):
            assert min(np.floor(lo), g) <= side <= min(np.ceil(hi), g)


def test_constrained_sampler_avoids_forbidden_or_falls_back():
    grid, gen = (14, 14), torch.Generator().manual_seed(1)
    local = tm.sample_block_masks(gen, 16, grid, (0.2, 0.8), 4)
    forbidden = local.any(0)
    glob = tm.sample_block_masks_constrained(gen, 16, grid, (0.2, 0.8), 2, forbidden, 4).numpy()
    avoided = ~(glob & forbidden.numpy()[None]).any(-1)
    assert avoided.any() and (glob[avoided].sum(-1) > 4).all()
    for m in glob[~avoided]:
        rectangle(m, grid)  # fell back to the raw block
    # with everything forbidden every mask falls back to its raw block
    full = tm.sample_block_masks_constrained(torch.Generator().manual_seed(2), 3, grid, (0.2, 0.8), 2, torch.ones(3, 196, dtype=torch.bool), 4)
    raw = tm.sample_block_masks(torch.Generator().manual_seed(2), 3, grid, (0.2, 0.8), 2)
    assert torch.equal(full, raw)


def test_tube_mask_sampler_keeps_a_static_count_per_frame():
    gen = torch.Generator().manual_seed(3)
    masks = tm.random_tube_masks(gen, 5, (4, 14, 14), 0.9, 2).numpy().reshape(2, 5, 4, 196)
    keep = round(196 * 0.1)
    assert (masks.sum(-1) == keep).all() and (masks == masks[:, :, :1]).all()
    assert tm.random_tube_masks(gen, 1, (2, 2, 2), 0.99, 1).sum() == 2  # at least one a frame


def test_samplers_draw_from_the_generator():
    a = tm.sample_block_masks(torch.Generator().manual_seed(5), 4, (14, 14), (0.2, 0.8), 3)
    b = tm.sample_block_masks(torch.Generator().manual_seed(5), 4, (14, 14), (0.2, 0.8), 3)
    c = tm.sample_block_masks(torch.Generator().manual_seed(6), 4, (14, 14), (0.2, 0.8), 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
