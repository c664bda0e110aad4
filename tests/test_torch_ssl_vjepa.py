"""The port's V-JEPA (ssl/vjepa.py) against the JAX package on the CPU.

Tiny widths: the ViT at depth 2, dim 64, 2 heads x 32 on two 32x32x3 frames, patch 8, tubelet 2
(a 1 x 4 x 4 grid, 16 tokens; mask ratio 0.75 keeps 4 as context and predicts 12), no registers;
the predictor at depth 2, dim 32, 2 heads x 16, one mask token. Weights carried from JAX with
load_jax_params; the tube masks JAX draws from its key are passed in. f32 with the Conv3d patch
embedding on the path: rtol 2e-4 (CONV_TOL), gradients relative to the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, TOL, VIDEO, VIT, flat_state, flat_variables, images, t, vjepa_pair, vjepa_twin
from m3l_tpu.ssl import masks as jmasks
from m3l_tpu.ssl import vjepa as jvjepa
from m3l_tpu_torch.kernels import LAUNCHES, MASKED_LAUNCHES, reset_launches
from m3l_tpu_torch.models.vit import VisionTransformer, vit_predictor
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.ssl import VJEPAModule, masks as tmasks
from m3l_tpu_torch.ssl import vjepa as tvjepa
from m3l_tpu_torch.utils.convert import load_jax_params
from test_torch_ssl_dino import count_attention
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH = 3
SHAPE = (BATCH, 2, 32, 32, 3)  # (B, T, H, W, C)


def close(out, ref, tol=TOL, name=""):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), err_msg=name, **tol)


def jax_keeps(j, key, batch=BATCH) -> torch.Tensor:
    """The tube masks JAX's training_loss draws from ``key``."""
    return torch.from_numpy(np.array(jmasks.random_tube_masks(key, batch, j.grid, j.mask_ratio, j.num_masks)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_to_indices_equals_jax(seed):
    rng = np.random.default_rng(seed)
    keep = np.stack([rng.permutation(16) < 5 for _ in range(4)])
    for mask, count in ((keep, 5), (~keep, 11)):
        np.testing.assert_array_equal(tvjepa._mask_to_indices(t(mask), count).numpy(), np.asarray(jvjepa._mask_to_indices(jnp.asarray(mask), count)))


@pytest.mark.parametrize("grid,ratio,n_masks", [((1, 4, 4), 0.75, 1), ((1, 14, 14), 0.75, 2), ((2, 3, 5), 0.5, 3)])
def test_tube_masks_equal_jax_on_the_same_uniforms(grid, ratio, n_masks):
    key = jax.random.PRNGKey(sum(grid))
    tt, h, w = grid
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (n_masks, BATCH, h * w))))
    want = np.asarray(jmasks.random_tube_masks(key, BATCH, grid, ratio, n_masks))
    np.testing.assert_array_equal(tmasks.tube_masks_from_noise(noise, tt, ratio).numpy(), want)


def step(j, p, x, key):
    """JAX's loss and gradients (jitted) and the port's loss, aux and gradients on the same masks."""
    keeps = jax_keeps(j, key)
    p.sample_masks = lambda generator, batch: keeps

    @nnx.jit
    def step_fn(m, batch, key):
        return nnx.value_and_grad(lambda m: m.training_loss(batch, key, 0), has_aux=True, argnums=nnx.DiffState(0, j.trainable_filter))(m)

    (jloss, jaux), jgrads = step_fn(j, {"image": jnp.asarray(x)}, key)
    loss, aux = p.training_loss({"image": t(x)}, None, 0)
    loss.backward()
    return jloss, jaux, jgrads, loss, aux


def test_loss_gradients_and_ema_equal_jax():
    j, p = vjepa_pair(moving_average_decay=(0.9, 1.0))
    for m in (j, p):
        m.setup_schedules(4, 5)
    # move the context encoder off the target so the EMA has work
    nnx.update(j.context_encoder, jax.tree.map(lambda v: v + 0.01 * jnp.sign(v + 0.3), nnx.state(j.context_encoder, nnx.Param)))
    load_jax_params(p, flat_variables(j))
    x = images(SHAPE, seed=5)
    jloss, jaux, jgrads, loss, aux = step(j, p, x, jax.random.PRNGKey(6))
    close(loss, jloss, CONV_TOL)
    for k in ("loss", "loss_jepa", "loss_reg"):
        close(aux[k], jaux[k], CONV_TOL, name=k)
    assert aux["loss"] is loss and aux["loss_reg"].item() > 0  # the variance term is active

    ref = vjepa_twin()
    load_jax_params(ref, {**flat_variables(j), **flat_state(jgrads)})
    want, trainable = dict(ref.named_parameters()), p.trainable_parameters()
    assert len(flat_state(jgrads)) == len(trainable) and not any(n.startswith("target_encoder.") for n in trainable)
    # the predictor's patch embedding is never used: no gradient here, zeros in JAX
    unused = {n for n, q in trainable.items() if q.grad is None}
    assert unused == {"predictor.patch_embed.proj.weight", "predictor.patch_embed.proj.bias"}
    scale = max(q.grad.abs().max().item() for n, q in trainable.items() if n not in unused)
    for n, q in p.named_parameters():
        if n in unused:
            assert not want[n].detach().any(), n
        elif n in trainable:
            np.testing.assert_allclose(q.grad.numpy(), want[n].detach().numpy(), rtol=2e-4, atol=1e-5 * scale, err_msg=n)
        else:
            assert q.grad is None and not q.requires_grad, n

    p.on_train_batch_end(aux, 7)
    j.on_train_batch_end({}, jnp.asarray(7))
    ref = vjepa_twin()
    load_jax_params(ref, flat_variables(j))
    moved = 0
    for (n, a), b in zip(p.state_dict().items(), ref.state_dict().values()):
        close(a, b.numpy(), name=n)
        moved += n.startswith("target_encoder.") and not torch.equal(a, p.state_dict()["context_encoder." + n[len("target_encoder."):]])
    assert moved  # the target moved part of the way toward the context encoder


def test_a_dropped_context_token_exceeds_the_tolerance(monkeypatch):
    """The context encoder sees one of its four kept tokens twice and another not at all: the loss
    leaves CONV_TOL of JAX's, so the parity test above would see such a fault."""
    j, p = vjepa_pair()
    n_context = p.n_context
    real = tvjepa._mask_to_indices

    def dropped(keep, count):
        idx = real(keep, count)
        if count == n_context:
            idx = idx.clone()
            idx[:, -1] = idx[:, 0]
        return idx

    monkeypatch.setattr(tvjepa, "_mask_to_indices", dropped)
    jloss, _, _, loss, _ = step(j, p, images(SHAPE, seed=5), jax.random.PRNGKey(6))
    assert abs(loss.item() - float(jloss)) > CONV_TOL["atol"] + CONV_TOL["rtol"] * abs(float(jloss))


def test_forward_loss_and_embeddings_equal_jax():
    j, p = vjepa_pair(reg_coeff=0.5, loss_exp=2.0)
    x = images(SHAPE, seed=7)
    key = jax.random.PRNGKey(8)
    _, jaux = j.training_loss({"image": jnp.asarray(x)}, key, 0)
    p.sample_masks = lambda generator, batch: jax_keeps(j, key)
    _, aux = p.training_loss({"image": t(x)}, None, 0)
    for k in ("loss", "loss_jepa", "loss_reg"):
        close(aux[k], jaux[k], CONV_TOL, name=k)
    close(p.get_embeddings(t(x)), j.get_embeddings(jnp.asarray(x)), CONV_TOL)


def test_tube_masks_drawn_by_the_module_keep_a_static_count():
    _, p = vjepa_pair(num_masks=2)
    keeps = p.sample_masks(torch.Generator().manual_seed(0), 5)
    assert keeps.shape == (2, 5, 16) and keeps.dtype == torch.bool and (keeps.sum(-1) == p.n_context).all()
    assert (p.n_context, p.n_target) == (4, 12)
    loss, aux = p.training_loss({"image": t(images((5, 2, 32, 32, 3)))}, torch.Generator().manual_seed(1), 0)
    assert torch.isfinite(loss) and set(aux) == {"loss", "loss_jepa", "loss_reg"}


def test_a_still_image_encoder_is_refused():
    with pytest.raises(ValueError, match="video"):
        VJEPAModule(VisionTransformer(**VIT), vit_predictor(64, **{"patch_size": 8, "img_size": (32, 32), "in_chans": 3, "embed_dim": 32, "depth": 1, "num_heads": 2}))


@pytest.mark.parametrize("depth,pdepth", [(2, 2), (3, 1)])
def test_attention_launches_per_step(monkeypatch, depth, pdepth):
    """Per step: forward, the target encoder, the context encoder on the gathered kept tokens and
    the predictor; backward, the context encoder and the predictor; no key mask anywhere. At the
    config's depths (12, predictor 6) that is 30 + 18, which chip_smoke.py phase 11 checks."""
    count_attention(monkeypatch)
    p = VJEPAModule(
        VisionTransformer(**{**VIT, **VIDEO, "depth": depth}),
        vit_predictor(64, patch_size=8, img_size=(32, 32), in_chans=3, embed_dim=32, depth=pdepth, num_heads=2, **VIDEO),
    )
    reset_launches()
    loss, _ = p.training_loss({"image": t(images(SHAPE))}, torch.Generator().manual_seed(0), 0)
    loss.backward()
    assert dict(LAUNCHES) == {fa.KERNEL: 2 * depth + pdepth, fa.BWD_KERNEL: depth + pdepth}
    assert not any(MASKED_LAUNCHES.values())
    reset_launches()
