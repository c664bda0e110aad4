"""The port's I-JEPA (ssl/ijepa.py) and its predictor (models/vit.py VisionTransformerPredictor)
against the JAX package on the CPU.

Tiny widths (ViT depth 2, dim 64, 2 heads x 32, 32x32 images, patch 8, no registers; predictor
depth 2, dim 32, 2 heads x 16, 4 mask tokens). Weights carried from JAX with load_jax_params; the
masks JAX draws from its key are passed in. f32: rtol 1e-5, or 2e-4 where the patch conv is on the
path; gradients relative to the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, PREDICTOR, TOL, VIT, carry, flat_state, flat_variables, ijepa_pair, ijepa_twin, images, t
from m3l_tpu.models.vit import vit_predictor as jvit_predictor
from m3l_tpu_torch.kernels import LAUNCHES, MASKED_LAUNCHES, reset_launches
from m3l_tpu_torch.models.vit import VisionTransformer, vit_predictor
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.ssl import IJEPAModule
from m3l_tpu_torch.ssl.ijepa import cut_context
from test_torch_ssl_dino import count_attention
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def close(out, ref, tol=TOL, name=""):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), err_msg=name, **tol)


def predictor_pair():
    j = jvit_predictor(64, rngs=nnx.Rngs(2), **PREDICTOR)
    return j, carry(j, vit_predictor(64, **PREDICTOR))


def test_predictor_resolves_its_mask_token_bank():
    j, p = predictor_pair()
    assert [n for n, _ in p.named_parameters() if n.startswith("mask_tokens")] == [f"mask_tokens.{i}" for i in range(4)]
    for i in range(4):
        np.testing.assert_array_equal(p.mask_tokens[i].detach().numpy(), np.asarray(j.mask_tokens[i][...]))


@pytest.mark.parametrize("mask_index", [0, 5])
def test_predict_equals_jax(mask_index):
    j, p = predictor_pair()
    z = images((3, 5, 64), seed=1)
    rng = np.random.default_rng(2)
    perm = np.stack([rng.permutation(16) for _ in range(3)])
    ctx, tgt = perm[:, :5], perm[:, 5:9]
    out = p.predict(t(z), t(ctx), t(tgt), mask_index=mask_index)
    ref = j.predict(jnp.asarray(z), jnp.asarray(ctx), jnp.asarray(tgt), mask_index=mask_index)
    assert out.shape == (3, 4, 64)
    close(out, ref)


def test_predict_padded_equals_jax():
    j, p = predictor_pair()
    z = images((3, 16, 64), seed=3)
    keep = np.random.default_rng(4).random((3, 16)) > 0.5
    keep[:, 0] = True
    out = p.predict_padded(t(z), t(keep), mask_index=2)
    ref = j.predict_padded(jnp.asarray(z), jnp.asarray(keep), mask_index=2)
    assert out.shape == (3, 16, 64)
    close(out, ref)
    # a masked context token's value does not reach any prediction
    z2 = z.copy()
    z2[~keep] += 5.0
    close(p.predict_padded(t(z2), t(keep), mask_index=2), out.detach().numpy(), dict(rtol=1e-5, atol=1e-6))


def jax_masks(j, key, batch):
    ctx, tgt = j.sample_masks(key, batch)
    return torch.from_numpy(np.array(ctx)), torch.from_numpy(np.array(tgt))


def test_loss_gradients_and_ema_equal_jax():
    j, p = ijepa_pair(moving_average_decay=(0.9, 1.0))
    for m in (j, p):
        m.setup_schedules(4, 5)
    # move the context encoder off the target so the EMA has work
    nnx.update(j.context_encoder, jax.tree.map(lambda v: v + 0.01 * jnp.sign(v + 0.3), nnx.state(j.context_encoder, nnx.Param)))
    load_jax_params(p, flat_variables(j))
    x, key = images((3, 32, 32, 3), seed=5), jax.random.PRNGKey(6)
    masks = jax_masks(j, key, 3)
    p.sample_masks = lambda generator, batch: masks

    @nnx.jit
    def step_fn(m, batch, key):
        return nnx.value_and_grad(lambda m: m.training_loss(batch, key, 0), has_aux=True, argnums=nnx.DiffState(0, j.trainable_filter))(m)

    (jloss, _), jgrads = step_fn(j, {"image": jnp.asarray(x)}, key)
    loss, aux = p.training_loss({"image": t(x)}, None, 0)
    loss.backward()
    close(loss, jloss, CONV_TOL)
    assert aux["loss"] is loss and aux["ssl_loss"] is loss

    ref = ijepa_twin()
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
    ref = ijepa_twin()
    load_jax_params(ref, flat_variables(j))
    for (n, a), b in zip(p.state_dict().items(), ref.state_dict().values()):
        close(a, b.numpy(), name=n)


def test_forward_loss_and_embeddings_equal_jax():
    j, p = ijepa_pair()
    x = images((2, 32, 32, 3), seed=7)
    ctx, tgt = j.sample_masks(jax.random.PRNGKey(8), 2)
    close(p.forward_loss(t(x), t(ctx), t(tgt)), j.forward_loss(jnp.asarray(x), ctx, tgt), CONV_TOL)
    close(p.get_embeddings(t(x)), j.get_embeddings(jnp.asarray(x)), CONV_TOL)


def test_context_is_cut_by_the_targets_with_the_all_cut_guard():
    ctx = torch.tensor([[True, True, False, True], [True, False, False, False]])
    tgt = torch.tensor([[[False, True, False, False], [True, False, False, False]]])
    assert cut_context(ctx, tgt).tolist() == [[True, False, False, True], [True, True, True, True]]
    _, p = ijepa_pair()
    ctx, tgt = p.sample_masks(torch.Generator().manual_seed(0), 6)
    assert ctx.shape == (6, 16) and tgt.shape == (4, 6, 16) and (ctx.sum(-1) > 0).all()
    cut = ~(ctx & tgt.any(0)).any(-1)
    assert (cut | ctx.all(-1)).all()


@pytest.mark.parametrize("depth,pdepth", [(2, 2), (3, 1)])
def test_attention_launches_per_step(monkeypatch, depth, pdepth):
    """Per step: forward, the context encoder (key-masked), the target encoder and four predictor
    passes (key-masked, N = 2 x 16); backward, the context encoder and the predictor passes. At the
    config's depths (12, predictor 6) that is 48 + 36, which chip_smoke.py phase 10 checks."""
    count_attention(monkeypatch)
    p = IJEPAModule(VisionTransformer(**{**VIT, "depth": depth}), vit_predictor(64, **{**PREDICTOR, "depth": pdepth}))
    reset_launches()
    loss, _ = p.training_loss({"image": t(images((2, 32, 32, 3)))}, torch.Generator().manual_seed(0), 0)
    loss.backward()
    assert dict(LAUNCHES) == {fa.KERNEL: 2 * depth + 4 * pdepth, fa.BWD_KERNEL: depth + 4 * pdepth}
    assert dict(MASKED_LAUNCHES) == {fa.KERNEL: depth + 4 * pdepth, fa.BWD_KERNEL: depth + 4 * pdepth}
    reset_launches()
