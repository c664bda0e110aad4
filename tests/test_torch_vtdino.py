"""The port's multimodal VTT (models/multimodal_vtt.py), VTDINO (ssl/vtdino.py) and the multimodal
transformer with its MAE decoder (models/multimodal_transformer.py) against the JAX package on the
CPU.

Tiny widths: the VTT at dim 32, depth 1 (2 for the launch counts), 2 heads x 64, mlp 64, on 28 x 28
inputs at patch 14 (4 patches a modality, 12 in all, one register token); the DINO heads 64 wide
(hidden 32, bottleneck 16), two local masks, the reconstruction probe at its fixed 256 wide. The
transformer at dim 32, 2 heads. Weights and the center carried from JAX with load_jax_params; the
masks JAX draws from its key are passed in through ``sample_masks``. No convolution is on these
paths: 1e-5 relative, gradients plus 1e-5 of the largest one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import TOL, carry, flat_state, flat_variables, t
from m3l_tpu.models import MultimodalMAEDecoder as JDecoder
from m3l_tpu.models import MultimodalTransformer as JTransformer
from m3l_tpu.models import MultimodalVTT as JVTT
from m3l_tpu.ssl import VTDINOModule as JVTDINO
from m3l_tpu_torch.kernels import LAUNCHES, MASKED_LAUNCHES, reset_launches
from m3l_tpu_torch.models import MultimodalMAEDecoder, MultimodalTransformer, MultimodalVTT
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.ssl import VTDINOModule
from m3l_tpu_torch.train import Trainer
from m3l_tpu_torch.utils.convert import load_jax_params
from test_torch_ssl_dino import count_attention, jax_masks, randomize_centers
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MM = dict(image_size=(28, 28), tactile_size=(28, 28), image_patch_size=14, tactile_patch_size=14, dim=32, depth=1, heads=2, mlp_dim=64, num_register_tokens=1)
HEADS = dict(dino_out_dim=64, dino_hidden_dim=32, dino_bottleneck_dim=16, num_local_masks=2)


def mm_batch(b=2, size=28, fs=1, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.random((b, size, size, 3 * fs), dtype=np.float32) for k in ("image", "tactile1", "tactile2")}


def vtt_pair(**kw):
    cfg = {**MM, **kw}
    j = JVTT(rngs=nnx.Rngs(0), **cfg)
    return j, carry(j, MultimodalVTT(**cfg))


def close(out, ref, tol=TOL, name=""):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), err_msg=name, **tol)


def test_multimodal_vtt_contract():
    _, p = vtt_pair()
    out = p.forward_features({k: t(v) for k, v in mm_batch().items()})
    assert out["x_norm_regtokens"].shape == (2, 1, 32)
    assert out["x_norm_patchtokens"].shape == (2, 12, 32)  # 3 modalities x 4 patches


def test_multimodal_vtt_mask_applies_to_all_modalities():
    """One key mask over every modality, the register token as CLS: corrupting the masked
    positions of any modality leaves the registers as they were."""
    _, p = vtt_pair()
    x = mm_batch()
    km = torch.ones(2, 4, dtype=torch.bool)
    km[:, 2:] = False
    with torch.no_grad():
        out1 = p.forward_features({k: t(v) for k, v in x.items()}, key_mask=km)["x_norm_regtokens"]
        x2 = dict(x)
        x2["tactile2"] = np.array(x["tactile2"])
        x2["tactile2"][:, 14:] = 9.0  # the bottom half: patches 2 and 3
        out2 = p.forward_features({k: t(v) for k, v in x2.items()}, key_mask=km)["x_norm_regtokens"]
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


@pytest.mark.parametrize("fs", [1, 2])
def test_multimodal_vtt_equals_jax(fs):
    """forward_features without and with a key mask, and the batched multimask pass."""
    j, p = vtt_pair(frame_stack=fs)
    x = mm_batch(fs=fs, seed=1)
    jx, tx = {k: jnp.asarray(v) for k, v in x.items()}, {k: t(v) for k, v in x.items()}
    km = np.random.default_rng(2).random((2, 4)) > 0.4
    km[:, 0] = True
    masks = np.random.default_rng(3).random((3, 2, 4)) > 0.5
    masks[..., 1] = True
    with torch.no_grad():
        for key in ("x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
            close(p.forward_features(tx)[key], j.forward_features(jx)[key], name=key)
            close(p.forward_features(tx, key_mask=t(km))[key], j.forward_features(jx, key_mask=jnp.asarray(km))[key], name=key)
            close(p.forward_features_multimask(tx, t(masks))[key], j.forward_features_multimask(jx, jnp.asarray(masks))[key], name=key)


def test_unequal_patch_counts_raise():
    with pytest.raises(ValueError, match="same number of patches"):
        MultimodalVTT(**{**MM, "tactile_patch_size": 7})


def vtdino_pair(probe: bool, **kw):
    cfg = {**HEADS, "with_reconstruction_probe": probe, **kw}
    j = JVTDINO(JVTT(rngs=nnx.Rngs(0), **MM), rngs=nnx.Rngs(1), **cfg)
    randomize_centers(j)
    return j, carry(j, VTDINOModule(MultimodalVTT(**MM), **cfg))


@pytest.mark.parametrize("probe", [True, False], ids=["probe", "no_probe"])
def test_vtdino_step_equals_jax(probe):
    """One VTDINO step under JAX's masks: the loss and its parts, the teacher logits and every
    trainable gradient; the teachers take none."""
    j, p = vtdino_pair(probe)
    x, key = mm_batch(3, seed=4), jax.random.PRNGKey(5)
    masks = jax_masks(j, key, 3)
    p.sample_masks = lambda generator, batch: masks

    @nnx.jit
    def step_fn(m, batch, key):
        return nnx.value_and_grad(lambda m: m.training_loss(batch, key, 0), has_aux=True, argnums=nnx.DiffState(0, m.trainable_filter))(m)

    (jloss, jaux), jgrads = step_fn(j, {k: jnp.asarray(v) for k, v in x.items()}, key)
    loss, aux = p.training_loss({k: t(v) for k, v in x.items()}, None, 0)
    loss.backward()
    close(loss, jloss)
    for k in ("ssl_loss", "teacher_logits", "teacher_temp") + (("reconstruction_loss",) if probe else ()):
        close(aux[k], jaux[k], name=k)
    assert ("reconstruction_loss" in aux) == probe
    jgrads = flat_state(jgrads)
    ref = vtdino_pair(probe)[1]
    load_jax_params(ref, {**flat_variables(j), **jgrads})
    want = dict(ref.named_parameters())
    trainable = p.trainable_parameters()
    assert len(jgrads) == len(trainable)
    scale = max(q.grad.abs().max().item() for q in trainable.values())
    for n, q in p.named_parameters():
        if n in trainable:
            np.testing.assert_allclose(q.grad.numpy(), want[n].detach().numpy(), rtol=1e-5, atol=1e-5 * scale, err_msg=n)
        else:
            assert n.startswith("teacher_") and q.grad is None and not q.requires_grad, n


def test_vtdino_on_train_batch_end_equals_jax():
    """The center's EMA and the teachers' EMA at a momentum inside the ramp."""
    j, p = vtdino_pair(False, moving_average_decay=(0.9, 1.0))
    for m in (j, p):
        m.setup_schedules(4, 5)
    nnx.update(j, jax.tree.map(lambda v: v + 0.01 * jnp.sign(v + 0.3), nnx.state(j, j.trainable_filter)))
    load_jax_params(p, flat_variables(j))
    x, key = mm_batch(3, seed=6), jax.random.PRNGKey(6)
    masks = jax_masks(j, key, 3)
    p.sample_masks = lambda generator, batch: masks
    _, aux = p.training_loss({k: t(v) for k, v in x.items()}, None, 7)
    _, jaux = j.training_loss({k: jnp.asarray(v) for k, v in x.items()}, key, jnp.asarray(7))
    p.on_train_batch_end(aux, 7)
    j.on_train_batch_end(jaux, jnp.asarray(7))
    ref = vtdino_pair(False, moving_average_decay=(0.9, 1.0))[1]
    load_jax_params(ref, flat_variables(j))
    want = ref.state_dict()
    for n, v in p.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[n].numpy(), err_msg=n, rtol=1e-5, atol=1e-6)
    assert not torch.equal(p.teacher_head.last_v, p.student_head.last_v)


def test_vtdino_trains():
    """The Trainer fits it on the CPU; the center moves, the teachers stay out of the optimizer."""
    torch.manual_seed(0)
    mod = VTDINOModule(MultimodalVTT(**MM), **HEADS, with_reconstruction_probe=True)
    assert not any(n.startswith("teacher_") for n in mod.trainable_parameters())
    batches = [{k: t(v) for k, v in mm_batch(seed=i).items()} for i in range(2)]
    hist = Trainer(max_epochs=1, verbose=0, device="cpu").fit(mod, batches)
    assert np.isfinite(hist[-1]["train_loss"])
    assert mod.center.abs().max().item() > 0


def test_vtdino_requires_a_register_token():
    with pytest.raises(ValueError, match="register token"):
        VTDINOModule(MultimodalVTT(**{**MM, "num_register_tokens": 0}), **HEADS)


@pytest.mark.parametrize("probe,depth", [(True, 2), (False, 2), (True, 3)])
def test_vtdino_attention_launches_per_step(monkeypatch, probe, depth):
    """Forward: the student's global and local passes and the teacher's global pass (key-masked),
    with the probe the teacher's full pass and the probe decoder (2); backward: the student's two
    passes (key-masked) and the probe decoder. At VTDINO's default depth 4 with the probe: 18 + 10
    (12 + 8 key-masked)."""
    count_attention(monkeypatch)
    torch.manual_seed(0)
    p = VTDINOModule(MultimodalVTT(**{**MM, "depth": depth}), **HEADS, with_reconstruction_probe=probe)
    reset_launches()
    loss, _ = p.training_loss({k: t(v) for k, v in mm_batch().items()}, torch.Generator().manual_seed(0), 0)
    loss.backward()
    extra = 2 if probe else 0
    assert dict(LAUNCHES) == {fa.KERNEL: (3 + probe) * depth + extra, fa.BWD_KERNEL: 2 * depth + extra}
    assert dict(MASKED_LAUNCHES) == {fa.KERNEL: 3 * depth, fa.BWD_KERNEL: 2 * depth}
    reset_launches()


# ---------------------------------------------------------------------- #
# the multimodal transformer and its MAE decoder
# ---------------------------------------------------------------------- #
def grads_equal(p, j, jgrads, twin):
    load_jax_params(twin, {**flat_variables(j), **flat_state(jgrads)})
    want = dict(twin.named_parameters())
    assert len(flat_state(jgrads)) == len(list(p.parameters()))
    scale = max(q.grad.abs().max().item() for q in p.parameters() if q.grad is not None)
    for n, q in p.named_parameters():
        got = q.grad if q.grad is not None else torch.zeros_like(q)
        np.testing.assert_allclose(got.numpy(), want[n].detach().numpy(), rtol=1e-5, atol=1e-5 * scale, err_msg=n)


TRANSFORMER_CASES = {
    "shared_sinusoidal": (([8, 12], [10, 6]), dict(num_register_tokens=1, pos_embed_fn="sinusoidal")),
    "factored_learned": (([8, 8], [4, 4]), dict(num_register_tokens=1, shared_attn=False)),
    "factored_three_registers": (([8, 6, 5], [3, 4, 2]), dict(num_register_tokens=3, shared_attn=False, init_values=0.5)),
    "shared_no_registers_swiglu": (([8], [10]), dict(ffn_layer="swiglu")),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMER_CASES))
def test_multimodal_transformer_equals_jax(name):
    """forward_features and the gradients of every parameter, shared and factored attention."""
    (dims, lens), kw = TRANSFORMER_CASES[name]
    cfg = dict(depth=2, num_heads=2, **kw)
    j = JTransformer(dims, lens, 32, rngs=nnx.Rngs(0), **cfg)
    p = carry(j, MultimodalTransformer(dims, lens, 32, **cfg))
    rng = np.random.default_rng(7)
    xs = [rng.normal(size=(2, n, d)).astype(np.float32) for d, n in zip(dims, lens)]
    cot = rng.normal(size=(2, sum(lens), 32)).astype(np.float32)
    out = p.forward_features([t(x) for x in xs])

    @nnx.jit
    def jax_step(m, xs):
        def loss(m):
            o = m.forward_features(xs)
            return jnp.sum(o["x_norm_patchtokens"] * cot), o

        return nnx.grad(loss, has_aux=True)(m)

    jgrads, jout = jax_step(j, [jnp.asarray(x) for x in xs])
    for key in ("x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
        close(out[key], jout[key], name=key)
    (out["x_norm_patchtokens"] * t(cot)).sum().backward()
    grads_equal(p, j, jgrads, MultimodalTransformer(dims, lens, 32, **cfg))


def test_multimodal_transformer_mask_gather_equals_jax():
    j = JTransformer([8, 4], [10, 6], 32, depth=1, num_heads=2, pos_embed_fn="sinusoidal", rngs=nnx.Rngs(0))
    p = carry(j, MultimodalTransformer([8, 4], [10, 6], 32, depth=1, num_heads=2, pos_embed_fn="sinusoidal"))
    rng = np.random.default_rng(8)
    xs = [rng.normal(size=(2, 10, 8)).astype(np.float32), rng.normal(size=(2, 6, 4)).astype(np.float32)]
    idx = np.stack([rng.permutation(10)[:4] for _ in range(2)]).astype(np.int64)
    with torch.no_grad():
        out = p([t(x) for x in xs], mask_indices=[t(idx), None])
    want = j([jnp.asarray(x) for x in xs], mask_indices=[jnp.asarray(idx), None])
    assert out.shape == (2, 10, 32)
    close(out, want)


def test_multimodal_mae_decoder_equals_jax():
    """Visible latents and per-modality inverse permutations -> per-modality predictions; values
    and gradients (the mask tokens included)."""
    cfg = dict(depth=1, num_heads=2, pos_embed_fn="sinusoidal", output_dims=[5, 7])
    j = JDecoder([8, 6], [6, 5], 32, rngs=nnx.Rngs(0), **cfg)
    p = carry(j, MultimodalMAEDecoder([8, 6], [6, 5], 32, **cfg))
    rng = np.random.default_rng(9)
    xs = [rng.normal(size=(2, 2, 8)).astype(np.float32), rng.normal(size=(2, 3, 6)).astype(np.float32)]
    ids = [np.stack([rng.permutation(n) for _ in range(2)]).astype(np.int64) for n in (6, 5)]
    outs = p([t(x) for x in xs], [t(i) for i in ids])

    @nnx.jit
    def jax_step(m, xs, ids):
        def loss(m):
            o = m(xs, ids)
            return sum(jnp.sum(v * v) for v in o), o

        return nnx.grad(loss, has_aux=True)(m)

    jgrads, jouts = jax_step(j, [jnp.asarray(x) for x in xs], [jnp.asarray(i) for i in ids])
    assert [tuple(o.shape) for o in outs] == [(2, 6, 5), (2, 5, 7)]
    for o, jo in zip(outs, jouts):
        close(o, jo)
    sum((o * o).sum() for o in outs).backward()
    grads_equal(p, j, jgrads, MultimodalMAEDecoder([8, 6], [6, 5], 32, **cfg))


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "factored"])
def test_multimodal_transformer_attention_launches(monkeypatch, shared):
    """One packed forward and backward per block: depth a pass shared, depth x modalities factored."""
    count_attention(monkeypatch)
    p = MultimodalTransformer([8, 8, 8], [4, 4, 4], 32, depth=2, num_heads=2, shared_attn=shared)
    reset_launches()
    p([torch.ones(2, 4, 8)] * 3).sum().backward()
    n = 2 if shared else 6
    assert dict(LAUNCHES) == {fa.KERNEL: n, fa.BWD_KERNEL: n}
    reset_launches()
