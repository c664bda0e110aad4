"""The port's SSL pieces (ssl/decoders.py, ssl/mae.py, ssl/schedulers.py, ssl/module.py) against
the JAX package on the CPU.

Tiny widths (ViT depth 2, dim 64, 2 heads x 32, 32x32 images, patch 8, 16 patches; decoder depth
1); weights carried from JAX with load_jax_params and the JAX masking noise injected through
MAEModule.sample_noise. f32: rtol 1e-5, or 2e-4 where the patch conv is on the path. The
optimizer is held to optax's adamw under inject_hyperparams (and clip_by_global_norm and
MultiSteps, as the JAX Trainer chains them) over one and two updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, MAE, TOL, VIT, carry, flat_state, images, mae_pair, t
from m3l_tpu.ssl import decoders as jdec
from m3l_tpu.ssl import schedulers as jsched
from m3l_tpu_torch.kernels import LAUNCHES, reset_launches
from m3l_tpu_torch.models.vit import VisionTransformer
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.ssl import MAEModule, decoders as tdec, schedulers as tsched, wd_mask
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DEC = dict(input_embed_dim=64, img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=32, depth=2, num_heads=2)


def close(out, ref, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)


def masking(seed, b=3, n=16, keep=4):
    shuffle = np.stack([np.random.default_rng(seed + i).permutation(n) for i in range(b)])
    return shuffle[:, :keep], shuffle[:, keep:], np.argsort(shuffle, axis=1)


def jax_noise(key, b, n=16):
    return np.array(jax.random.uniform(key, (b, n)))


def inject(module: MAEModule, noises):
    """Make ``module`` draw its masking noise from ``noises`` (numpy arrays), in order."""
    queue = list(noises)
    module.sample_noise = lambda batch, generator: t(queue.pop(0))


@pytest.mark.parametrize("name", ["DecoderViT", "MaskDecoderViT", "MaskedQueryDecoderViT"])
def test_decoders(name):
    j = getattr(jdec, name)(rngs=nnx.Rngs(0), **DEC)
    p = carry(j, getattr(tdec, name)(**DEC))
    keep, masked, restore = masking(0)
    z = images((3, 4, 64), seed=1)
    if name == "DecoderViT":
        out, ref = p(t(images((3, 16, 64), seed=2))), j(jnp.asarray(images((3, 16, 64), seed=2)))
    elif name == "MaskDecoderViT":
        out, ref = p(t(z), t(restore)), j(jnp.asarray(z), jnp.asarray(restore))
    else:
        out, ref = p(t(z), t(keep), t(masked)), j(jnp.asarray(z), jnp.asarray(keep), jnp.asarray(masked))
        vis = np.zeros((3, 16), bool)
        np.put_along_axis(vis, keep, True, axis=1)
        assert (out.detach().numpy()[vis] == 0).all() and (out.detach().numpy()[~vis] != 0).any(-1).all()
    assert out.shape == (3, 16, 8 * 8 * 3)
    close(out, ref)


def test_random_masking_equals_jax():
    j, p = mae_pair()
    key = jax.random.PRNGKey(3)
    for got, ref in zip(p.random_masking(t(jax_noise(key, 5))), j.random_masking(key, 5)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    noise = jax_noise(key, 5)
    noise[0, :6] = noise[0, 6]  # ties: both sides sort stably
    ids_keep, mask, ids_restore = p.random_masking(t(noise))
    shuffle = np.asarray(jnp.argsort(jnp.asarray(noise), axis=1))
    np.testing.assert_array_equal(ids_keep.numpy(), shuffle[:, :4])
    np.testing.assert_array_equal(ids_restore.numpy(), np.argsort(shuffle, axis=1))
    assert mask.dtype == torch.float32 and (mask.sum(1) == 12).all()


@pytest.mark.parametrize("masked_only,norm_pix", [(True, True), (False, True), (False, False)])
def test_mae_forward_and_loss(masked_only, norm_pix):
    j, p = mae_pair(decode_masked_only=masked_only, norm_pix_loss=norm_pix)
    x = images((3, 32, 32, 3), seed=4)
    key = jax.random.PRNGKey(5)
    inject(p, [jax_noise(key, 3)] * 2)
    pred, mask = p(t(x))
    jpred, jmask = j(jnp.asarray(x), key)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    close(pred, jpred, CONV_TOL)
    loss, aux = p.training_loss({"image": t(x)}, None, 0)
    jloss, _ = j.training_loss({"image": jnp.asarray(x)}, key, 0)
    close(loss, jloss, CONV_TOL)
    assert aux["loss"] is loss


def test_mae_loss_on_uint8_images_and_registers():
    j, p = mae_pair(vit_kw=dict(num_register_tokens=2, in_chans=6), decode_masked_only=True)
    x = np.random.default_rng(6).integers(0, 256, (2, 32, 32, 6), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    inject(p, [jax_noise(key, 2)])
    loss, _ = p.training_loss({"image": t(x)}, None, 0)
    close(loss, j.training_loss({"image": jnp.asarray(x)}, key, 0)[0], CONV_TOL)


@pytest.mark.parametrize("masked_only", [True, False])
def test_reconstruction_images(masked_only):
    j, p = mae_pair(vit_kw=dict(in_chans=6), decode_masked_only=masked_only)
    x = images((4, 32, 32, 6), seed=8)
    key = jax.random.PRNGKey(9)
    inject(p, [jax_noise(key, 3)])
    out = p.reconstruction_images({"image": t(x)}, None, max_images=3)
    ref = j.reconstruction_images({"image": jnp.asarray(x)}, key, max_images=3)
    assert sorted(out) == sorted(ref) == ["masked", "original", "reconstruction"]
    for k in out:
        assert out[k].shape == (32, 3 * 32, 3)
        close(out[k], ref[k], CONV_TOL)


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.warmup_cosine_schedule(1e-3, 1e-5, 1e-6, 10, 50),
        lambda m: m.warmup_cosine_schedule(1e-4, 0.0, 0.0, 0, 30),
        lambda m: m.cosine_wd_schedule(0.04, 0.4, 40),
        lambda m: m.cosine_wd_schedule(0.4, 0.04, 40),
        lambda m: m.linear_schedule(0.99, 1.0, 25),
        lambda m: m.teacher_temp_schedule((0.04, 0.07), 12),
        lambda m: m.teacher_temp_schedule(0.05, 12),
    ],
)
def test_schedules_equal_jax(make):
    port, ref = make(tsched), make(jsched)
    steps = range(0, 60, 3)
    np.testing.assert_allclose([port(s) for s in steps], [float(ref(s)) for s in steps], rtol=1e-6, atol=1e-9)


def jax_optimizer(j, spe, epochs, clip=None, every_k=1):
    """The JAX Trainer's chain (m3l_tpu/train/trainer.py: clip, then MultiSteps) on ``j``."""
    tx = j.configure_optimizer(spe, epochs)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if every_k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=every_k)
    return nnx.Optimizer(j, tx, wrt=nnx.Param)


@nnx.jit
def jax_step(module, optimizer, batch, key):
    (loss, _), grads = nnx.value_and_grad(lambda m: m.training_loss(batch, key, 0), has_aux=True)(module)
    optimizer.update(module, grads)
    return loss, grads


def twin(p: MAEModule) -> MAEModule:
    """A port MAEModule of ``p``'s tiny configuration (its weights are overwritten)."""
    return MAEModule(VisionTransformer(**VIT), **{**MAE, "decode_masked_only": p.decode_masked_only})


def assert_params_equal(p, j):
    got = dict(p.named_parameters())
    for name, r in carry(j, twin(p)).named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(), r.detach().numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize(
    "warmup,clip,every_k,final_wd",
    [(0, None, 1, None), (1, None, 1, 0.4), (0, 0.05, 1, None), (0, 0.05, 2, 0.4)],
    ids=["plain", "warmup_zero_lr_first_step_cosine_wd", "clip", "clip_multisteps2"],
)
def test_adamw_steps_equal_optax(warmup, clip, every_k, final_wd):
    """Two applied AdamW updates of the port's optimizer against optax on the same gradients:
    the wd split (mask_token (1, 1, D) decayed, LayerScale gamma and biases not), lr read at the
    pre-increment count (0 at step 0 under warm-up), the global-norm clip and MultiSteps k=2
    averaging. lr 1e-2, so an update is large against the tolerance.

    Both optimizers take JAX's gradients: Adam's update lr * g / (|g| + eps) turns f32 noise on a
    gradient that is zero analytically (the key part of each qkv bias: softmax ignores a shift
    shared by all keys) into steps of up to lr of either sign. The port's own gradients are held
    to JAX's at the first batch, relative to the largest gradient."""
    j, p = mae_pair(decode_masked_only=True, base_lr=1e-2, warmup_epochs=warmup)
    for m in (j, p):
        m.final_weight_decay = final_wd
    spe, epochs = 2, 5
    jopt = jax_optimizer(j, spe, epochs, clip, every_k)
    popt = p.configure_optimizer(spe, epochs)
    popt.clip_norms, popt.every_k = (() if clip is None else (clip,)), every_k
    decayed = {n for (n, _), m in zip(p.named_parameters(), wd_mask(p.parameters())) if m}
    assert "decoder.mask_token" in decayed and "encoder.blocks.0.ls1.gamma" not in decayed and "encoder.norm.bias" not in decayed
    before = {n: q.detach().clone() for n, q in p.named_parameters()}
    keys = jax.random.split(jax.random.PRNGKey(11), 2 * every_k)
    inject(p, [jax_noise(k, 4) for k in keys])
    grads = twin(p)
    for i, key in enumerate(keys):
        x = images((4, 32, 32, 3), seed=20 + i)
        jloss, jgrads = jax_step(j, jopt, {"image": jnp.asarray(x)}, key)
        loss, _ = p.training_loss({"image": t(x)}, None, 0)
        loss.backward()
        close(loss, jloss, CONV_TOL)
        load_jax_params(grads, flat_state(jgrads))
        if i == 0:
            scale = max(g.abs().max().item() for g in grads.parameters())
            for (name, q), g in zip(p.named_parameters(), grads.parameters()):
                np.testing.assert_allclose(q.grad.numpy(), g.detach().numpy(), rtol=2e-4, atol=1e-5 * scale, err_msg=name)
        for q, g in zip(p.parameters(), grads.parameters()):
            q.grad = g.detach().clone()
        applied = popt.step()
        popt.zero_grad()
        assert applied == ((i + 1) % every_k == 0) and popt.count == (i + 1) // every_k
        assert_params_equal(p, j)
        if i == every_k - 1:
            moved = max((q.detach() - before[n]).abs().max().item() for n, q in p.named_parameters())
            assert (moved == 0.0) == (warmup > 0)  # lr 0 at step 0 under warm-up; else ~lr


def count_attention(monkeypatch):
    """Count the packed attention's forward and backward calls (CPU: its plain versions) in
    LAUNCHES, as the CUDA wrappers count their launches."""
    fwd, bwd = fa._fwd_plain, fa._bwd_plain

    def forward(*args):
        LAUNCHES[fa.KERNEL] += 1
        return fwd(*args)

    def backward(*args):
        LAUNCHES[fa.BWD_KERNEL] += 1
        return bwd(*args)

    monkeypatch.setattr(fa, "_fwd_plain", forward)
    monkeypatch.setattr(fa, "_bwd_plain", backward)


@pytest.mark.parametrize("masked_only,layers", [(True, 2), (False, 3)])
def test_attention_launches_per_step(monkeypatch, masked_only, layers):
    """Every encoder layer (and, He-style, every decoder layer) runs the packed attention once
    forward and once backward per step; the masked-query decoder's cross-attention runs none."""
    count_attention(monkeypatch)
    _, p = mae_pair(decode_masked_only=masked_only)
    reset_launches()
    loss, _ = p.training_loss({"image": t(images((2, 32, 32, 3)))}, torch.Generator().manual_seed(0), 0)
    loss.backward()
    assert dict(LAUNCHES) == {fa.KERNEL: layers, fa.BWD_KERNEL: layers}
    reset_launches()
