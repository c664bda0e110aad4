"""The port's DINO and DINOv2 modules (ssl/dino.py, ssl/dinov2.py) against the JAX package on the
CPU.

Tiny widths (ViT depth 2, dim 64, 2 heads x 32, 32x32 images, patch 8, one register token; heads
32 wide, the separate iBOT head at its default widths; the reconstruction probe at its fixed
256 wide, 8 heads x 32). Weights and centers carried from JAX with load_jax_params; the masks JAX
draws from its key are passed in through ``sample_masks``. f32 with the patch conv on the path:
rtol 2e-4 (CONV_TOL); gradients relative to the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, TOL, dino_pair, dino_twin, flat_state, flat_variables, images, t
from m3l_tpu_torch.kernels import LAUNCHES, MASKED_LAUNCHES, reset_launches
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

V2_CASES = [dict(centering="centering"), dict(centering="sinkhorn_knopp"), dict(centering="centering", ibot_separate_head=True, ibot_out_dim=24)]
V2_IDS = ["centering", "sinkhorn_knopp", "separate_ibot_head"]


def close(out, ref, tol=CONV_TOL, name=""):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), err_msg=name, **tol)


def randomize_centers(j):
    """Nonzero centers on the JAX module, so centering is exercised."""
    rng = np.random.default_rng(3)
    for name in ("center", "ibot_center"):
        if hasattr(j, name):
            var = getattr(j, name)
            var[...] = jnp.asarray(rng.normal(size=var[...].shape).astype(np.float32))


def pair(name, **kw):
    j, p = dino_pair(name, **kw)
    randomize_centers(j)
    load_jax_params(p, flat_variables(j))
    return j, p


def jax_masks(j, key, batch):
    """The masks JAX's training_loss draws from ``key`` (its first split)."""
    g, l = j.sample_masks(jax.random.split(key)[0], batch)
    return torch.from_numpy(np.array(g)), torch.from_numpy(np.array(l))


def jax_loss_and_grads(j, x, key, step):
    @nnx.jit
    def step_fn(m, batch, key, step):
        return nnx.value_and_grad(lambda m: m.training_loss(batch, key, step), has_aux=True, argnums=nnx.DiffState(0, j.trainable_filter))(m)

    (loss, aux), grads = step_fn(j, {"image": jnp.asarray(x)}, key, jnp.asarray(step))
    return loss, aux, flat_state(grads)


def assert_grads_equal(p, j, jgrads, name, kw):
    """Every trainable parameter's gradient equals JAX's (rtol 2e-4, atol 1e-5 of the largest);
    the teachers take none."""
    ref = dino_twin(name, **kw)
    load_jax_params(ref, {**flat_variables(j), **jgrads})
    want = dict(ref.named_parameters())
    trainable = p.trainable_parameters()
    assert len(jgrads) == len(trainable)
    scale = max(q.grad.abs().max().item() for q in trainable.values())
    for n, q in p.named_parameters():
        if n in trainable:
            np.testing.assert_allclose(q.grad.numpy(), want[n].detach().numpy(), rtol=2e-4, atol=1e-5 * scale, err_msg=n)
        else:
            assert n.startswith("teacher_") and q.grad is None and not q.requires_grad, n


def assert_temp_equal(aux, jaux):
    """The ``teacher_temp`` aux is JAX's f32 scalar, bit for bit."""
    assert aux["teacher_temp"].dtype == torch.float32 and aux["teacher_temp"].shape == ()
    np.testing.assert_array_equal(aux["teacher_temp"].numpy(), np.asarray(jaux["teacher_temp"]))


@pytest.mark.parametrize("probe,regs", [(True, 1), (False, 2)], ids=["probe", "no_probe_two_registers"])
def test_dino_training_loss_and_gradients(probe, regs):
    kw = dict(with_reconstruction_probe=probe, vit_kw=dict(num_register_tokens=regs))
    j, p = pair("DINOModule", **kw)
    x, key = images((3, 32, 32, 3), seed=1), jax.random.PRNGKey(2)
    masks = jax_masks(j, key, 3)
    p.sample_masks = lambda generator, batch: masks
    jloss, jaux, jgrads = jax_loss_and_grads(j, x, key, 0)
    loss, aux = p.training_loss({"image": t(x)}, None, 0)
    loss.backward()
    close(loss, jloss)
    close(aux["ssl_loss"], jaux["ssl_loss"])
    close(aux["teacher_logits"], jaux["teacher_logits"])
    assert float(aux["teacher_temp"]) == pytest.approx(0.04) and aux["loss"] is loss
    assert_temp_equal(aux, jaux)
    if probe:
        close(aux["reconstruction_loss"], jaux["reconstruction_loss"])
    assert_grads_equal(p, j, jgrads, "DINOModule", kw)


def test_dino_forward_loss_with_passed_temperature():
    j, p = pair("DINOModule", with_reconstruction_probe=False)
    x = images((2, 32, 32, 3), seed=4)
    g, l = j.sample_masks(jax.random.PRNGKey(5), 2)
    loss, logits = p.forward_loss(t(x), t(g), t(l), 0.0613)
    jloss, jlogits = j.forward_loss(jnp.asarray(x), g, l, jnp.asarray(0.0613, jnp.float32))
    close(loss, jloss)
    close(logits, jlogits)


def assert_module_equals(p, j, name, kw, tol=TOL):
    ref = dino_twin(name, **kw)
    load_jax_params(ref, flat_variables(j))
    want = ref.state_dict()
    for n, v in p.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[n].numpy(), err_msg=n, **tol)


def batch_end(name, kw, seed):
    """One forward on both sides, the schedules of 4 steps an epoch for 5 epochs, and
    on_train_batch_end at step 7 (a momentum inside the ramp); the student is perturbed first so
    the EMA moves the teacher."""
    j, p = pair(name, **kw)
    for m in (j, p):
        m.setup_schedules(4, 5)
    leaves = nnx.state(j, j.trainable_filter)
    nnx.update(j, jax.tree.map(lambda v: v + 0.01 * jnp.sign(v + 0.3), leaves))
    load_jax_params(p, flat_variables(j))
    x, key = images((3, 32, 32, 3), seed=seed), jax.random.PRNGKey(seed)
    masks = jax_masks(j, key, 3)
    p.sample_masks = lambda generator, batch: masks
    _, aux = p.training_loss({"image": t(x)}, None, 7)
    _, jaux = j.training_loss({"image": jnp.asarray(x)}, key, jnp.asarray(7))
    p.on_train_batch_end(aux, 7)
    j.on_train_batch_end(jaux, jnp.asarray(7))
    assert_temp_equal(aux, jaux)
    assert_module_equals(p, j, name, kw, CONV_TOL)
    return j, p


def test_dino_on_train_batch_end():
    j, p = batch_end("DINOModule", dict(moving_average_decay=(0.9, 1.0), with_reconstruction_probe=False), 6)
    assert float(p._momentum_fn(7)) == pytest.approx(0.9 + 0.1 * 7 / 20)
    assert not torch.equal(p.teacher_head.last_v, p.student_head.last_v)


@pytest.mark.parametrize("kw", V2_CASES, ids=V2_IDS)
def test_dinov2_training_loss_and_gradients(kw):
    j, p = pair("DINOv2Module", **kw)
    x, key = images((3, 32, 32, 3), seed=7), jax.random.PRNGKey(8)
    masks = jax_masks(j, key, 3)
    p.sample_masks = lambda generator, batch: masks
    jloss, jaux, jgrads = jax_loss_and_grads(j, x, key, 0)
    loss, aux = p.training_loss({"image": t(x)}, None, 0)
    loss.backward()
    close(loss, jloss)
    for k in ("dino_loss", "ibot_loss", "koleo_loss", "reconstruction_loss", "teacher_logits", "teacher_patch_logits"):
        close(aux[k], jaux[k], name=k)
    np.testing.assert_array_equal(aux["patch_keep"].numpy(), np.asarray(jaux["patch_keep"]))
    assert_temp_equal(aux, jaux)
    assert_grads_equal(p, j, jgrads, "DINOv2Module", kw)


@pytest.mark.parametrize("kw", [V2_CASES[0], V2_CASES[2]], ids=[V2_IDS[0], V2_IDS[2]])
def test_dinov2_on_train_batch_end(kw):
    j, p = batch_end("DINOv2Module", dict(kw, moving_average_decay=(0.9, 1.0)), 9)
    assert p.ibot_center.abs().sum() > 0


def test_sample_masks_shapes_and_constraint():
    _, p = dino_pair("DINOv2Module")
    gen = torch.Generator().manual_seed(0)
    g, l = p.sample_masks(gen, 5)
    assert g.shape == (2, 5, 16) and l.shape == (4, 5, 16) and g.dtype == l.dtype == torch.bool
    forbidden = l.any(0)
    # each global mask avoids every local patch, or falls back to its raw block when fewer than
    # min_keep + 1 patches would remain
    for m in g.reshape(-1, 5, 16):
        avoided = ~(m & forbidden).any(-1)
        assert (m[avoided].sum(-1) > p.min_keep).all()


def test_teachers_are_frozen_and_left_out_of_the_optimizer():
    _, p = dino_pair("DINOv2Module", ibot_separate_head=True, ibot_out_dim=24)
    trainable = p.trainable_parameters()
    teachers = [n for n, _ in p.named_parameters() if n.startswith("teacher_")]
    assert teachers and not set(teachers) & set(trainable)
    assert {n.split(".")[0] for n in teachers} == {"teacher_backbone", "teacher_head", "teacher_ibot_head"}
    assert all(not q.requires_grad for n, q in p.named_parameters() if n in teachers)
    opt = p.configure_optimizer(2, 2)
    assert sum(len(gr["params"]) for gr in opt.adamw.param_groups) == len(trainable)
    state = p.state_dict()
    assert "center" in state and "ibot_center" in state and any(k.startswith("teacher_backbone.") for k in state)


def test_dino_requires_a_register_token():
    with pytest.raises(ValueError, match="register token"):
        dino_twin("DINOModule", vit_kw=dict(num_register_tokens=0))


def count_attention(monkeypatch):
    """Count the packed attention's forward and backward calls (CPU: its plain versions) in
    LAUNCHES, and those with a key mask in MASKED_LAUNCHES, as the CUDA wrappers count their
    launches."""
    fwd, bwd = fa._fwd_plain, fa._bwd_plain

    def forward(qkv, num_heads, bias, scale):
        LAUNCHES[fa.KERNEL] += 1
        MASKED_LAUNCHES[fa.KERNEL] += bias is not None
        return fwd(qkv, num_heads, bias, scale)

    def backward(qkv, g, num_heads, bias, scale):
        LAUNCHES[fa.BWD_KERNEL] += 1
        MASKED_LAUNCHES[fa.BWD_KERNEL] += bias is not None
        return bwd(qkv, g, num_heads, bias, scale)

    monkeypatch.setattr(fa, "_fwd_plain", forward)
    monkeypatch.setattr(fa, "_bwd_plain", backward)


def dino_launches(depth: int) -> tuple[dict, dict]:
    """Packed launches per DINO / DINOv2 step with the probe (the counts chip_smoke.py phase 10
    holds each Trainer step to at depth 12: 50 + 26): forward, the student's global and local
    passes, the teacher's global pass and the probe's full teacher pass (depth each) and the
    probe decoder (2); backward, the student's two passes and the probe decoder. Every pass but
    the probe's carries a key mask."""
    return ({fa.KERNEL: 4 * depth + 2, fa.BWD_KERNEL: 2 * depth + 2}, {fa.KERNEL: 3 * depth, fa.BWD_KERNEL: 2 * depth})


@pytest.mark.parametrize("name,depth", [("DINOModule", 2), ("DINOModule", 3), ("DINOv2Module", 2)])
def test_attention_launches_per_step(monkeypatch, name, depth):
    count_attention(monkeypatch)
    _, p = dino_pair(name, vit_kw=dict(depth=depth))
    reset_launches()
    loss, _ = p.training_loss({"image": t(images((2, 32, 32, 3)))}, torch.Generator().manual_seed(0), 0)
    loss.backward()
    launches, masked = dino_launches(depth)
    assert dict(LAUNCHES) == launches and dict(MASKED_LAUNCHES) == masked
    reset_launches()
