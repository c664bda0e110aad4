"""The port's force-field task (tasks/forcefield.py, the DPT decoder and the flow loss) against the
JAX package on the CPU.

Tiny widths: a ViT of depth 4, dim 32, 2 heads on 32 x 32 x 6 images at patch 8 (a 4 x 4 grid),
hooks (0, 1, 2, 3) and 16 fusion channels, so the Reassemble maps are 16, 8, 4 and 2 wide (scale
0.5 shrinks the grid); the config-built module is ViT-tiny at depth 4. Weights carried from JAX
with load_jax_params, inputs numpy-seeded. The resizes and gathers alone at 1e-5 relative;
anything with a convolution on the path at rtol 2e-4 (gradients plus 1e-5 of the largest one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, TOL, carry, flat_state, flat_variables, images, t
from m3l_tpu.models.vit import VisionTransformer as JViT
from m3l_tpu.tasks import forcefield as jff
from m3l_tpu.utils.config import instantiate as jinstantiate
from m3l_tpu.utils.config import load_config as jload_config
from m3l_tpu_torch.kernels import LAUNCHES, reset_launches
from m3l_tpu_torch.models.vit import VisionTransformer, resize
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.tasks import forcefield as ff
from m3l_tpu_torch.train import Trainer
from m3l_tpu_torch.utils.config import instantiate, load_config
from m3l_tpu_torch.utils.convert import load_jax_params
from test_torch_ssl_dino import count_attention
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FF_VIT = dict(img_size=(32, 32), patch_size=8, in_chans=6, embed_dim=32, depth=4, num_heads=2, pos_embed_fn="sinusoidal", num_register_tokens=0)
FORCEFIELD = "config/experiment/downstream_task/forcefield/digit_dino.yaml"
TINY_FF = ["model_size=tiny", "model.encoder.img_size=[32,32]", "model.encoder.patch_size=8", "model.encoder.depth=4",
           "task.hooks=[0,1,2,3]", "task.fusion_ch=16", "task.warmup_epochs=0"]


def decoder_pair(**kw):
    j = jff.ForceFieldDecoder(JViT(rngs=nnx.Rngs(0), **FF_VIT), hooks=(0, 1, 2, 3), fusion_ch=16, rngs=nnx.Rngs(1), **kw)
    return j, carry(j, ff.ForceFieldDecoder(VisionTransformer(**FF_VIT), hooks=(0, 1, 2, 3), fusion_ch=16))


@pytest.mark.parametrize("shape,out", [((2, 4, 4, 3), (2, 16, 16, 3)), ((2, 4, 4, 3), (2, 2, 2, 3)), ((2, 5, 7, 3), (2, 2, 3, 3)),
                                       ((1, 6, 6, 2), (1, 12, 12, 2)), ((1, 3, 5, 2), (1, 32, 32, 2))],
                         ids=["up4", "shrink_half", "shrink_odd", "up2", "to_image"])
def test_bilinear_resize_equals_jax(shape, out):
    """jax.image.resize "bilinear", up and down: shrinking widens the triangle (antialiasing)."""
    x = images(shape, seed=1)
    np.testing.assert_allclose(resize(t(x), out, "bilinear").numpy(), np.asarray(jax.image.resize(jnp.asarray(x), out, "bilinear")), **TOL)


@pytest.mark.parametrize("grid,scale", [((4, 4), 0.5), ((5, 5), 0.5), ((3, 3), 4.0)], ids=["shrink", "shrink_odd", "grow"])
def test_reassemble_equals_jax(grid, scale):
    """The Reassemble block of forcefield.py:38, on the shrinking path (scale 0.5) too."""
    j = jff.Reassemble(8, 4, grid, scale, rngs=nnx.Rngs(0))
    p = carry(j, ff.Reassemble(8, 4, grid, scale))
    tokens = images((2, grid[0] * grid[1], 8), seed=2)
    with torch.no_grad():
        got = p(t(tokens)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(tokens))), **CONV_TOL)
    assert got.shape[1:3] == (int(grid[0] * scale), int(grid[1] * scale))


def edge_flow(seed: int = 3) -> np.ndarray:
    """Displacements that land inside, on, and up to 3 pixels beyond every edge of an 8 x 8 image,
    with exact integers among them."""
    rng = np.random.default_rng(seed)
    flow = rng.uniform(-11.0, 11.0, (2, 8, 8, 2)).astype(np.float32)
    flow[0, :, :, 0] = np.round(flow[0, :, :, 0])
    flow[0, 0, 0] = [-1.0, -1.0]
    flow[0, 7, 7] = [0.0, 0.0]
    flow[1, 7, 7] = [0.5, 0.25]  # between the last pixel and the one past it
    return flow


def test_warp_equals_jax_at_and_beyond_the_edges():
    """The four corner indices clipped into the image, the weights from the unclipped
    coordinates: values, and gradients to the image and to the flow."""
    img, flow = images((2, 8, 8, 3), seed=4), edge_flow()
    cot = images((2, 8, 8, 3), seed=5)
    ti, tf = t(img).requires_grad_(), t(flow).requires_grad_()
    out = ff.warp(ti, tf)
    (out * t(cot)).sum().backward()
    want, vjp = jax.vjp(jff.warp, jnp.asarray(img), jnp.asarray(flow))
    gi, gf = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), **TOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), **TOL)
    np.testing.assert_allclose(out[0, 7, 7].detach().numpy(), img[0, 7, 7], **TOL)  # zero flow is the identity


def test_ssim_and_photometric_loss_equal_jax():
    a, b = images((2, 9, 7, 3), seed=6), images((2, 9, 7, 3), seed=7)
    np.testing.assert_allclose(ff.ssim(t(a), t(b)).numpy(), np.asarray(jff.ssim(jnp.asarray(a), jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(ff.photometric_loss(t(a), t(b)).item(), float(jff.photometric_loss(jnp.asarray(a), jnp.asarray(b))), **TOL)
    assert ff.ssim(t(a), t(a)).mean().item() < 1e-4


def test_decoder_equals_jax():
    j, p = decoder_pair()
    x = images((2, 32, 32, 6), seed=8)
    with torch.no_grad():
        got = p(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(x))), **CONV_TOL)
    assert got.shape == (2, 32, 32, 3)
    assert (got[..., 0] >= 0).all() and (got[..., 0] <= 1).all() and (got[..., 1:].abs() <= 1).all()


FLOW_KEYS = ("hooks", "fusion_ch", "train_encoder", "encoder_type", "checkpoint_encoder", "warmup_epochs")


def module_pair(geometric: bool, overrides=()):
    """The JAX and port modules built from the force-field experiment config (ViT-tiny at depth
    4), the port's with the JAX weights. The config's task block carries the geometric module's
    keys, which ForceFieldModule does not take (in JAX either), so the flow-only module gets the
    block's other keys through build_forcefield_module(geometric=False)."""
    from m3l_tpu.train.builders import build_forcefield_module as jbuild
    from m3l_tpu_torch.train.builders import build_forcefield_module

    ov = TINY_FF + list(overrides)
    jcfg, cfg = jload_config(FORCEFIELD, ov), load_config(FORCEFIELD, ov)
    jenc, enc = jinstantiate(jcfg["model"]["encoder"]), instantiate(cfg["model"]["encoder"])
    if geometric:
        j, p = jinstantiate(jcfg["task"])(jenc), instantiate(cfg["task"])(enc)
    else:
        j = jbuild(jenc, geometric=False, **{k: v for k, v in jcfg["task"].items() if k in FLOW_KEYS})
        p = build_forcefield_module(enc, geometric=False, **{k: v for k, v in cfg["task"].items() if k in FLOW_KEYS})
    assert type(p).__name__ == type(j).__name__
    return j, carry(j, p)


def ff_batch(seed: int, supervised: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"image": images((2, 32, 32, 6), seed=seed)}
    if supervised:
        batch["forcefield"] = rng.random((2, 32, 32, 3), dtype=np.float32)
    return batch


def loss_and_grads(j, p, batch):
    """(JAX loss, aux, gradients as the port's parameters) and the port's loss, aux after backward."""

    @nnx.jit
    def step_fn(m, batch):
        return nnx.value_and_grad(lambda m: m.training_loss(batch, jax.random.PRNGKey(0), 0), has_aux=True,
                                  argnums=nnx.DiffState(0, m.trainable_filter))(m)

    (jloss, jaux), jgrads = step_fn(j, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = p.training_loss({k: t(v) for k, v in batch.items()}, None, 0)
    loss.backward()
    return jloss, jaux, flat_state(jgrads), loss, aux


def check_grads(p, twin, jflat, jgrads):
    """The port's gradients against JAX's, carried into ``twin`` (a module of the same structure)."""
    load_jax_params(twin, {**jflat, **jgrads})
    want = dict(twin.named_parameters())
    trainable = p.trainable_parameters()
    assert len(jgrads) == len(trainable)
    scale = max(q.grad.abs().max().item() for q in trainable.values() if q.grad is not None)
    for n, q in p.named_parameters():
        if n in trainable:  # the deepest fusion block's rcu1 takes no skip: no gradient, zero in JAX
            got = q.grad if q.grad is not None else torch.zeros_like(q)
            np.testing.assert_allclose(got.numpy(), want[n].detach().numpy(), rtol=2e-4, atol=1e-5 * scale, err_msg=n)
        else:
            assert q.grad is None, n  # the frozen encoder ran without autograd


@pytest.mark.parametrize("supervised", [False, True], ids=["flow", "supervised"])
@pytest.mark.parametrize("train_encoder", [False, True], ids=["frozen", "finetuned"])
def test_forcefield_module_step_equals_jax(supervised, train_encoder):
    """One ForceFieldModule step (task.geometric=false): the loss, its parts and the trainable
    gradients; a frozen encoder stays out of the trainable set and of autograd."""
    j, p = module_pair(False, [f"task.train_encoder={str(train_encoder).lower()}"])
    jloss, jaux, jgrads, loss, aux = loss_and_grads(j, p, ff_batch(9, supervised))
    np.testing.assert_allclose(loss.item(), float(jloss), **CONV_TOL)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), err_msg=k, **CONV_TOL)
    assert any(n.startswith("model_task.encoder.") for n in p.trainable_parameters()) == train_encoder
    check_grads(p, module_pair(False, [f"task.train_encoder={str(train_encoder).lower()}"])[1], flat_variables(j), jgrads)


@pytest.mark.parametrize("train_encoder,launches", [(False, {fa.KERNEL: 4}), (True, {fa.KERNEL: 4, fa.BWD_KERNEL: 4})], ids=["frozen", "finetuned"])
def test_attention_launches_per_step(monkeypatch, train_encoder, launches):
    """A frozen step runs the encoder's hooks forward only (depth 4 here); fine-tuned, forward and
    backward."""
    count_attention(monkeypatch)
    _, p = module_pair(False, [f"task.train_encoder={str(train_encoder).lower()}"])
    reset_launches()
    loss, _ = p.training_loss({k: t(v) for k, v in ff_batch(10).items()}, None, 0)
    loss.backward()
    assert dict(LAUNCHES) == launches
    reset_launches()


def test_frozen_encoder_stays_bit_equal_through_the_trainer():
    _, p = module_pair(False)
    before = {k: v.clone() for k, v in p.state_dict().items()}
    Trainer(max_epochs=1, verbose=0, device="cpu").fit(p, [{k: t(v) for k, v in ff_batch(11 + i).items()} for i in range(2)])
    for k, v in p.state_dict().items():
        if k.startswith("model_task.encoder."):
            assert torch.equal(v, before[k]), k
        elif k.endswith("weight"):
            assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize("depth,want", [(12, [2, 5, 8, 11]), (4, [2]), (2, [1])])
def test_shallow_encoders_drop_hooks_as_jax_does(depth, want):
    from m3l_tpu.train.builders import build_forcefield_module as jbuild
    from m3l_tpu_torch.train.builders import build_forcefield_module

    vit = {**FF_VIT, "depth": depth}
    j = jbuild(JViT(rngs=nnx.Rngs(0), **vit), geometric=False, fusion_ch=8)
    p = build_forcefield_module(VisionTransformer(**vit), geometric=False, fusion_ch=8)
    assert p.model_task.hooks == list(j.model_task.hooks) == want
    carry(j, p)
