"""The port's conv-net baselines (models/baselines.py) against the JAX package on the CPU.

The ResNet-18 and the AlexNet encoder carry the JAX weights, BatchNorm's running statistics
included (load_jax_params maps nnx.BatchStat mean / var into running_mean / running_var); the
statistics, scales and biases are drawn at random first so the normalisation is exercised. Inputs
are numpy-seeded NHWC. Convolutions are on the path: outputs at rtol 2e-4, gradients at rtol 2e-4
plus 1e-5 of the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, flat_state, flat_variables, images, t
from m3l_tpu.models.baselines import AlexNetEncoder as JAlexNet
from m3l_tpu.models.baselines import ResNet18Encoder as JResNet
from m3l_tpu_torch.models.baselines import AlexNetEncoder, ResNet18Encoder, max_pool_same
from m3l_tpu_torch.nn.layers import BatchNorm2d
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def random_batch_stats(module, seed: int = 0):
    """Random running statistics, scales and biases in every nnx.BatchNorm of ``module``."""
    rng = np.random.default_rng(seed)
    for _, m in nnx.iter_modules(module):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean[...].shape[0]
            m.mean[...] = jnp.asarray(rng.normal(0, 0.2, c).astype(np.float32))
            m.var[...] = jnp.asarray(rng.uniform(0.5, 2.0, c).astype(np.float32))
            m.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, c).astype(np.float32))
            m.bias[...] = jnp.asarray(rng.normal(0, 0.1, c).astype(np.float32))
    return module


def resnet_pair(in_chans=3):
    j = random_batch_stats(JResNet(in_chans, rngs=nnx.Rngs(0)))
    p = ResNet18Encoder(in_chans)
    load_jax_params(p, flat_variables(j))
    return j, p


def test_batch_norm_statistics_carry_over():
    j, p = resnet_pair()
    np.testing.assert_array_equal(p.stem.bn.running_mean.numpy(), np.asarray(j.stem.bn.mean[...]))
    np.testing.assert_array_equal(p.blocks[2].down.bn.running_var.numpy(), np.asarray(j.blocks[2].down.bn.var[...]))
    np.testing.assert_array_equal(p.blocks[7].bn2.weight.detach().numpy(), np.asarray(j.blocks[7].bn2.scale[...]))
    assert "num_batches_tracked" not in " ".join(p.state_dict())


@pytest.mark.parametrize("size", [64, 50], ids=["even", "odd"])
def test_resnet18_equals_jax(size):
    """forward_spatial, the tokens of forward_features and the pooled call; 64 gives the stem's max
    pool an even input (SAME pads (0, 1)), 50 an odd one (1, 1)."""
    j, p = resnet_pair()
    x = images((2, size, size, 3), seed=1)
    with torch.no_grad():
        spatial = p.forward_spatial(t(x))
        tokens = p.forward_features(t(x))["x_norm_patchtokens"]
        pooled = p(t(x))
    np.testing.assert_allclose(spatial.numpy(), np.asarray(j.forward_spatial(jnp.asarray(x))), **CONV_TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(j.forward_features(jnp.asarray(x))["x_norm_patchtokens"]), **CONV_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j(jnp.asarray(x))), **CONV_TOL)
    assert spatial.shape == (2, -(-size // 32), -(-size // 32), 512)


@pytest.mark.parametrize("size", [8, 9, 12], ids=["even", "odd", "even_12"])
def test_max_pool_same_equals_xla(size):
    x = np.random.default_rng(size).normal(size=(2, 3, size, size)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x.transpose(0, 2, 3, 1)), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = max_pool_same(t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    symmetric = torch.nn.MaxPool2d(3, 2, padding=1)(t(x))
    assert symmetric.shape == got.shape
    # on an even input XLA pads only at the end, so the windows are not torch's symmetric ones
    assert torch.equal(symmetric, got) == (size % 2 == 1)


def test_batch_norm_in_train_mode_uses_running_statistics():
    """Train mode changes nothing: the running statistics normalise and stay as they were."""
    j, p = resnet_pair()
    before = {k: v.clone() for k, v in p.state_dict().items()}
    x = images((2, 64, 64, 3), seed=2)
    p.train()
    out = p.forward_spatial(t(x))
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j.forward_spatial(jnp.asarray(x))), **CONV_TOL)
    for k, v in p.state_dict().items():
        assert torch.equal(v, before[k]), k
    bn = BatchNorm2d(3).train()
    bn.running_mean.fill_(1.0)
    y = t(np.full((2, 3, 4, 4), 1.0, np.float32))
    assert torch.equal(bn(y), torch.zeros_like(y)) and torch.equal(bn.running_mean, torch.ones(3))


def test_resnet18_gradients_equal_jax():
    j, p = resnet_pair(in_chans=6)
    x = images((2, 64, 64, 6), seed=3)
    w = images((2, 2, 2, 512), seed=4)

    @nnx.jit
    def grads(m, x):
        return nnx.grad(lambda m: jnp.sum(m.forward_spatial(x) * w))(m)

    jgrads = grads(j, jnp.asarray(x))
    (p.forward_spatial(t(x)) * t(w)).sum().backward()
    ref = ResNet18Encoder(6)
    load_jax_params(ref, {**flat_variables(j), **flat_state(jgrads)})
    want = dict(ref.named_parameters())
    scale = max(q.grad.abs().max().item() for q in p.parameters())
    assert len(flat_state(jgrads)) == len(list(p.parameters()))
    for n, q in p.named_parameters():
        np.testing.assert_allclose(q.grad.numpy(), want[n].detach().numpy(), rtol=2e-4, atol=1e-5 * scale, err_msg=n)


def test_alexnet_equals_jax():
    j = JAlexNet(3, rngs=nnx.Rngs(0))
    p = AlexNetEncoder(3)
    load_jax_params(p, flat_variables(j))
    x = images((2, 67, 67, 3), seed=5)
    with torch.no_grad():
        tokens = p.forward_features(t(x))["x_norm_patchtokens"]
        pooled = p(t(x))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(j.forward_features(jnp.asarray(x))["x_norm_patchtokens"]), **CONV_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(j(jnp.asarray(x))), **CONV_TOL)
    assert tokens.shape == (2, 1, 256)
