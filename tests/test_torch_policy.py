"""The port's serving slice as a whole against the JAX policy on the CPU.

The JAX ActorCritic is built at small width as tests/test_serve.py builds it; its weights are
carried into the port's policy by load_jax_params, which must consume every JAX parameter and
set every torch one. The same raw observations then go through the JAX serving function (the
clipped Gaussian mean of ``_dist_params``, what ``export_policy(deterministic=True)`` computes)
and through the port's PolicyServer on the CPU, in f32. Tolerance rtol 2e-4 / atol 2e-5:
EarlyCNN convolutions are on the path (see tests/test_torch_modules.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTTConfig as JVTTConfig
from m3l_tpu.rl import ActorCritic as JActorCritic, MAEFeatures as JMAEFeatures
from m3l_tpu_torch.models import VTTConfig
from m3l_tpu_torch.serve import PolicyServer, build_policy
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=2e-4, atol=2e-5)
LOW, HIGH = [-0.05, -1.0, -0.02], [0.05, 1.0, 0.02]


def jax_policy(frame_stack, early_conv=True):
    rngs = nnx.Rngs(0)
    cfg = JVTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=frame_stack)
    mae = JVTMAE(JVTT(cfg, rngs=rngs), decoder_dim=64, masking_ratio=0.95, decoder_depth=2, decoder_heads=2,
                 early_conv_masking=early_conv, rngs=rngs)
    return JActorCritic(JMAEFeatures(mae, cfg.dim, frame_stack=frame_stack, rngs=rngs), cfg.dim, 3, rngs=rngs)


def port_policy(frame_stack, early_conv=True):
    cfg = VTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=frame_stack)
    return build_policy(cfg, decoder_depth=2, decoder_heads=2, early_conv_masking=early_conv,
                        dtype=torch.float32, device="cpu")


def flat_params(module) -> dict:
    out = {}
    for path, var in nnx.to_flat_state(nnx.state(module, nnx.Param)):
        out["/".join(str(p) for p in path)] = np.asarray(var.get_value() if hasattr(var, "get_value") else var)
    return out


def raw_obs(batch, frame_stack, seed):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.integers(0, 256, (batch, frame_stack, 64, 64, 3), dtype=np.uint8),
        "tactile": rng.uniform(-1, 1, (batch, frame_stack, 6, 32, 32)).astype(np.float32),
    }


def carried(frame_stack, early_conv=True):
    jp = jax_policy(frame_stack, early_conv)
    # a non-zero log_std so the stochastic path checks exp(log_std) too
    jp.log_std[...] = jnp.asarray([0.1, -0.3, 0.5], jnp.float32)
    tp = port_policy(frame_stack, early_conv)
    load_jax_params(tp, flat_params(jp))
    return jp, tp


@pytest.mark.parametrize("frame_stack,early_conv", [(1, True), (4, True), (4, False)])
def test_policy_server_matches_jax_serving(frame_stack, early_conv):
    jp, tp = carried(frame_stack, early_conv)
    obs = raw_obs(3, frame_stack, seed=frame_stack)
    mean, _, value = jp._dist_params(obs)
    server = PolicyServer(tp, action_low=LOW, action_high=HIGH)
    actions = server(obs)
    assert actions.shape == (3, 3) and actions.dtype == np.float32
    np.testing.assert_allclose(actions, np.clip(np.asarray(mean), LOW, HIGH), **TOL)
    with torch.inference_mode():
        values = tp.predict_values(server.to_device(obs)).numpy()
    np.testing.assert_allclose(values, np.asarray(value), **TOL)
    np.testing.assert_allclose(PolicyServer(tp)(obs), np.asarray(mean), **TOL)


def test_step_with_injected_noise():
    jp, tp = carried(1)
    obs = raw_obs(4, 1, seed=9)
    server = PolicyServer(tp)
    x = server.to_device(obs)
    with torch.inference_mode():
        actions, values, log_prob = tp.step(x, torch.Generator().manual_seed(11))
        mean, log_std, _ = tp._dist_params(x)
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(11))
        expected = mean + torch.exp(log_std) * noise
    np.testing.assert_allclose(actions.numpy(), expected.numpy(), rtol=1e-6, atol=1e-6)
    ref_lp = JActorCritic._log_prob(jnp.asarray(actions.numpy()), jnp.asarray(mean.numpy()), jnp.asarray(log_std.detach().numpy()))
    np.testing.assert_allclose(log_prob.numpy(), np.asarray(ref_lp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(server.sample(obs, torch.Generator().manual_seed(11)), actions.numpy(), rtol=1e-6, atol=1e-6)
    with torch.inference_mode():
        det, _, _ = tp.step(x, deterministic=True)
    jmean, _, jvalue = jp._dist_params(obs)
    np.testing.assert_allclose(det.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalue), **TOL)


def test_slice_f32_tolerance_sees_a_dropped_key(monkeypatch):
    """chip_smoke.py holds the f32 policy on the card to SLICE_F32_TOL of the CPU's: one key of
    the 192 left out of every attention layer must move the actions by more than that."""
    from chip_smoke import SLICE_F32_TOL
    from m3l_tpu_torch.nn import flash_attention as fa

    server = PolicyServer(port_policy(4))
    obs = raw_obs(8, 4, seed=5)
    good = server(obs)
    plain = fa._fwd_plain

    def drop_last_key(qkv, num_heads, bias, scale):
        keep = torch.ones(qkv.shape[:2], dtype=torch.bool)
        keep[:, -1] = False
        return plain(qkv, num_heads, fa._key_bias(keep), scale)

    monkeypatch.setattr(fa, "_fwd_plain", drop_last_key)
    assert np.abs(server(obs) - good).max() > SLICE_F32_TOL


def test_load_jax_params_raises_on_missing_and_extra_keys():
    jp = jax_policy(1)
    flat = flat_params(jp)
    with pytest.raises(KeyError, match="left unset.*log_std"):
        load_jax_params(port_policy(1), {k: v for k, v in flat.items() if k != "log_std"})
    with pytest.raises(KeyError, match="left unused.*features/mae/not_a_param"):
        load_jax_params(port_policy(1), {**flat, "features/mae/not_a_param": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(port_policy(1), {**flat, "log_std": np.zeros(4, np.float32)})
