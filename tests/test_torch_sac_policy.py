"""The port's SAC actor-critic (m3l_tpu_torch.rl.sac_policy) against the JAX ``SACActorCritic`` on
the CPU, at a small width (dim 64, depth 2, 2 heads, frame stack 2), with the JAX weights carried
by ``load_jax_params`` (the root-level 0-d ``log_ent_coef`` included) and the same raw obs.

The JAX actor draws its noise from a key; the port takes the noise as an argument, here the
numbers ``jax.random.normal`` drew from that key. Tolerance rtol 2e-4 / atol 2e-5 (convolutions
on the path, as in tests/test_torch_train_phase.py). The clamp of log_std is checked on ``dist``
with the head's bias pushed past both limits; sampled actions are compared with the head as
drawn, because at std = e^2 the tanh saturates and log(1 - a^2) turns f32 noise in the features
into percent differences.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTTConfig as JVTTConfig
from m3l_tpu.rl import MAEFeatures as JMAEFeatures, SACActorCritic as JSACActorCritic
from m3l_tpu.utils.obs import vt_load as jvt_load
from m3l_tpu_torch.models import VTMAE, VTT, VTTConfig
from m3l_tpu_torch.rl import MAEFeatures, SACActorCritic
from m3l_tpu_torch.rl.sac_policy import LOG_STD_MAX, LOG_STD_MIN
from m3l_tpu_torch.utils.convert import load_jax_params
from m3l_tpu_torch.utils.obs import vt_load
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS, DIM, A, B = 2, 64, 3, 4
TOL = dict(rtol=2e-4, atol=2e-5)


def flat_state(*states) -> dict:
    out = {}
    for state in states:
        for path, v in nnx.to_flat_state(state):
            out["/".join(str(p) for p in path)] = np.asarray(v.get_value() if hasattr(v, "get_value") else v)
    return out


def jax_sac_policy() -> JSACActorCritic:
    rngs = nnx.Rngs(0)
    cfg = JVTTConfig(dim=DIM, depth=2, heads=2, mlp_dim=2 * DIM, num_tactiles=2, frame_stack=FS)
    mae = JVTMAE(JVTT(cfg, rngs=rngs), decoder_dim=DIM, masking_ratio=0.95, decoder_depth=2, decoder_heads=2,
                 early_conv_masking=True, rngs=rngs)
    return JSACActorCritic(JMAEFeatures(mae, DIM, frame_stack=FS, rngs=rngs), DIM, A, rngs=rngs)


def port_sac_policy(dtype=torch.float32) -> SACActorCritic:
    cfg = VTTConfig(dim=DIM, depth=2, heads=2, mlp_dim=2 * DIM, num_tactiles=2, frame_stack=FS)
    mae = VTMAE(VTT(cfg, dtype=dtype), decoder_dim=DIM, masking_ratio=0.95, decoder_depth=2, decoder_heads=2,
                early_conv_masking=True, dtype=dtype)
    return SACActorCritic(MAEFeatures(mae, DIM, frame_stack=FS, dtype=dtype), DIM, A, dtype=dtype)


def random_obs(rng, batch):
    return {"image": rng.integers(0, 256, (batch, FS, 64, 64, 3), dtype=np.uint8),
            "tactile": rng.uniform(-1, 1, (batch, FS, 6, 32, 32)).astype(np.float32)}


def make_pair(log_std_bias=None):
    jp = jax_sac_policy()
    if log_std_bias is not None:
        jp.actor.log_std.bias[...] = jnp.asarray(log_std_bias, jnp.float32)
    jp.log_ent_coef[...] = jnp.asarray(0.3, jnp.float32)
    tp = port_sac_policy()
    load_jax_params(tp, flat_state(nnx.state(jp, nnx.Param)))
    obs = random_obs(np.random.default_rng(0), B)
    jfeats = jp.features.from_packed(jvt_load(obs, frame_stack=FS))
    with torch.no_grad():
        tfeats = tp.features.from_packed(vt_load({k: torch.from_numpy(v) for k, v in obs.items()}, frame_stack=FS))
    return jp, tp, obs, jfeats, tfeats


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_every_parameter_carries_over_and_the_names_follow_the_nnx_paths(pair):
    jp, tp, *_ = pair
    names = dict(tp.named_parameters())
    assert names["log_ent_coef"].shape == () and names["log_ent_coef"].item() == pytest.approx(0.3)
    for name in ("actor.latent.layers.0.weight", "actor.mu.bias", "actor.log_std.weight", "critic.qs.1.mlp.layers.1.weight",
                 "critic.qs.0.head.bias", "critic_target.qs.1.head.weight", "features.post.norm.weight"):
        assert name in names, name
    np.testing.assert_array_equal(names["actor.log_std.bias"].detach().numpy(), np.asarray(jp.actor.log_std.bias[...]))


def test_log_std_is_clamped_at_both_limits():
    jp, tp, _, jfeats, tfeats = make_pair([5.0, -25.0, 0.0])
    with torch.no_grad():
        mean, log_std = tp.actor.dist(tfeats)
    jmean, jlog_std = jp.actor.dist(jfeats)
    assert (log_std[:, 0] == LOG_STD_MAX).all() and (log_std[:, 1] == LOG_STD_MIN).all()
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(log_std.numpy(), np.asarray(jlog_std), **TOL)


def test_features_match(pair):
    _, _, _, jfeats, tfeats = pair
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats), **TOL)


@pytest.mark.parametrize("what", ["dist", "action_log_prob", "deterministic_action", "critic", "critic_target"])
def test_heads_match(pair, what):
    jp, tp, _, jfeats, tfeats = pair
    rng = np.random.default_rng(1)
    actions = rng.uniform(-1, 1, (B, A)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (B, A), jnp.float32))
    with torch.no_grad():
        if what == "dist":
            ours, theirs = tp.actor.dist(tfeats), jp.actor.dist(jfeats)
        elif what == "action_log_prob":
            ours, theirs = tp.actor.action_log_prob(tfeats, torch.from_numpy(noise)), jp.actor.action_log_prob(jfeats, key)
        elif what == "deterministic_action":
            ours, theirs = (tp.actor.deterministic_action(tfeats),), (jp.actor.deterministic_action(jfeats),)
        else:
            ours = (getattr(tp, what)(tfeats, torch.from_numpy(actions)),)
            theirs = (getattr(jp, what)(jfeats, jnp.asarray(actions)),)
            assert ours[0].shape == (B, 2)
    for o, t in zip(ours, theirs):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(t), **TOL)


def test_sample_action_and_predict_from_raw_obs(pair):
    jp, tp, obs, _, _ = pair
    key = jax.random.PRNGKey(4)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, A), jnp.float32)))
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    with torch.no_grad():
        a, logp = tp.sample_action(tobs, noise)
        det = tp.predict(tobs)
    ja, jlogp = jp.sample_action(obs, key)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), **TOL)
    np.testing.assert_allclose(det.numpy(), np.asarray(jp.predict(obs)), **TOL)
    assert (det.abs() <= 1).all() and (a.abs() <= 1).all()
