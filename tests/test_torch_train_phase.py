"""The port's PPO+MAE update phase as a whole against JAX ``PPOMAE._train_phase`` on the CPU.

Both sides start from the same weights (the JAX policy's, carried by load_jax_params) and the
same rollout (numpy, seeded), with one minibatch per epoch (batch = buffer) and one mask
realisation tiled over the batch, patched into the JAX side's ``random_modal_masking`` and
handed to the port's ``train_phase``. Every sample then sees the same mask and every minibatch
holds the whole buffer, so the result does not depend on either side's permutation. Compared:
the averaged metrics (rtol 2e-4 / atol 2e-5, convolutions on the path) and the updated
parameters, after carrying the JAX ones into a fresh port policy (atol 1e-2 * lr: two Adam
steps move each parameter by at most ~2 lr, and f32 noise in a gradient near zero can turn
its step by a small fraction of lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import m3l_tpu.models.vtmae as jvtmae_module
from m3l_tpu.envs import SyncVecEnv as JSyncVecEnv, make_env as jmake_env
from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTTConfig as JVTTConfig
from m3l_tpu.ops.masking import ModalMask as JModalMask
from m3l_tpu.rl import PPOMAE as JPPOMAE, ActorCritic as JActorCritic, MAEFeatures as JMAEFeatures
from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.models import VTTConfig
from m3l_tpu_torch.ops.masking import mask_from_indices
from m3l_tpu_torch.rl import PPOMAE
from m3l_tpu_torch.serve import build_policy
from m3l_tpu_torch.utils import trace
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS, N_ENVS, N_STEPS, EPOCHS, LR = 2, 2, 8, 2, 1e-4
BATCH = N_ENVS * N_STEPS
TOL = dict(rtol=2e-4, atol=2e-5)


def flat_state(*states) -> dict:
    out = {}
    for state in states:
        for path, v in nnx.to_flat_state(state):
            out["/".join(str(p) for p in path)] = np.asarray(v.get_value() if hasattr(v, "get_value") else v)
    return out


def jax_policy():
    rngs = nnx.Rngs(0)
    cfg = JVTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=FS)
    mae = JVTMAE(JVTT(cfg, rngs=rngs), decoder_dim=64, masking_ratio=0.95, decoder_depth=2, decoder_heads=2,
                 early_conv_masking=True, rngs=rngs)
    return JActorCritic(JMAEFeatures(mae, 64, frame_stack=FS, rngs=rngs), 64, 3, rngs=rngs)


def port_policy():
    cfg = VTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=FS)
    return build_policy(cfg, decoder_depth=2, decoder_heads=2, dtype=torch.float32, device="cpu")


def port_env():
    return SyncVecEnv([make_env("FakeInsertion", i, frame_stack=FS) for i in range(N_ENVS)])


def rollout(seed=0):
    rng = np.random.default_rng(seed)
    data = {
        "obs": {"image": rng.integers(0, 256, (BATCH, FS, 64, 64, 3), dtype=np.uint8),
                "tactile": rng.uniform(-1, 1, (BATCH, FS, 6, 32, 32)).astype(np.float32)},
        "actions": rng.normal(size=(BATCH, 3)).astype(np.float32),
        "values": rng.normal(size=BATCH).astype(np.float32),
        "log_probs": (rng.normal(size=BATCH) - 3.0).astype(np.float32),
    }
    rewards = rng.normal(size=(N_STEPS, N_ENVS)).astype(np.float32)
    starts = (rng.random((N_STEPS, N_ENVS)) < 0.2).astype(np.float32)
    last_values = rng.normal(size=N_ENVS).astype(np.float32)
    last_dones = np.array([0.0, 1.0], np.float32)
    # one mask realisation: the reference's counts for 192 tokens, tiled over the batch
    ms, us, off = [], [], 0
    for n, m in zip([64, 64, 64], [60, 61, 61]):
        perm = rng.permutation(n) + off
        ms.append(perm[:m])
        us.append(perm[m:])
        off += n
    masked, kept = (np.tile(np.concatenate(p)[None], (BATCH, 1)) for p in (ms, us))
    return data, (rewards, starts, last_values, last_dones), (masked, kept)


def test_train_phase_matches_jax(monkeypatch):
    data, (rewards, starts, last_values, last_dones), (masked, kept) = rollout()
    restore = np.argsort(np.concatenate([kept, masked], axis=1), axis=1)
    jmask = JModalMask(*(jnp.asarray(a, jnp.int32) for a in (masked, kept, restore)))
    monkeypatch.setattr(jvtmae_module, "random_modal_masking", lambda key, b, sizes, m: jmask)

    jp = jax_policy()
    jenv = JSyncVecEnv([jmake_env("FakeInsertion", i, 0, frame_stack=FS) for i in range(N_ENVS)])
    jmodel = JPPOMAE(jp, jenv, learning_rate=LR, n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS, frame_stack=FS)
    init = flat_state(jmodel.mae_params, jmodel.other_params)  # _train_phase donates these
    tp = port_policy()
    load_jax_params(tp, init)
    start = {n: p.detach().clone() for n, p in tp.named_parameters()}
    model = PPOMAE(tp, port_env(), learning_rate=LR, n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS,
                   frame_stack=FS, device="cpu")
    assert (model.batch_size, model.n_minibatches) == (jmodel.batch_size, jmodel.n_minibatches) == (BATCH, 1)

    jput = lambda a: jax.tree.map(jnp.asarray, a)  # noqa: E731
    mae_p, other_p, _, _, jmetrics = jmodel._train_phase(
        jmodel.mae_params, jmodel.other_params, jmodel.policy_opt_state, jmodel.mae_opt_state, jput(data),
        jnp.asarray(rewards), jnp.asarray(starts), jnp.asarray(last_values), jnp.asarray(last_dones), jax.random.PRNGKey(0),
    )
    tput = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tdata = {"obs": {k: tput(v) for k, v in data["obs"].items()}, **{k: tput(data[k]) for k in ("actions", "values", "log_probs")}}
    idx = torch.stack([torch.randperm(BATCH, generator=torch.Generator().manual_seed(e)) for e in range(EPOCHS)])
    tmask = mask_from_indices(torch.from_numpy(masked), torch.from_numpy(kept))
    metrics = model.train_phase(tdata, tput(rewards), tput(starts), tput(last_values), tput(last_dones), idx, [tmask] * EPOCHS)

    assert metrics.keys() == jmetrics.keys()
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), err_msg=k, **TOL)

    carried = port_policy()
    load_jax_params(carried, flat_state(mae_p, other_p))
    expected = dict(carried.named_parameters())
    for name, p in model.policy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[name].detach().numpy(), rtol=0, atol=1e-2 * LR, err_msg=name)
    assert model.optimizer.count == EPOCHS
    # the comparison is not vacuous: Adam's first steps move most parameters by ~lr each
    assert max((p.detach() - start[n]).abs().max().item() for n, p in model.policy.named_parameters()) > LR


def test_learn_on_the_cpu_and_unported_options_raise():
    torch.manual_seed(0)
    policy = port_policy()
    before = [p.detach().clone() for p in policy.parameters()]
    model = PPOMAE(policy, port_env(), n_steps=8, batch_size=8, n_epochs=1, frame_stack=FS, device="cpu", seed=1)
    trace.start()
    model.learn(total_timesteps=32)
    spans = trace.stop()
    assert model.num_timesteps == 32 and model.iteration == 2
    phases = [(s.name, s.ident) for s in spans if s.name in ("ppo.collect", "ppo.train")]
    assert phases == [("ppo.collect", 0), ("ppo.train", 0), ("ppo.collect", 1), ("ppo.train", 1)]
    m = model.last_metrics
    assert m["n_updates_executed"] == model.n_epochs * model.n_minibatches == 2
    for k in ("policy_loss", "value_loss", "entropy_loss", "approx_kl", "clip_fraction", "loss", "mae_loss"):
        assert np.isfinite(m[k]), k
    assert m["mae_loss"] > 0
    assert any((p.detach() - b).abs().max() > 0 for p, b in zip(policy.parameters(), before))
    obs = model.env.reset(seed=0)
    a = model.predict(obs)
    np.testing.assert_array_equal(a, model.predict(obs))
    assert a.shape == (N_ENVS, 3) and (np.abs(a) <= 1.0).all()
    # the options once refused are ported (tests/test_torch_ppo_modes.py checks them against JAX)
    separate = PPOMAE(port_policy(), port_env(), separate_optimizer=True, target_kl=0.1, device="cpu")
    mae_params = list(separate.policy.features.mae.parameters())
    assert separate.separate_optimizer and len(separate.mae_optimizer.params) == len(mae_params)
    assert all(a is b for a, b in zip(separate.mae_optimizer.params, mae_params))
    assert separate.mae_optimizer.eps == 1e-8 and separate.mae_optimizer.max_grad_norm is None
    plain = PPOMAE(port_policy(), port_env(), separate_optimizer=True, train_mae=False, device="cpu")
    assert not plain.separate_optimizer and plain.mae_optimizer is None


def test_train_f32_check_sees_a_dropped_key():
    """chip_smoke.py holds one f32 update on the card to TRAIN_F32_TOL of the CPU's. Two CPU
    runs of the same update agree exactly; one key of the 192 (and of the 10 kept) left out of
    every attention layer moves the losses, the gradient and the updated parameters past it."""
    from chip_smoke import FRAME_STACK, TRAIN_ENVS, TRAIN_F32_TOL, train_env, update_errors

    cfg = VTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=FRAME_STACK)

    def model(policy):
        return PPOMAE(policy, train_env(), n_steps=1, batch_size=TRAIN_ENVS, frame_stack=FRAME_STACK, device="cpu")

    torch.manual_seed(0)
    init = build_policy(cfg, decoder_depth=2, decoder_heads=2, dtype=torch.float32, device="cpu").state_dict()

    def policy():
        p = build_policy(cfg, decoder_depth=2, decoder_heads=2, dtype=torch.float32, device="cpu")
        p.load_state_dict(init)
        return p

    same = update_errors(model(policy()), model(policy()), TRAIN_ENVS)
    assert same["loss_rel"] == same["grad_rel"] == same["param_per_lr"] == 0.0

    dropping = policy()
    for attn in (m for m in dropping.modules() if type(m).__name__ == "Attention"):
        def drop_last_key(x, key_mask=None, forward=attn.forward):
            keep = torch.ones(x.shape[:2], dtype=torch.bool)
            keep[:, -1] = False
            return forward(x, keep)
        attn.forward = drop_last_key
    dropped = update_errors(model(policy()), model(dropping), TRAIN_ENVS)
    assert all(dropped[k] > TRAIN_F32_TOL[k] for k in TRAIN_F32_TOL), dropped


def test_evaluate_actions_match_jax(monkeypatch):
    """evaluate_actions, _packed and _packed_with_mae (injected mask) on carried weights."""
    from m3l_tpu.utils.obs import vt_load as jvt_load
    from m3l_tpu_torch.utils.obs import vt_load

    data, _, (masked, kept) = rollout(seed=1)
    b = 4
    obs = {k: v[:b] for k, v in data["obs"].items()}
    actions = data["actions"][:b]
    restore = np.argsort(np.concatenate([kept[:b], masked[:b]], axis=1), axis=1)
    jmask = JModalMask(*(jnp.asarray(a, jnp.int32) for a in (masked[:b], kept[:b], restore)))
    monkeypatch.setattr(jvtmae_module, "random_modal_masking", lambda key, n, sizes, m: jmask)
    jp = jax_policy()
    jp.log_std[...] = jnp.asarray([0.2, -0.1, 0.3], jnp.float32)
    tp = port_policy()
    load_jax_params(tp, flat_state(nnx.state(jp, nnx.Param)))
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    tx, jx = vt_load(tobs, frame_stack=FS), jvt_load(obs, frame_stack=FS)
    ta = torch.from_numpy(actions)
    tmask = mask_from_indices(torch.from_numpy(masked[:b]), torch.from_numpy(kept[:b]))
    with torch.no_grad():
        pairs = [
            (tp.evaluate_actions(tobs, ta), jp.evaluate_actions(obs, jnp.asarray(actions))),
            (tp.evaluate_actions_packed(tx, ta), jp.evaluate_actions_packed(jx, jnp.asarray(actions))),
            (tp.evaluate_actions_packed_with_mae(tx, ta, tmask),
             jp.evaluate_actions_packed_with_mae(jx, jnp.asarray(actions), jax.random.PRNGKey(0))),
        ]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs)
        for o, t in zip(ours, theirs):
            np.testing.assert_allclose(o.numpy(), np.asarray(t), **TOL)


def test_vtmae_forward_draws_its_mask_from_the_generator():
    mae = port_policy().features.mae
    data, _, _ = rollout(seed=2)
    from m3l_tpu_torch.utils.obs import vt_load

    x = vt_load({k: torch.from_numpy(v[:2]) for k, v in data["obs"].items()}, frame_stack=FS)
    with torch.no_grad():
        loss = mae(x, torch.Generator().manual_seed(5))
        expected = mae.masked_loss(x, mae.sample_mask(torch.Generator().manual_seed(5), 2))
    assert torch.equal(loss, expected) and loss.item() > 0
