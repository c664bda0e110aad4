"""The port's PPOMAE modes (separate optimizer, target_kl gate, plain PPO) against JAX
``PPOMAE._train_phase`` on the CPU, and its checkpoints.

The method of ``tests/test_torch_train_phase.py``: the same weights (carried by load_jax_params),
the same seeded rollout, one mask realisation tiled over the batch and patched into the JAX
side's ``random_modal_masking``, and one minibatch per epoch (batch = buffer). In separate mode
each minibatch runs two MAE chunks of 8 samples, each with the same mask, and the chunks are cut
from the minibatch in its permuted order, so the port gets JAX's permutations. For the gate, the
rollout's log-probabilities are the policy's own, so the first update's approx_kl is ~0 (~7e-3
in separate mode, after the MAE chunks moved the encoder) and passes a small target_kl, and the
second, after one Adam step, does not: exactly one update executes on both sides. Compared: the
metrics (rtol 2e-4 / atol 2e-5) and the updated parameters (atol 1e-2 * lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m3l_tpu.models.vtmae as jvtmae_module
from m3l_tpu.envs import SyncVecEnv as JSyncVecEnv, make_env as jmake_env
from m3l_tpu.ops.masking import ModalMask as JModalMask
from m3l_tpu.rl import PPOMAE as JPPOMAE
from m3l_tpu_torch.ops.masking import mask_from_indices
from m3l_tpu_torch.rl import PPOMAE
from m3l_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint, step_checkpoints
from m3l_tpu_torch.train.optim import FlatAdam
from m3l_tpu_torch.utils.convert import load_jax_params
from test_torch_train_phase import BATCH, EPOCHS, FS, LR, N_ENVS, N_STEPS, TOL, flat_state, jax_policy, port_env, port_policy, rollout
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAE_BS = 8
TARGET_KL = 1e-2  # first update's approx_kl: 0 joint, ~7e-3 separate; second: ~3e-2 and ~7e-2
MODES = {
    "separate": dict(separate_optimizer=True),
    "target_kl": dict(target_kl=TARGET_KL),
    "separate_target_kl": dict(separate_optimizer=True, target_kl=TARGET_KL),
    "no_mae": dict(train_mae=False),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_train_phase_mode_matches_jax(mode, monkeypatch):
    kw = MODES[mode]
    data, (rewards, starts, last_values, last_dones), (masked, kept) = rollout(seed=5)
    restore = np.argsort(np.concatenate([kept, masked], axis=1), axis=1)
    full = [jnp.asarray(a, jnp.int32) for a in (masked, kept, restore)]
    monkeypatch.setattr(jvtmae_module, "random_modal_masking", lambda key, b, sizes, m: JModalMask(*(a[:b] for a in full)))

    jp = jax_policy()
    jenv = JSyncVecEnv([jmake_env("FakeInsertion", i, 0, frame_stack=FS) for i in range(N_ENVS)])
    jmodel = JPPOMAE(jp, jenv, learning_rate=LR, n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS, frame_stack=FS,
                     mae_batch_size=MAE_BS, **kw)
    init = flat_state(jmodel.mae_params, jmodel.other_params)  # _train_phase donates these
    tp = port_policy()
    load_jax_params(tp, init)
    model = PPOMAE(tp, port_env(), learning_rate=LR, n_steps=N_STEPS, batch_size=BATCH, n_epochs=EPOCHS, frame_stack=FS,
                   mae_batch_size=MAE_BS, device="cpu", **kw)
    tput = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if "target_kl" in kw:  # the policy's own log-probabilities: the first update's approx_kl is ~0
        with torch.no_grad():
            obs = {k: tput(v) for k, v in data["obs"].items()}
            data["log_probs"] = tp.evaluate_actions(obs, tput(data["actions"]))[1].numpy()

    jput = lambda a: jax.tree.map(jnp.asarray, a)  # noqa: E731
    mae_p, other_p, _, _, jmetrics = jmodel._train_phase(
        jmodel.mae_params, jmodel.other_params, jmodel.policy_opt_state, jmodel.mae_opt_state, jput(data),
        jnp.asarray(rewards), jnp.asarray(starts), jnp.asarray(last_values), jnp.asarray(last_dones), jax.random.PRNGKey(0),
    )
    tdata = {"obs": {k: tput(v) for k, v in data["obs"].items()}, **{k: tput(data[k]) for k in ("actions", "values", "log_probs")}}
    # JAX's own permutations for PRNGKey(0) (_train_phase :324-326): MAE chunks are cut in order
    kperm, _ = jax.random.split(jax.random.PRNGKey(0))
    perms = jax.vmap(lambda k: jax.random.permutation(k, BATCH))(jax.random.split(kperm, EPOCHS))
    idx = torch.from_numpy(np.asarray(perms, np.int64))
    if kw.get("train_mae") is False:
        masks = [None] * EPOCHS
    elif kw.get("separate_optimizer"):
        chunk = mask_from_indices(torch.from_numpy(masked[:MAE_BS]), torch.from_numpy(kept[:MAE_BS]))
        masks = [[chunk] * (BATCH // MAE_BS)] * EPOCHS
    else:
        masks = [mask_from_indices(torch.from_numpy(masked), torch.from_numpy(kept))] * EPOCHS
    metrics = model.train_phase(tdata, tput(rewards), tput(starts), tput(last_values), tput(last_dones), idx, masks)

    assert metrics.keys() == jmetrics.keys()
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), err_msg=k, **TOL)
    executed = 1 if "target_kl" in kw else EPOCHS
    assert metrics["n_updates_executed"] == float(jmetrics["n_updates_executed"]) == executed
    assert model.optimizer.count == executed
    if kw.get("separate_optimizer"):  # the stopping minibatch ran its MAE chunks, as in JAX
        ran = min(executed + 1, EPOCHS) if "target_kl" in kw else EPOCHS
        assert model.mae_optimizer.count == ran * BATCH // MAE_BS
    assert (metrics["mae_loss"] == 0) == (kw.get("train_mae") is False)

    carried = port_policy()
    load_jax_params(carried, flat_state(mae_p, other_p))
    expected = dict(carried.named_parameters())
    for name, p in model.policy.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[name].detach().numpy(), rtol=0, atol=1e-2 * LR, err_msg=name)


def test_ppomae_save_load_round_trip(tmp_path):
    torch.manual_seed(0)
    model = PPOMAE(port_policy(), port_env(), n_steps=8, batch_size=8, n_epochs=1, frame_stack=FS, mae_batch_size=4,
                   separate_optimizer=True, device="cpu", seed=1)
    model.learn(total_timesteps=32)
    path = str(tmp_path / "ckpt" / "ppo.ckpt")
    model.save(path)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["ppo.ckpt", "ppo.ckpt.vecnorm.pkl"]

    torch.manual_seed(1)  # other weights: the load must overwrite them all
    fresh = PPOMAE(port_policy(), port_env(), n_steps=8, batch_size=8, n_epochs=1, frame_stack=FS, mae_batch_size=4,
                   separate_optimizer=True, device="cpu", seed=1)
    fresh.load(path)
    assert fresh.num_timesteps == model.num_timesteps == 32
    for (n, a), b in zip(model.policy.state_dict().items(), fresh.policy.state_dict().values()):
        assert torch.equal(a, b), n
    for ours, theirs in ((model.optimizer, fresh.optimizer), (model.mae_optimizer, fresh.mae_optimizer)):
        assert ours.count == theirs.count > 0
        assert torch.equal(ours.mu, theirs.mu) and torch.equal(ours.nu, theirs.nu)
    a, b = model.reward_normalizer, fresh.reward_normalizer
    np.testing.assert_array_equal(a.returns, b.returns)
    assert (a.ret_rms.mean, a.ret_rms.var, a.ret_rms.count) == (b.ret_rms.mean, b.ret_rms.var, b.ret_rms.count)
    obs = model.env.reset(seed=3)
    np.testing.assert_array_equal(model.predict(obs), fresh.predict(obs))
    # a model whose optimizer covers other parameters refuses the checkpoint
    with pytest.raises(ValueError, match="FlatAdam"):
        FlatAdam([torch.nn.Parameter(torch.zeros(3))], 1e-3).load_state_dict(model.optimizer.state_dict())


def test_checkpoint_files(tmp_path):
    save_checkpoint(tmp_path / "a.ckpt", {"x": torch.arange(3), "n": 7})
    assert [p.name for p in tmp_path.iterdir()] == ["a.ckpt"]  # no temporary file left behind
    got = load_checkpoint(tmp_path / "a.ckpt")
    assert torch.equal(got["x"], torch.arange(3)) and got["n"] == 7
    ck = tmp_path / "checkpoints"
    assert step_checkpoints(ck) == [] and latest_checkpoint(ck) is None
    for steps in (9, 10, 100):
        save_checkpoint(ck / f"model_{steps}_steps.ckpt", {"n": steps})
    (ck / "model_x_steps.ckpt").write_bytes(b"")
    assert [p.name for p in step_checkpoints(ck)] == ["model_100_steps.ckpt", "model_10_steps.ckpt", "model_9_steps.ckpt"]
    assert latest_checkpoint(ck).name == "model_100_steps.ckpt"
    save_checkpoint(ck / "last.ckpt", {"n": 0})
    assert latest_checkpoint(ck).name == "last.ckpt"
