"""The port's SAC+MAE gradient step (m3l_tpu_torch.rl.sac_mae) against JAX ``SACMAE._update_step``
on the CPU, and the port's fused steps, learn loop and checkpoints.

Both sides start from the same weights (the JAX policy's, carried by load_jax_params, after the
JAX SACMAE set its entropy coefficient and copied the critic into the target) and take one step
on the same replay batch (numpy, seeded). The MAE mask is one realisation tiled over the batch,
patched into the JAX side's ``random_modal_masking`` (as tests/test_torch_train_phase.py does)
and handed to the port once per MAE chunk; the policy and next-action noise are the numbers
``jax.random.normal`` draws from ``k_pi`` and ``k_next`` of ``jax.random.split(key, 3)``.
Compared: every metric (rtol 2e-4 / atol 2e-5, convolutions on the path) and all five
parameter groups after the step (MAE, actor heads with ``features.post``, critic, target,
``log_ent_coef``), after carrying the JAX ones into a fresh port policy.

Parameters are compared through the gradients their Adam took. An Adam step from zero moments
is lr * g / (|g| + eps), eps 1e-8: a gradient within a few hundred eps of zero (there are such
elements in every group, where a sum cancels) turns f32 noise into a large part of lr (measured:
g = 1.24e-7, steps 0.02 lr apart; g ~ 1e-8, steps ~1 lr apart). So (a) each gradient is held
to the JAX one at rtol 2e-4 plus atol 1e-4 of its tensor's largest gradient (f32 summation
noise at that tensor's scale), and (b) each parameter at atol 1e-2 * lr beyond the step
difference lr * |q(g_port) - q(g_jax)|, q(g) = g / (|g| + eps), that (a)'s gradients imply; the
separate MAE Adam's two chunk steps, and the polyak move of the target, at 1e-2 * lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m3l_tpu.models.vtmae as jvtmae_module
from m3l_tpu.envs import SyncVecEnv as JSyncVecEnv, make_env as jmake_env
from m3l_tpu.ops.masking import ModalMask as JModalMask
from m3l_tpu.rl import SACMAE as JSACMAE
from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.ops.masking import mask_from_indices
from m3l_tpu_torch.rl import SACMAE
from m3l_tpu_torch.rl.replay import DeviceReplayBuffer
from m3l_tpu_torch.utils.convert import load_jax_params

from test_torch_sac_policy import FS, flat_state, jax_sac_policy, port_sac_policy, random_obs
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_ENVS, BATCH, MAE_BATCH, LR = 2, 8, 4, 3e-4
TOL = dict(rtol=2e-4, atol=2e-5)


def port_env(n=N_ENVS):
    return SyncVecEnv([make_env("FakeInsertion", i, frame_stack=FS) for i in range(n)])


def replay_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": random_obs(rng, BATCH),
        "next_obs": random_obs(rng, BATCH),
        "actions": rng.uniform(-1, 1, (BATCH, 3)).astype(np.float32),
        "rewards": rng.normal(size=BATCH).astype(np.float32),
        "dones": (rng.random(BATCH) < 0.3).astype(np.float32),
    }


def mask_realisation(batch, seed=0):
    """The reference's mask counts for 192 tokens (image, two tactile sensors), tiled over the batch."""
    rng = np.random.default_rng(seed)
    ms, us, off = [], [], 0
    for n, m in zip([64, 64, 64], [60, 61, 61]):
        perm = rng.permutation(n) + off
        ms.append(perm[:m])
        us.append(perm[m:])
        off += n
    return tuple(np.tile(np.concatenate(p)[None], (batch, 1)) for p in (ms, us))


def port_grads(model: SACMAE) -> dict:
    """The gradient each parameter's single-step Adam (actor, critic, entropy) took, by name:
    one step from zero moments leaves mu = (1 - b1) g. Parameters of none are absent."""
    names = {id(p): n for n, p in model.policy.named_parameters()}
    out = {}
    for opt in (model.actor_optimizer, model.critic_optimizer, model.ent_optimizer):
        g, off = opt.mu / (1.0 - opt.b1), 0
        for p in opt.params:
            out[names[id(p)]] = g[off : off + p.numel()].view_as(p)
            off += p.numel()
    return out


def jax_grads(states: list, like: dict) -> dict:
    """The same from the JAX step's flat Adam states, unravelled to their parameter trees and
    carried into a port policy's layout (the target, which no Adam covers, as zeros)."""
    from jax.flatten_util import ravel_pytree

    mae_p, _, crit_p, ent_p, actor_p, actor_opt, critic_opt, ent_opt = states[:8]
    flat = {k: np.zeros_like(v) for k, v in like.items() if k.startswith("critic_target")}
    for tree, opt in (((actor_p, mae_p), actor_opt), ((crit_p,), critic_opt), ((ent_p,), ent_opt)):
        flat.update({k: v / 0.1 for k, v in flat_state(*ravel_pytree(tree)[1](opt.mu)).items()})
    carried = port_sac_policy()
    load_jax_params(carried, flat)
    return {n: p.detach() for n, p in carried.named_parameters() if not n.startswith("critic_target")}


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
@pytest.mark.parametrize("ent_coef", ["auto", "0.2"])
def test_update_matches_jax(monkeypatch, separate, ent_coef):
    def jmask(key, b, sizes, m):
        masked, kept = mask_realisation(b)
        restore = np.argsort(np.concatenate([kept, masked], axis=1), axis=1)
        return JModalMask(*(jnp.asarray(a, jnp.int32) for a in (masked, kept, restore)))

    monkeypatch.setattr(jvtmae_module, "random_modal_masking", jmask)
    kw = dict(learning_rate=LR, buffer_size=64, batch_size=BATCH, mae_batch_size=MAE_BATCH, separate_optimizer=separate,
              ent_coef=ent_coef if ent_coef == "auto" else float(ent_coef), frame_stack=FS)
    jenv = JSyncVecEnv([jmake_env("FakeInsertion", i, 0, frame_stack=FS) for i in range(N_ENVS)])
    jmodel = JSACMAE(jax_sac_policy(), jenv, **kw)
    groups = ("mae_params", "target_params", "critic_params", "ent_params", "actor_params")
    init = flat_state(*(getattr(jmodel, g) for g in groups))  # _update_step donates these
    tp = port_sac_policy()
    load_jax_params(tp, init)
    start = {n: p.detach().clone() for n, p in tp.named_parameters()}
    model = SACMAE(tp, port_env(), device="cpu", **kw)
    for n, p in model.policy.named_parameters():  # the port's own init agrees with the JAX one
        np.testing.assert_array_equal(p.detach().numpy(), start[n].numpy(), err_msg=n)

    batch = replay_batch()
    key = jax.random.PRNGKey(0)
    _, k_pi, k_next = jax.random.split(key, 3)
    noise = [torch.from_numpy(np.array(jax.random.normal(k, (BATCH, 3), jnp.float32))) for k in (k_pi, k_next)]
    *states, jmetrics = jmodel._update_step(
        *(getattr(jmodel, g) for g in groups), jmodel.actor_opt, jmodel.critic_opt, jmodel.ent_opt, jmodel.mae_opt,
        jax.tree.map(jnp.asarray, batch), key,
    )
    masked, kept = (torch.from_numpy(a) for a in mask_realisation(MAE_BATCH if separate else BATCH))
    masks = [mask_from_indices(masked, kept)] * (BATCH // MAE_BATCH if separate else 1)
    tbatch = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(v)
              for k, v in batch.items()}
    metrics = {k: float(v) for k, v in model.update(tbatch, masks, *noise).items()}

    assert metrics.keys() == jmetrics.keys()
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], float(v), err_msg=k, **TOL)
    carried = port_sac_policy()
    load_jax_params(carried, flat_state(*states[:5]))
    expected = dict(carried.named_parameters())
    ours, theirs = port_grads(model), jax_grads(states, init)
    assert ours.keys() == theirs.keys()
    eps = model.actor_optimizer.eps

    def q(g):
        return g / (g.abs() + eps)

    for name, p in model.policy.named_parameters():
        tol = torch.full_like(p, 1e-2 * LR)
        if name in ours:
            g, gj = ours[name], theirs[name]
            gtol = 2e-4 * gj.abs() + 1e-4 * gj.abs().max()
            assert ((g - gj).abs() <= gtol).all(), f"{name}: gradient off by {(g - gj).abs().max().item()} (max |g| {gj.abs().max().item()})"
            tol += LR * (q(g) - q(gj)).abs()
        diff = (p.detach() - expected[name].detach()).abs()
        assert (diff <= tol).all(), f"{name}: parameter off by {diff.max().item() / LR} lr"
    moved = {n: (p.detach() - start[n]).abs().max().item() for n, p in model.policy.named_parameters()}
    # not vacuous: Adam moves every trained group by ~lr; the target by tau toward the critic
    assert moved["actor.mu.weight"] > LR / 2 and moved["critic.qs.0.head.weight"] > LR / 2
    assert (moved["features.mae.encoder.transformer.norm.weight"] > LR / 2) and (moved["log_ent_coef"] > LR / 2) == (ent_coef == "auto")
    assert 0 < moved["critic_target.qs.0.head.weight"] < LR
    # separate mode: the actor's stop-gradient features leave features.post and its Adam moments at zero
    assert (moved["features.post.norm.weight"] == 0) == separate


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
def test_fused_train_steps_equal_single_steps(separate):
    """train_steps(n) on a device ring (on the CPU) equals n updates on the same indices, drawn
    by one host draw of n * batch, with the same randomness."""
    torch.manual_seed(0)
    init = port_sac_policy().state_dict()
    models = []
    for _ in range(2):
        p = port_sac_policy()
        p.load_state_dict(init)
        m = SACMAE(p, port_env(), batch_size=BATCH, mae_batch_size=MAE_BATCH, separate_optimizer=separate, frame_stack=FS,
                   device_buffer=True, buffer_size=64, learning_starts=0, seed=3, device="cpu")
        m.learn(total_timesteps=2 * 4)  # fills 4 slots of the ring, the last add allowing one update
        models.append(m)
    fused, single = models
    assert fused.actor_optimizer.count == single.actor_optimizer.count == 1
    fused_metrics = fused.train_steps(3)
    idx, env_idx = single.buffer.sample_indices(3 * BATCH, single._np_rng)
    for i in range(3):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        metrics = single.update(single.buffer.gather(idx[sl], env_idx[sl]), *single.sample_randomness())
    assert fused_metrics == {k: float(v) for k, v in metrics.items()}
    for (n, a), b in zip(fused.policy.named_parameters(), single.policy.parameters()):
        assert torch.equal(a, b), n
    assert fused.actor_optimizer.count == single.actor_optimizer.count == 1 + 3
    assert isinstance(fused.buffer, DeviceReplayBuffer)


@pytest.mark.parametrize("device_buffer", [False, True], ids=["host-ring", "device-ring"])
def test_learn_save_load_and_predict(tmp_path, device_buffer):
    torch.manual_seed(1)
    model = SACMAE(port_sac_policy(), port_env(), batch_size=BATCH, mae_batch_size=MAE_BATCH, frame_stack=FS,
                   learning_starts=8, gradient_steps=2, buffer_size=64, device_buffer=device_buffer, device="cpu")
    before = [p.detach().clone() for p in model.policy.parameters()]
    model.learn(total_timesteps=24)
    assert model.num_timesteps == 24 and model._n_updates == 2 * 9  # a train event at 8, 10, ..., 24 steps
    m = model.last_metrics
    for k in ("mae_loss", "ent_coef", "ent_coef_loss", "critic_loss", "actor_loss"):
        assert np.isfinite(m[k]), k
    assert any((p.detach() - b).abs().max() > 0 for p, b in zip(model.policy.parameters(), before))

    path = str(tmp_path / "sac.ckpt")
    model.save(path)
    fresh = SACMAE(port_sac_policy(), port_env(), batch_size=BATCH, mae_batch_size=MAE_BATCH, frame_stack=FS,
                   device_buffer=device_buffer, buffer_size=64, device="cpu")
    fresh.load(path)
    assert fresh.num_timesteps == 24
    assert all(torch.equal(a, b) for a, b in zip(fresh.policy.parameters(), model.policy.parameters()))
    for name, opt in model._optimizers().items():
        got = fresh._optimizers()[name]
        assert got.count == opt.count and torch.equal(got.mu, opt.mu) and torch.equal(got.nu, opt.nu), name
    np.testing.assert_array_equal(fresh.reward_normalizer.returns, model.reward_normalizer.returns)

    obs = model.env.reset(seed=0)
    det = model.predict(obs)
    np.testing.assert_array_equal(det, fresh.predict(obs))
    sampled = model.predict(obs, deterministic=False)
    assert det.shape == sampled.shape == (N_ENVS, 3) and (np.abs(det) <= 1).all() and (np.abs(sampled) <= 1).all()
    assert not np.array_equal(det, sampled)


def test_warmup_actions_come_from_the_action_space():
    model = SACMAE(port_sac_policy(), port_env(), batch_size=BATCH, learning_starts=100, frame_stack=FS, device="cpu")
    obs = model.env.reset(seed=0)
    a = np.stack([model._act(obs) for _ in range(50)])
    assert a.shape == (50, N_ENVS, 3) and a.dtype == np.float32 and (np.abs(a) <= 1).all() and a.std() > 0.4
    assert model.train_steps(1) == {}  # the ring is empty: no step


@pytest.mark.parametrize("separate", [True, False], ids=["separate", "joint"])
def test_sac_f32_check_sees_a_dropped_key(separate):
    """chip_smoke.py holds one f32 SAC step on the card to SAC_F32_TOL of the CPU's. Two CPU runs
    of the same step agree exactly; one key left out of every attention layer moves the losses
    and the gradients past it. The parameter measure subtracts the step difference the two
    gradients imply, so it holds each side to Adam's step on its own gradient (a residual of about
    one ulp of the parameters) and is not what sees a wrong gradient."""
    from chip_smoke import SAC_F32_TOL, sac_update_errors

    torch.manual_seed(0)
    init = port_sac_policy().state_dict()

    def model(drop_last_key=False):
        p = port_sac_policy()
        p.load_state_dict(init)
        for attn in (m for m in p.modules() if drop_last_key and type(m).__name__ == "Attention"):
            def drop(x, key_mask=None, forward=attn.forward):
                keep = torch.ones(x.shape[:2], dtype=torch.bool)
                keep[:, -1] = False
                return forward(x, keep)
            attn.forward = drop
        return SACMAE(p, port_env(1), batch_size=BATCH, mae_batch_size=BATCH, separate_optimizer=separate, frame_stack=FS,
                      buffer_size=64, device="cpu")

    same = sac_update_errors(model(), model())
    assert same["loss_rel"] == 0 and max(same["grad_rel"].values()) == 0 and max(same["param_per_lr"].values()) == 0
    dropped = sac_update_errors(model(True), model())
    assert dropped["loss_rel"] > SAC_F32_TOL["loss_rel"], dropped
    assert max(dropped["grad_rel"].values()) > SAC_F32_TOL["grad_rel"], dropped
    assert max(dropped["param_per_lr"].values()) <= SAC_F32_TOL["param_per_lr"], dropped
