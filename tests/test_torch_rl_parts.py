"""The small parts of the port's PPO+MAE update against the JAX package on the CPU: GAE, flat
Adam, the reward normalizer, the rollout buffer and the env stack.

Tolerances: GAE at rtol/atol 1e-5 (the same f32 recurrences); flat Adam at rtol/atol 2e-6
after several steps (tests/test_optim.py's bound; the global norm sums in another order);
the reward normalizer and the env stack exactly (the same numpy code).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.envs import SyncVecEnv as JSyncVecEnv, make_env as jmake_env
from m3l_tpu.rl.gae import compute_gae as jcompute_gae
from m3l_tpu.rl.vecnorm import RewardNormalizer as JRewardNormalizer
from m3l_tpu.train.optim import flat_adam as jflat_adam
from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.rl import RewardNormalizer, RolloutBuffer, compute_gae
from m3l_tpu_torch.train import FlatAdam


def test_gae_golden_value():
    """tests/test_golden.py::test_gae_golden_value's hand-computed case."""
    adv, ret = compute_gae(torch.tensor([[1.0], [0.0], [2.0]]), torch.full((3, 1), 0.5), torch.zeros(3, 1),
                           torch.tensor([1.0]), torch.tensor([0.0]), gamma=0.9, gae_lambda=0.8)
    np.testing.assert_allclose(adv[:, 0].numpy(), [2.15816, 1.678, 2.4], rtol=1e-5)
    np.testing.assert_allclose(ret.numpy(), adv.numpy() + 0.5, rtol=1e-6)


def test_gae_matches_jax_with_episode_starts():
    rng = np.random.default_rng(0)
    t, e = 32, 4
    arrays = [rng.normal(size=(t, e)), rng.normal(size=(t, e)), rng.random((t, e)) < 0.1, rng.normal(size=e), rng.random(e) < 0.3]
    arrays = [np.asarray(a, np.float32) for a in arrays]
    jadv, jret = jcompute_gae(*(jnp.asarray(a) for a in arrays), 0.99, 0.95)
    adv, ret = compute_gae(*(torch.from_numpy(a) for a in arrays), 0.99, 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clip", [None, 0.5, 1e6])
def test_flat_adam_matches_jax(clip):
    """Several steps from the same params and gradients; clip 0.5 is active, 1e6 is not."""
    rng = np.random.default_rng(1)
    shapes = [(17, 33), (33,), (5,), (8, 16, 3)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = jflat_adam(1e-3, eps=1e-5, max_grad_norm=clip)
    jparams = [jnp.asarray(a) for a in init]
    state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = FlatAdam(params, 1e-3, eps=1e-5, max_grad_norm=clip)
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jparams)
        jparams = [p + u for p, u in zip(jparams, upd)]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=2e-6, atol=2e-6)
    assert opt.count == 5


def test_flat_adam_schedule_reads_the_pre_increment_count():
    seen = []
    p = torch.nn.Parameter(torch.ones(3))
    opt = FlatAdam([p], lambda count: seen.append(count) or 1e-3)
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
    assert seen == [0, 1, 2]
    # a parameter without a gradient counts zeros and does not move
    q = torch.nn.Parameter(torch.ones(2))
    opt = FlatAdam([p, q], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(q.detach(), torch.ones(2))


def test_reward_normalizer_matches_jax():
    rng = np.random.default_rng(2)
    ours, theirs = RewardNormalizer(3), JRewardNormalizer(3)
    for _ in range(40):
        r = (rng.normal(size=3) * 5).astype(np.float32)
        d = rng.random(3) < 0.1
        np.testing.assert_array_equal(ours(r.copy(), d), theirs(r.copy(), d))


def test_env_stack_matches_jax():
    """make_env + FrameStack + SyncVecEnv: the same obs, rewards, dones and infos for the same
    seeds and actions, through episode ends (horizon 300) and auto-resets."""
    fs, n_envs = 2, 2
    ours = SyncVecEnv([make_env("FakeInsertion", i, seed=3, frame_stack=fs) for i in range(n_envs)])
    theirs = JSyncVecEnv([jmake_env("FakeInsertion", i, 3, frame_stack=fs) for i in range(n_envs)])
    assert ours.observation_space.spaces.keys() == theirs.observation_space.spaces.keys()
    for k, sp in ours.observation_space.spaces.items():
        ref = theirs.observation_space[k]
        assert sp.shape == ref.shape and sp.dtype == ref.dtype
        np.testing.assert_array_equal(sp.low, ref.low)
    np.testing.assert_array_equal(ours.action_space.low, theirs.action_space.low)
    o1, o2 = ours.reset(), theirs.reset()
    for k in o2:
        np.testing.assert_array_equal(o1[k], o2[k])
    rng = np.random.default_rng(4)
    episodes = 0
    for _ in range(310):
        a = rng.uniform(-1, 1, (n_envs, 3)).astype(np.float32)
        (o1, r1, d1, i1), (o2, r2, d2, i2) = ours.step(a), theirs.step(a)
        for k in o2:
            np.testing.assert_array_equal(o1[k], o2[k])
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
        for a_info, b_info in zip(i1, i2):
            assert a_info.keys() == b_info.keys()
            if "episode" in b_info:
                episodes += 1
                assert a_info["episode"] == b_info["episode"]
                assert a_info["TimeLimit.truncated"] == b_info["TimeLimit.truncated"]
                for k in b_info["terminal_observation"]:
                    np.testing.assert_array_equal(a_info["terminal_observation"][k], b_info["terminal_observation"][k])
    assert episodes >= n_envs
    with pytest.raises(ValueError, match="not ported"):
        make_env("Door", 0)


def test_rollout_buffer_keeps_uint8_on_the_device():
    env = SyncVecEnv([make_env("FakeInsertion", i, frame_stack=2) for i in range(2)])
    buf = RolloutBuffer(3, 2, env.observation_space, 3)
    obs = env.reset(seed=0)
    for t in range(3):
        buf.add(obs, np.full((2, 3), t, np.float32), np.ones(2), np.zeros(2), np.ones(2) * t, np.zeros(2))
    assert buf.full
    data = buf.to_device(torch.device("cpu"))
    assert data["obs"]["image"].dtype == torch.uint8 and data["obs"]["image"].shape == (6, 2, 64, 64, 3)
    assert data["obs"]["tactile"].shape == (6, 2, 6, 32, 32)
    np.testing.assert_array_equal(data["values"].numpy(), [0, 0, 1, 1, 2, 2])
