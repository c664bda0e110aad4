"""The port's replay rings (m3l_tpu_torch.rl.replay) against the JAX package's on the CPU: one add
sequence with truncated episodes (made with numpy from a seed) goes into each ring, and the
same numpy seed samples them. Host rings store float32 obs as float16 and device rings as bf16,
in both packages with round-to-nearest, so every sample, done and next-obs substitution must
be equal, bit for bit; so must the checkpoint views and the timeout ring's wrap warning.
"""
import warnings

import numpy as np
import pytest
import torch
from gymnasium.spaces import Box as GBox, Dict as GDict

from m3l_tpu.rl.replay import DeviceReplayBuffer as JDeviceReplayBuffer, ReplayBuffer as JReplayBuffer
from m3l_tpu_torch.envs.spaces import Box, Dict
from m3l_tpu_torch.rl.replay import DeviceReplayBuffer, ReplayBuffer, _ring_indices

N_ENVS = 2


def spaces():
    shapes = {"image": ((8, 8, 3), np.uint8, 0, 255), "tactile": ((2, 4, 4), np.float32, -np.inf, np.inf)}
    return (GDict({k: GBox(lo, hi, s, d) for k, (s, d, lo, hi) in shapes.items()}),
            Dict({k: Box(lo, hi, s, d) for k, (s, d, lo, hi) in shapes.items()}))


def roll(buf, n_steps, seed=0, horizon=7):
    """Adds with random dones and a truncation every ``horizon`` steps of an episode."""
    rng = np.random.default_rng(seed)
    t_in_ep = np.zeros(N_ENVS, int)
    for _ in range(n_steps):
        obs = {"image": rng.integers(0, 255, (N_ENVS, 8, 8, 3), dtype=np.uint8),
               "tactile": rng.normal(size=(N_ENVS, 2, 4, 4)).astype(np.float32)}
        actions = rng.normal(size=(N_ENVS, 3)).astype(np.float32)
        rewards = rng.normal(size=(N_ENVS,)).astype(np.float32)
        t_in_ep += 1
        dones = (t_in_ep >= horizon) | (rng.random(N_ENVS) < 0.05)
        infos = []
        for e in range(N_ENVS):
            info = {}
            if dones[e] and t_in_ep[e] >= horizon:
                info["TimeLimit.truncated"] = True
                info["terminal_observation"] = {"image": rng.integers(0, 255, (8, 8, 3), dtype=np.uint8),
                                                "tactile": rng.normal(size=(2, 4, 4)).astype(np.float32)}
            infos.append(info)
        t_in_ep[dones] = 0
        buf.add(obs, actions, rewards, dones.astype(np.float32), infos)


def numpy_batch(batch):
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else np.asarray(v) for k, v in batch.items()}


def assert_batches_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in ("actions", "rewards", "dones"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    for key in ("obs", "next_obs"):
        for k in ("image", "tactile"):
            assert ours[key][k].dtype == theirs[key][k].dtype
            np.testing.assert_array_equal(ours[key][k], theirs[key][k], err_msg=f"{key}/{k}")


@pytest.mark.parametrize("device_ring", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("steps", [12, 40], ids=["filling", "wrapped"])
def test_ring_samples_the_same_transitions_as_jax(device_ring, steps):
    gspace, space = spaces()
    if device_ring:
        theirs, ours = JDeviceReplayBuffer(30 * N_ENVS, N_ENVS, gspace, 3, timeout_capacity=64), \
            DeviceReplayBuffer(30 * N_ENVS, N_ENVS, space, 3, timeout_capacity=64, device="cpu")
    else:
        theirs, ours = JReplayBuffer(30 * N_ENVS, N_ENVS, gspace, 3), ReplayBuffer(30 * N_ENVS, N_ENVS, space, 3)
    roll(theirs, steps)
    roll(ours, steps)
    assert (len(ours), ours.pos, ours.full) == (len(theirs), theirs.pos, theirs.full) == (len(ours), steps % 30, steps > 30)
    ob = numpy_batch(ours.sample(64, np.random.default_rng(7)))
    tb = numpy_batch(theirs.sample(64, np.random.default_rng(7)))
    assert_batches_equal(ob, tb)
    assert ob["obs"]["tactile"].dtype == np.float32 and ob["obs"]["image"].dtype == np.uint8
    # the comparison is not vacuous: some truncated transitions were drawn, whose next obs is
    # the stored terminal obs, and their done flag is cleared
    idx, env_idx = _ring_indices(ours.full, ours.pos, ours.capacity, N_ENVS, 64, np.random.default_rng(7), "ring")
    truncated = np.asarray(ours.timeouts)[idx, env_idx] > 0
    assert truncated.any() and (ob["dones"][truncated] == 0).all()
    # checkpoint views: numpy, obs at their shapes (bf16 storage cast to float32)
    for name in ("actions", "rewards", "dones", "timeouts"):
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(theirs, name)), err_msg=name)
    for k, v in ours.obs.items():
        np.testing.assert_array_equal(v, np.asarray(theirs.obs[k]), err_msg=k)
        assert v.shape == (30, N_ENVS) + space[k].shape


def test_device_ring_matches_the_host_ring_up_to_storage_precision():
    _, space = spaces()
    host, dev = ReplayBuffer(30 * N_ENVS, N_ENVS, space, 3), DeviceReplayBuffer(30 * N_ENVS, N_ENVS, space, 3, timeout_capacity=64, device="cpu")
    roll(host, 40)
    roll(dev, 40)
    hb = host.sample(64, np.random.default_rng(3))
    db = numpy_batch(dev.sample(64, np.random.default_rng(3)))
    for k in ("actions", "rewards", "dones"):
        np.testing.assert_array_equal(hb[k], db[k])
    for key in ("obs", "next_obs"):
        np.testing.assert_array_equal(hb[key]["image"], db[key]["image"])
        np.testing.assert_allclose(hb[key]["tactile"], db[key]["tactile"], rtol=2e-2, atol=2e-2)  # float16 vs bf16


def test_gather_of_given_indices_is_the_sample():
    _, space = spaces()
    dev = DeviceReplayBuffer(30 * N_ENVS, N_ENVS, space, 3, timeout_capacity=64, device="cpu")
    roll(dev, 40)
    idx, env_idx = dev.sample_indices(16, np.random.default_rng(5))
    a, b = dev.gather(idx, env_idx), dev.sample(16, np.random.default_rng(5))
    assert all(torch.equal(a[k], b[k]) for k in ("actions", "rewards", "dones"))
    assert all(torch.equal(a[key][k], b[key][k]) for key in ("obs", "next_obs") for k in a[key])


def test_timeout_ring_wrap_warns_as_jax_does():
    """A timeout ring of 2 slots wraps onto live transitions; both packages warn alike."""
    gspace, space = spaces()
    messages = []
    for buf in (JDeviceReplayBuffer(30 * N_ENVS, N_ENVS, gspace, 3, timeout_capacity=2),
                DeviceReplayBuffer(30 * N_ENVS, N_ENVS, space, 3, timeout_capacity=2, device="cpu")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            roll(buf, 40)
        messages.append([str(w.message) for w in caught if issubclass(w.category, RuntimeWarning) and "timeout ring" in str(w.message)])
    assert messages[0] and messages[0] == messages[1]


@pytest.mark.parametrize("device_ring", [False, True], ids=["host", "device"])
def test_sample_needs_two_written_slots(device_ring):
    _, space = spaces()
    buf = DeviceReplayBuffer(10, 1, space, 3, device="cpu") if device_ring else ReplayBuffer(10, 1, space, 3)
    with pytest.raises(ValueError, match="two written time slots"):
        buf.sample(4, np.random.default_rng(0))
    obs = {"image": np.zeros((1, 8, 8, 3), np.uint8), "tactile": np.zeros((1, 2, 4, 4), np.float32)}
    buf.add(obs, np.zeros((1, 3)), np.zeros(1), np.zeros(1), [{}])
    with pytest.raises(ValueError, match="two written time slots"):
        buf.sample(4, np.random.default_rng(0))
    buf.add(obs, np.zeros((1, 3)), np.zeros(1), np.zeros(1), [{}])
    assert len(buf.sample(4, np.random.default_rng(0))["rewards"]) == 4


def test_box_sample_draws_uniformly_inside_the_bounds():
    box = Box(-1.0, 1.0, (3,), np.float32)
    a, b = box.sample(np.random.default_rng(0)), box.sample(np.random.default_rng(0))
    np.testing.assert_array_equal(a, b)
    draws = np.stack([box.sample(np.random.default_rng(s)) for s in range(200)])
    assert draws.dtype == np.float32 and draws.shape == (200, 3)
    assert (np.abs(draws) <= 1).all() and draws.min() < -0.9 and draws.max() > 0.9
    with pytest.raises(ValueError, match="bounded"):
        Box(-np.inf, np.inf, (2,), np.float32).sample(np.random.default_rng(0))
