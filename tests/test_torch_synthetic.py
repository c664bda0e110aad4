"""The port's copy of the synthetic DIGIT generator (data/synthetic.py) against the JAX package's:
every array bit for bit from the same seed, then the package's own contract (label
recoverability, windowing, the force-field sample format) on the port's copy.
"""
import numpy as np
import pytest

from m3l_tpu.data import synthetic as jsyn
from m3l_tpu_torch.data import synthetic as syn


def assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, size=48), dict(seed=5, textures=4), dict(seed=7, size=32, slip_threshold=0.02)],
                         ids=["default", "size48", "textures", "threshold"])
def test_trajectories_bit_equal_by_seed(kw):
    assert_same(syn.synth_digit_trajectories(3, 12, **kw), jsyn.synth_digit_trajectories(3, 12, **kw))


@pytest.mark.parametrize("num_frames,stride,bins", [(2, 1, 10), (3, 2, 5)])
def test_windowed_probe_samples_bit_equal(num_frames, stride, bins):
    data = syn.synth_digit_trajectories(4, 10, size=32, seed=1, textures=3)
    assert_same(syn.windowed_probe_samples(data, num_frames, stride, bins), jsyn.windowed_probe_samples(data, num_frames, stride, bins))


@pytest.mark.parametrize("threshold", [0.05, 0.2])
def test_forcefield_windows_bit_equal(threshold):
    data = syn.synth_digit_trajectories(4, 10, size=32, seed=2)
    assert_same(syn.forcefield_windows(data, threshold), jsyn.forcefield_windows(data, threshold))


def test_render_frame_bit_equal():
    rng = np.random.default_rng(4)
    bg = rng.random((24, 24, 3)).astype(np.float32)
    for force in ([0.3, -0.2, 0.7], [0.0, 0.0, 0.0]):
        args = (bg, np.float32([0.4, 0.6]), np.float32(force), 24)
        np.testing.assert_array_equal(syn.render_frame(*args), jsyn.render_frame(*args))


def test_shapes_and_rates():
    d = syn.synth_digit_trajectories(10, 40, seed=0)
    assert d["frames"].shape == (400, 96, 96, 3) and d["frames"].dtype == np.uint8
    assert d["force"].shape == (400, 3)
    assert 0.05 < d["slip"].mean() < 0.7
    assert d["in_contact"].mean() > 0.5
    w = syn.windowed_probe_samples(d, 2)
    assert w["image"].shape[-1] == 6
    assert len(w["image"]) == 400 - 10  # windows never straddle trajectories


def test_slip_visible_in_two_frame_window():
    d = syn.synth_digit_trajectories(40, 40, seed=2)
    w = syn.windowed_probe_samples(d, 2)
    contact = w["in_contact"] > 0
    img = w["image"].astype(np.float32)
    diff = np.abs(img[..., 3:] - img[..., :3]).mean((1, 2, 3))
    assert diff[(w["slip"] == 1) & contact].mean() > 1.5 * diff[(w["slip"] == 0) & contact].mean()


def test_pose_and_grasp_labels():
    d = syn.synth_digit_trajectories(10, 40, seed=0)
    w = syn.windowed_probe_samples(d, 2, pose_bins=10)
    for h in ("pose_x", "pose_y", "pose_theta"):
        assert w[h].shape == (len(w["image"]),) and w[h].min() >= 0 and w[h].max() <= 9
    f = w["force"]
    np.testing.assert_array_equal(w["grasp"], ((f[:, 2] >= 0.45) & (w["slip"] == 0)).astype(np.int64))
    assert 0.1 < w["grasp"].mean() < 0.9
    assert (w["in_contact"][w["grasp"] == 1] == 1).all()


def test_forcefield_windows_format():
    """image = [frame_0, frame_{-1}], image_bg = [frame_0, background]; the contact mask covers
    the blob in contact and is localised."""
    d = syn.synth_digit_trajectories(5, 20, seed=2)
    w = syn.forcefield_windows(d)
    m = len(w["image"])
    assert m == 5 * 20 - 5
    assert w["image"].shape == w["image_bg"].shape == (m, 96, 96, 6) and w["image"].dtype == np.uint8
    np.testing.assert_array_equal(w["image"][..., :3], w["image_bg"][..., :3])
    idx = np.arange(1, 100)
    idx = idx[d["traj_id"][idx] == d["traj_id"][idx - 1]]
    np.testing.assert_array_equal(w["image"][..., 3:], d["frames"][idx - 1])
    frac = w["mask"].mean((1, 2))
    assert (frac[w["in_contact"] > 0.5] > 0.002).all() and frac.max() < 0.5
