"""The port's flat-buffer AdamW and its remaining host-side modules against the JAX package on the
CPU: ``train/optim.py`` ``FlatAdamW`` (and the SSL module's ``flat`` opt-in), ``nn/gumbel_vq.py``,
``utils/misc.py``, ``data/sensors.py`` and ``train/distributed.py``.

* ``FlatAdamW`` against JAX's ``flat_adamw`` over five steps with lr and wd schedules, the
  gradients fed to both (1e-6); the whole SSL optimizer, ``default_wd_split_optimizer(flat=True)``
  with and without clipping, against JAX's; and against the port's ``WDSplitAdamW``, the same
  updates up to rounding order (1e-6 of the learning rate).
* The quantizer with JAX's uniform draws passed in: hard and soft training and eval, outputs and
  the straight-through gradients at 1e-5 (softmax of a projection in f32).
* The quaternion helpers at 1e-6; the sensor loaders and datasets on in-test buffers with the
  same seed: equal arrays (both sides are numpy and cv2).
"""
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import m3l_tpu.data as jdata
import m3l_tpu_torch.data as tdata
from jax_params import mae_pair, images, t
from m3l_tpu.nn import GumbelVectorQuantizer as JGumbel
from m3l_tpu.ssl.module import default_wd_split_optimizer as j_default_optimizer
from m3l_tpu.train.optim import flat_adamw
from m3l_tpu.utils import misc as jmisc
from m3l_tpu_torch.nn import GumbelVectorQuantizer
from m3l_tpu_torch.ssl import WDSplitAdamW, default_wd_split_optimizer
from m3l_tpu_torch.train import FlatAdamW, Trainer, get_local_rank, get_world_size, initialize_distributed, is_main_process, slurm_requeue
from m3l_tpu_torch.utils import misc as tmisc
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
# FlatAdamW against torch's AdamW from the same gradients: the same update, but torch rounds the
# parameter twice (p (1 - lr wd), then + the step) where the flat update rounds it once, so up to
# two f32 ulps of |p| an update; and the step itself to ~1e-6 of the learning rate (``lr_max``)
def split_tol(lr_max: float, updates: int) -> dict:
    return dict(rtol=2 * float(np.finfo(np.float32).eps) * updates, atol=1e-6 * lr_max * updates)
SHAPES = {"b": (33,), "kernel": (8, 16, 3), "scale": (5,), "w": (17, 33)}  # sorted: JAX ravels a dict by key


def tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def torch_params(values: dict) -> list:
    return [torch.nn.Parameter(torch.tensor(values[k])) for k in SHAPES]


def step_both(tx, params, state, opt, tparams, grads):
    """One JAX update and one port step from the same gradients."""
    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    for p, k in zip(tparams, SHAPES):
        p.grad = torch.tensor(grads[k])
    opt.step()
    opt.zero_grad()
    return params, state


def assert_params(tparams, params):
    for p, k in zip(tparams, SHAPES):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), **OPT_TOL)


def test_flat_adamw_matches_jax_with_schedules():
    lr = optax.linear_schedule(1e-3, 1e-4, transition_steps=10)
    wd = optax.linear_schedule(0.04, 0.02, transition_steps=10)
    params = {k: jnp.asarray(v) for k, v in tree(0).items()}
    tx = flat_adamw(lr, wd, b1=0.9, b2=0.95)
    state = tx.init(params)
    tparams = torch_params(tree(0))
    opt = FlatAdamW(tparams, lambda c: float(lr(c)), lambda c: float(wd(c)), betas=(0.9, 0.95))
    for step in range(5):
        params, state = step_both(tx, params, state, opt, tparams, tree(10 + step))
        assert_params(tparams, params)
    np.testing.assert_allclose(opt.mu.numpy(), np.asarray(state.mu), **OPT_TOL)
    np.testing.assert_allclose(opt.nu.numpy(), np.asarray(state.nu), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(opt.mask.numpy(), np.asarray(state.wd_mask))
    assert opt.count == int(state.count) == 5


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_flat_ssl_optimizer_matches_jax(clip_norm):
    """``default_wd_split_optimizer(flat=True)``: warm-up cosine lr, cosine wd, the flat AdamW
    behind ``clip_by_global_norm`` when ``clip_norm`` is set, in both packages."""
    kw = dict(base_lr=1e-3, total_steps=8, steps_per_epoch=2, warmup_epochs=1, weight_decay=0.04, final_weight_decay=0.4,
              betas=(0.9, 0.95), clip_norm=clip_norm, flat=True)
    params = {k: jnp.asarray(v) for k, v in tree(1).items()}
    tx = j_default_optimizer(**kw)
    state = tx.init(params)
    tparams = torch_params(tree(1))
    opt = default_wd_split_optimizer(tparams, **kw)
    assert isinstance(opt, FlatAdamW) and opt.clip_norms == (() if clip_norm is None else (clip_norm,))
    for step in range(4):
        params, state = step_both(tx, params, state, opt, tparams, tree(20 + step))
        assert_params(tparams, params)


@pytest.mark.parametrize("every_k,clip", [(1, ()), (1, (0.5,)), (2, (0.5,))])
def test_flat_adamw_matches_wd_split_adamw(every_k, clip):
    """The same updates up to rounding order, through the chain's clipping and accumulation."""
    lr, wd = (lambda c: 1e-3 * (1 + c) / 4), (lambda c: 0.04 + 0.01 * c)
    a, b = torch_params(tree(2)), torch_params(tree(2))
    flat = FlatAdamW(a, lr, wd, betas=(0.9, 0.95), clip_norms=clip, every_k=every_k)
    split = WDSplitAdamW(b, lr, wd, betas=(0.9, 0.95), clip_norms=clip, every_k=every_k)
    for step in range(6):
        for opt, ps in ((flat, a), (split, b)):
            for p, k in zip(ps, SHAPES):
                p.grad = torch.tensor(tree(30 + step)[k])
            assert opt.step() == ((step + 1) % every_k == 0)
            opt.zero_grad()
        for p, q in zip(a, b):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **split_tol(1e-3 * 6 / 4, flat.count))
    assert flat.count == split.count == 6 // every_k


def test_flat_adamw_parameters_are_views_of_one_buffer_and_state_round_trips():
    ps = torch_params(tree(3))
    opt = FlatAdamW(ps, 1e-3, 0.04)
    assert all(p.untyped_storage().data_ptr() == opt.flat.untyped_storage().data_ptr() for p in ps)
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    saved = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in opt.state_dict().items()}
    fresh = FlatAdamW(torch_params(tree(3)), 1e-3, 0.04)
    fresh.load_state_dict(saved)
    assert fresh.count == 1 and torch.equal(fresh.mu, opt.mu) and torch.equal(fresh.nu, opt.nu)
    with pytest.raises(TypeError, match="float32"):
        FlatAdamW([torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))], 1e-3, 0.0)


def test_ssl_module_flat_opt_in(tmp_path):
    """A module with ``_flat_optimizer`` set trains through the Trainer with FlatAdamW (as JAX's
    ``scripts/bench_ssl.py`` opts in), to the parameters the default AdamW reaches, and resumes
    its flat moments from ``last.ckpt``. Two steps: both optimizers see the same gradients while
    the parameters are equal (step 0 has lr 0 under the warm-up); a third would feed each its own
    f32 noise, which Adam's normalised step amplifies where a gradient is near zero (the qkv
    bias's key third is zero analytically)."""
    batches = [{"image": images((2, 32, 32, 3), seed=s)} for s in range(2)]
    out = {}
    for flat in (False, True):
        _, module = mae_pair()
        module._flat_optimizer = flat
        before = {k: v.detach().clone() for k, v in module.state_dict().items()}
        trainer = Trainer(max_epochs=1, ckpt_dir=str(tmp_path / str(flat)), device="cpu", verbose=0, log_every_n_steps=100)
        trainer.fit(module, batches, steps_per_epoch=2)
        out[flat] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        assert max((out[flat][k] - v).abs().max().item() for k, v in before.items()) > 0
    assert isinstance(mae_pair()[1].configure_optimizer(2, 1), WDSplitAdamW)
    for k, v in out[False].items():
        np.testing.assert_allclose(out[True][k].numpy(), v.numpy(), **split_tol(1e-4, 1), err_msg=k)
    _, module = mae_pair()
    module._flat_optimizer = True
    optimizer = module.configure_optimizer(2, 1)
    assert isinstance(optimizer, FlatAdamW)
    resumed = Trainer(max_epochs=1, ckpt_dir=str(tmp_path / "True"), device="cpu", verbose=0)
    assert resumed._try_resume(module, optimizer)
    saved = torch.load(tmp_path / "True" / "last.ckpt", weights_only=False)["opt"]
    assert optimizer.count == 2 and torch.equal(optimizer.mu, saved["mu"]) and torch.equal(optimizer.nu, saved["nu"])


# --------------------------------------------------------------------------------------------- #
# the Gumbel vector quantizer
# --------------------------------------------------------------------------------------------- #
VQ = dict(num_vars=8, groups=2, vq_dim=8)


def vq_pair(**kw):
    j = JGumbel(16, rngs=nnx.Rngs(0), **{**VQ, **kw})
    p = GumbelVectorQuantizer(16, **{**VQ, **kw})
    load_jax_params(p, {"/".join(map(str, k)): np.asarray(v.get_value()) for k, v in nnx.to_flat_state(nnx.state(j, nnx.Param))})
    return j, p


@pytest.mark.parametrize("hard,training,combine", [(True, True, False), (False, True, False), (True, False, False), (True, True, True)])
def test_gumbel_vq_matches_jax(hard, training, combine):
    j, p = vq_pair(hard=hard, combine_groups=combine)
    x = np.random.default_rng(0).standard_normal((2, 5, 16)).astype(np.float32)
    key, step = jax.random.PRNGKey(1), 1000
    uniform = np.asarray(jax.random.uniform(key, (2, 5, VQ["groups"], VQ["num_vars"])))
    want = j(jnp.asarray(x), key, step, training=training)
    got = p(t(x), step, training=training, uniform=t(uniform))
    for k in ("quantized", "perplexity", "probs"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(p.temperature(step).numpy(), np.asarray(j.temperature(step)), rtol=1e-6)

    # the straight-through (or soft) gradients of sum(quantized^2) to the projection and codebook
    graphdef, state = nnx.split(j)

    def loss(s):
        return jnp.sum(nnx.merge(graphdef, s)(jnp.asarray(x), key, step, training=training)["quantized"] ** 2)

    jgrads = jax.grad(loss)(state)
    (got["quantized"] ** 2).sum().backward()
    np.testing.assert_allclose(p.codebook.grad.numpy(), np.asarray(jgrads["codebook"].get_value()), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.weight_proj.weight.grad.numpy(), np.asarray(jgrads["weight_proj"]["kernel"].get_value()).T, rtol=1e-5, atol=1e-6)


def test_gumbel_vq_draws_from_a_generator_or_refuses():
    _, p = vq_pair()
    x = t(np.ones((2, 5, 16), np.float32))
    a = p(x, generator=torch.Generator().manual_seed(3))["quantized"]
    assert torch.equal(a, p(x, generator=torch.Generator().manual_seed(3))["quantized"])
    with pytest.raises(ValueError, match="Generator"):
        p(x)
    assert torch.equal(p(x, training=False)["quantized"], p(x, training=False)["quantized"])


# --------------------------------------------------------------------------------------------- #
# utils/misc.py
# --------------------------------------------------------------------------------------------- #
def test_quaternions_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = (rng.standard_normal((4, 3, 4)).astype(np.float32) for _ in range(2))
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    v = rng.standard_normal((4, 3, 3)).astype(np.float32)
    aa = rng.standard_normal((4, 3, 3)).astype(np.float32)
    aa[0, 0] = 0.0  # the zero rotation's branch
    cases = [
        ("quaternion_multiply", (q1, q2)),
        ("quaternion_conjugate", (q1,)),
        ("quaternion_apply", (q1, v)),
        ("axis_angle_to_quaternion", (aa,)),
        ("quaternion_to_axis_angle", (q1,)),
    ]
    for name, args in cases:
        got = getattr(tmisc, name)(*(t(a) for a in args))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jmisc, name)(*args)), rtol=1e-6, atol=1e-6, err_msg=name)
    # a round trip through the axis-angle form
    back = tmisc.axis_angle_to_quaternion(tmisc.quaternion_to_axis_angle(t(q1) * torch.sign(t(q1)[..., :1])))
    np.testing.assert_allclose(back.numpy(), (t(q1) * torch.sign(t(q1)[..., :1])).numpy(), atol=1e-5)


def test_ndgrid_and_average_meter_match_jax():
    np.testing.assert_array_equal(tmisc.create_ndgrid(2, 3, 4).numpy(), jmisc.create_ndgrid(2, 3, 4))
    a, b = tmisc.AverageMeter("loss", ":.3f"), jmisc.AverageMeter("loss", ":.3f")
    for val, n in ((1.5, 2), (torch.tensor(3.0), 1), (0.25, 4)):
        a.update(val, n)
        b.update(float(val), n)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count) and str(a) == str(b)


# --------------------------------------------------------------------------------------------- #
# data/sensors.py on in-test buffers (tests/test_sensor_datasets.py's fixtures)
# --------------------------------------------------------------------------------------------- #
def png(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def rand_img(rng, h=40, w=30):
    return rng.integers(0, 255, (h, w, 3), dtype=np.uint8)


def assert_items_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_sensor_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    img, bg = rand_img(rng, 30, 40), rand_img(rng, 30, 40)
    for name, args in (("compute_diff", (img, bg, 0.5)), ("load_bin_image", (png(img),)), ("enhance_image", (img, 280, 200)),
                       ("load_sample_from_buf", (png(img),)), ("load_sample_from_buf", (img, bg, True)),
                       ("resize_image", (img, (16, 24)))):
        np.testing.assert_array_equal(getattr(tdata, name)(*args), getattr(jdata, name)(*args), err_msg=name)
    cv2.imwrite(str(tmp_path / f"bg_{jdata.DIGIT_BGS_OBJECTS['025_mug']}.jpg"), rand_img(rng))
    cv2.imwrite(str(tmp_path / "bg_gs.jpg"), rand_img(rng))
    for sensor, dataset in (("digit", "025_mug/run0"), ("gelsight_mini", "x")):
        np.testing.assert_array_equal(tdata.get_bg_img(str(tmp_path), sensor, dataset), jdata.get_bg_img(str(tmp_path), sensor, dataset))
    assert tdata.get_bg_img(str(tmp_path), "digit", "025_mug", remove_bg=False) is None
    assert tdata.DIGIT_BGS_OBJECTS == jdata.DIGIT_BGS_OBJECTS
    with pytest.raises(ValueError, match="HWC RGB"):
        tdata.load_sample_from_buf(np.zeros((4, 4), np.uint8))


def test_augment_window_matches_jax():
    from m3l_tpu.data.sensors import _augment_window as jaug
    from m3l_tpu_torch.data.sensors import _augment_window as taug

    rng = np.random.default_rng(1)
    window = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(2)]
    for seed in range(6):
        got = taug(window, (32, 32), np.random.default_rng(seed), 0.5, 0.5, 0.5)
        want = jaug(window, (32, 32), np.random.default_rng(seed), 0.5, 0.5, 0.5)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def write_frames(path, rng, n, h=40, w=30):
    for i in range(n):
        cv2.imwrite(str(path / f"frame_{i:04d}.png"), cv2.cvtColor(rand_img(rng, h, w), cv2.COLOR_RGB2BGR))


def test_digit_ycbslide_dataset_matches_jax(tmp_path):
    write_frames(tmp_path, np.random.default_rng(0), 8)
    for kw in (dict(), dict(p_flip=0.5, p_crop=0.5, p_rot=0.5, seed=3)):
        a = tdata.DigitYCBSlideDataset(str(tmp_path), d_frames=2, img_sz=(32, 32), **kw)
        b = jdata.DigitYCBSlideDataset(str(tmp_path), d_frames=2, img_sz=(32, 32), **kw)
        assert len(a) == len(b) == 4
        for i in range(len(a)):
            assert_items_equal(a[i], b[i])


def test_digit_slip_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    write_frames(tmp_path, rng, 12, 32, 24)
    labels = rng.integers(0, 5, 12)
    for markers in (False, True):
        a = tdata.DigitSlipDataset(str(tmp_path), labels, d_frames=2, img_sz=(32, 32), with_markers=markers)
        b = jdata.DigitSlipDataset(str(tmp_path), labels, d_frames=2, img_sz=(32, 32), with_markers=markers)
        assert len(a) == len(b) == 8
        for i in (0, 5):
            assert_items_equal(a[i], b[i])


def test_gelsight_grasp_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    data = {"is_gripping": [0, 1, 1, 0]}
    for sensor in ("gelsightA", "gelsightB"):
        for phase in ("before", "during", "after"):
            data[f"{sensor}_{phase}"] = [png(rand_img(rng)) for _ in range(4)]
    with open(tmp_path / "001.pkl", "wb") as f:
        pickle.dump(data, f)
    a_loaded, b_loaded = tdata.load_feeling_success(str(tmp_path), 1), jdata.load_feeling_success(str(tmp_path), 1)
    assert a_loaded == b_loaded
    for fmt, frames in (("concat_ch_img", 2), ("video", 4), ("single_image", 2)):
        a = tdata.GelsightGraspDataset(a_loaded, out_format=fmt, num_frames=frames, img_sz=(32, 32), seed=5)
        b = jdata.GelsightGraspDataset(b_loaded, out_format=fmt, num_frames=frames, img_sz=(32, 32), seed=5)
        for i in range(4):
            assert_items_equal(a[i], b[i])


def test_vision_force_slip_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = [png(rand_img(rng)) for _ in range(24)]
    os.makedirs(tmp_path / "traj0")
    for shard, part in enumerate((frames[:12], frames[12:])):
        with open(tmp_path / "traj0" / f"dataset_digit_{shard:02d}.pkl", "wb") as f:
            pickle.dump(part, f)
    trajectories = {
        "t0": {"indexes": np.arange(0, 12), "forces": rng.normal(size=(12, 3)).astype(np.float32) * 3,
               "slip_label": np.array([0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0])},
        "t1": {"indexes": np.arange(12, 24), "forces": rng.normal(size=(12, 3)).astype(np.float32) * 3, "slip_label": np.zeros(12, int)},
    }
    in_contact = np.ones(24, int)
    in_contact[0] = 0
    with open(tmp_path / "traj0" / "dataset_slip_forces.pkl", "wb") as f:
        pickle.dump({"in_contact": in_contact, "trajectories": trajectories}, f)
    (a_frames, a_labels), (b_frames, b_labels) = (m.load_dataset_forces(str(tmp_path), "traj0", "digit") for m in (tdata, jdata))
    assert a_frames == b_frames and len(a_frames) == 24
    kw = dict(in_contact=in_contact, slip_horizon=2, frame_stride=2, img_sz=(32, 32), max_abs_force=(5.0, 5.0, 5.0),
              max_delta_force=(2.0, 2.0, 2.0), remove_bg=True)
    for fmt in ("concat_ch_img", "video", "single_image"):
        a = tdata.VisionForceSlipDataset(a_frames, a_labels["trajectories"], out_format=fmt, **kw)
        b = jdata.VisionForceSlipDataset(b_frames, b_labels["trajectories"], out_format=fmt, **kw)
        assert len(a) == len(b) == 14
        np.testing.assert_array_equal(a.slip_labels, b.slip_labels)
        for i in (0, 3, 13):
            assert_items_equal(a[i], b[i])


def test_forcefield_ssl_dataset_matches_jax():
    rng = np.random.default_rng(5)
    frames = [png(rand_img(rng)) for _ in range(8)]
    bg = rand_img(rng)
    for kw in (dict(bg=bg, num_frames=2, frame_stride=2, img_sz=(64, 64)), dict(num_frames=3, out_format="video", img_sz=(32, 32)),
               dict(out_format="single_image", img_sz=(32, 32))):
        a, b = tdata.ForceFieldSSLDataset(frames, **kw), jdata.ForceFieldSSLDataset(frames, **kw)
        assert len(a) == len(b)
        for i in (0, 1):
            assert_items_equal(a[i], b[i])


def test_pose_and_textile_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    data = {"digit_left": [png(rand_img(rng)) for _ in range(5)], "object_left_rel_pose_n2": rng.normal(size=(6, 7)).astype(np.float32)}
    with open(tmp_path / "pose_ds.pkl", "wb") as f:
        pickle.dump(data, f)
    (a_frames, a_poses), (b_frames, b_poses) = (m.load_dataset_poses(str(tmp_path), "pose_ds", "left", 2) for m in (tdata, jdata))
    assert a_frames == b_frames and len(a_frames) == 5
    np.testing.assert_array_equal(a_poses, b_poses)
    os.makedirs(tmp_path / "textile0")
    with open(tmp_path / "textile0" / "dataset_gelsight.pkl", "wb") as f:
        pickle.dump({"frames": [1, 2, 3]}, f)
    (tmp_path / "textile0" / "metadata.txt").write_text("cotton")
    assert tdata.load_textile_dataset(str(tmp_path), "textile0") == jdata.load_textile_dataset(str(tmp_path), "textile0")


# --------------------------------------------------------------------------------------------- #
# train/distributed.py
# --------------------------------------------------------------------------------------------- #
def test_distributed_helpers_single_process(monkeypatch):
    for var in ("SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "RANK", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE", "SLURM_JOB_ID"):
        monkeypatch.delenv(var, raising=False)
    assert get_local_rank() == 0 and get_world_size() == 1
    assert is_main_process()
    assert initialize_distributed() is False and initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert slurm_requeue() is False
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    assert get_local_rank() == 3 and get_world_size() == 8 and not is_main_process()
    with pytest.raises(ValueError, match="neither cuda nor cpu"):
        initialize_distributed(device="mps")


def test_initialize_distributed_follows_the_mesh_backend_rule(monkeypatch):
    """nccl when every rank of the host has a card of its own, gloo when ranks share one or run on
    the CPU (train/mesh.py backend_for); the group is not started here, only asked for."""
    started = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda backend, **kw: started.append((backend, kw["world_size"])))
    for var in ("SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "1")
    for cards, device, want in ((4, "cuda", "nccl"), (1, "cuda", "gloo"), (4, "cpu", "gloo")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=cards: n)
        assert initialize_distributed("localhost:29500", device=device) is True
        assert started[-1] == (want, 4), (cards, device, started[-1])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")  # two hosts of two ranks, two cards each
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    initialize_distributed("localhost:29500", device="cuda")
    assert started[-1] == ("nccl", 4)
