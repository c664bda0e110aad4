"""The RL side's evaluation and visualisation in the port against the JAX package on the CPU:
``VTMAE.reconstruct`` (early-conv and patch branches), ``EvalCallback`` and ``create_callbacks``,
the env's ``render`` and the vec envs' ``env_method``, and the loggers.

Weights carry from the JAX modules by ``load_jax_params``; the reconstruction's mask is drawn by the
port's sampler at ``reconstruct_counts`` and injected into JAX's ``random_modal_masking``. Tolerances:
an EarlyCNN or the patch embedding is on every path, so rtol 2e-4 / atol 2e-5; the evaluation
episode's return, a sum of distances over its steps, to rtol 1e-5 (the two policies' actions differ
by f32 noise).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import m3l_tpu.models.vtmae as jvtmae_module
from m3l_tpu.envs import FakeInsertionEnv as JFakeInsertionEnv, SyncVecEnv as JSyncVecEnv, make_env as jmake_env
from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTTConfig as JVTTConfig
from m3l_tpu.ops.masking import ModalMask as JModalMask
from m3l_tpu.rl import PPOMAE as JPPOMAE
from m3l_tpu.rl import callbacks as jcallbacks
from m3l_tpu.utils.obs import vt_load as jvt_load
from m3l_tpu_torch.envs import FakeInsertionEnv, SharedMemoryVecEnv, SubprocVecEnv, SyncVecEnv, make_env
from m3l_tpu_torch.models import VTMAE, VTT, VTTConfig
from m3l_tpu_torch.rl import PPOMAE
from m3l_tpu_torch.rl import callbacks
from m3l_tpu_torch.utils.convert import load_jax_params
from m3l_tpu_torch.utils.loggers import MultiLogger, TensorBoardLogger, WandbLogger
from m3l_tpu_torch.utils.obs import vt_load
from test_torch_train_phase import FS, flat_state, jax_policy, port_policy
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=2e-4, atol=2e-5)


def mae_pair(early_conv: bool):
    cfg = dict(dim=64, depth=1, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=FS)
    kw = dict(decoder_dim=64, masking_ratio=0.75, decoder_depth=1, decoder_heads=2, early_conv_masking=early_conv)
    jm = JVTMAE(JVTT(JVTTConfig(**cfg), rngs=nnx.Rngs(0)), rngs=nnx.Rngs(1), **kw)
    tm = VTMAE(VTT(VTTConfig(**cfg)), **kw)
    load_jax_params(tm, flat_state(nnx.state(jm, nnx.Param)))
    return jm, tm


def batch(b=3, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, FS, 64, 64, 3), dtype=np.uint8),
            "tactile": rng.uniform(-1, 1, (b, FS, 6, 32, 32)).astype(np.float32)}


@pytest.mark.parametrize("early_conv,ratio", [(True, None), (False, 0.6)], ids=["early-conv", "patch-embedding"])
def test_reconstruct_matches_jax(early_conv, ratio, monkeypatch):
    """Each modality masks int(ratio * its own N) tokens (48 of 64 at the MAE's 0.75; 38 at 0.6),
    not the loss's split; masked image patches show 0.5, masked tactile patches inf."""
    jm, tm = mae_pair(early_conv)
    o = batch()
    jx = jvt_load({k: jnp.asarray(v) for k, v in o.items()}, frame_stack=FS)
    tx = vt_load({k: torch.from_numpy(v) for k, v in o.items()}, frame_stack=FS)
    counts = tm.reconstruct_counts(ratio)
    assert counts == [int((0.75 if ratio is None else ratio) * 64)] * 3
    mask = tm.sample_mask(torch.Generator().manual_seed(2), 3, masked=counts)
    assert mask.masked_idx.shape == (3, sum(counts)) and mask.unmasked_idx.shape == (3, 192 - sum(counts))
    jmask = JModalMask(*(jnp.asarray(t.numpy(), jnp.int32) for t in mask))
    monkeypatch.setattr(jvtmae_module, "random_modal_masking", lambda key, b, sizes, m: jmask)
    want = jm.reconstruct(jx, jax.random.PRNGKey(0), mask_ratio=ratio)
    with torch.no_grad():
        got = tm.reconstruct(tx, mask)
    assert got.keys() == want.keys() == {"recon_loss_image", "image_rec", "image_masked", "recon_loss_tactile", "tactile_rec", "tactile_masked"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    assert got["image_rec"].shape == (3, 64, 64, 3 * FS) and got["tactile_rec"].shape == (3, 2, 32, 32, 3 * FS)
    # the masked views: 48 (or 38) patches of each modality replaced
    per_patch = got["tactile_masked"].reshape(3, 2, 8, 4, 8, 4, -1).isinf().all(-1).all(5).all(3)  # (B, sensors, 8, 8)
    assert int(per_patch[0].sum()) == 2 * counts[1]
    if not early_conv:  # the kept patches keep their input
        assert torch.equal(got["image_rec"][got["image_masked"] != 0.5], tx["image"][got["image_masked"] != 0.5])


def test_reconstruct_without_the_image():
    _, tm = mae_pair(False)
    tx = vt_load({"tactile": torch.from_numpy(batch()["tactile"])}, frame_stack=FS)
    counts = tm.reconstruct_counts(use_vision=False)
    with torch.no_grad():
        out = tm.reconstruct(tx, tm.sample_mask(torch.Generator().manual_seed(0), 3, use_vision=False, masked=counts), use_vision=False)
    assert counts == [48, 48] and set(out) == {"recon_loss_tactile", "tactile_rec", "tactile_masked"}


def test_eval_callback_episode_matches_jax(tmp_path):
    """One deterministic episode of 25 steps through each package's PPOMAE.predict on the same
    weights: the same return, length and success; the port writes its annotated video."""
    jenv = JSyncVecEnv([jmake_env("FakeInsertion", 0, 0, frame_stack=FS)])
    jmodel = JPPOMAE(jax_policy(), jenv, n_steps=4, batch_size=4, frame_stack=FS)
    tp = port_policy()
    load_jax_params(tp, flat_state(jmodel.mae_params, jmodel.other_params))
    model = PPOMAE(tp, SyncVecEnv([make_env("FakeInsertion", 0, frame_stack=FS)]), n_steps=4, batch_size=4, frame_stack=FS, device="cpu")
    logged = []
    logger = SimpleNamespace(log_scalars=lambda m, step: logged.append((m, step)))
    jeval = jcallbacks.EvalCallback(jmake_env("FakeInsertion", 0, 0, frame_stack=FS), eval_every=8, max_steps=25)
    teval = callbacks.EvalCallback(make_env("FakeInsertion", 0, frame_stack=FS), eval_every=8, max_steps=25,
                                   video_dir=str(tmp_path / "videos"), logger=logger)
    for m in (jmodel, model):
        m.num_timesteps = 4
    assert jeval(jmodel) and teval(model) and not jeval.history and not teval.history  # before eval_every
    for m in (jmodel, model):
        m.num_timesteps = 8
    assert jeval(jmodel) and teval(model)
    (want,), (got,) = jeval.history, teval.history
    assert got["eval/ep_length"] == want["eval/ep_length"] == 25 and got["eval/success"] == want["eval/success"]
    np.testing.assert_allclose(got["eval/ep_reward"], want["eval/ep_reward"], rtol=1e-5)
    video = tmp_path / "videos" / "eval_8.mp4"
    assert got["eval/video"] == str(video) and video.stat().st_size > 0
    import cv2

    assert int(cv2.VideoCapture(str(video)).get(cv2.CAP_PROP_FRAME_COUNT)) == 25
    assert logged == [({k: got[k] for k in ("eval/ep_reward", "eval/ep_length", "eval/success")}, 8)]
    jenv.close()


def test_eval_callback_waits_for_learning_starts():
    algo = SimpleNamespace(num_timesteps=100)
    cb = callbacks.EvalCallback(lambda: pytest.fail("evaluated before learning_starts"), eval_every=10, learning_starts=200)
    assert cb(algo) is True and not cb.history


def test_create_callbacks_wires_like_jax(tmp_path):
    config = SimpleNamespace(wandb_dir=str(tmp_path), save_freq=100, eval_every=50)
    logger = SimpleNamespace(log_scalars=lambda m, step: None)
    env_fn = make_env("FakeInsertion", 0)
    ours = callbacks.create_callbacks(config, env_fn, logger, learning_starts=7, save_replay_buffer=True)
    theirs = jcallbacks.create_callbacks(config, env_fn, logger, learning_starts=7, save_replay_buffer=True)
    assert [type(c).__name__ for c in ours.callbacks] == [type(c).__name__ for c in theirs.callbacks] == [
        "CheckpointCallback", "EvalCallback", "TensorboardCallback"]
    for a, b in zip(ours.callbacks, theirs.callbacks):
        for attr in ("save_freq", "save_path", "save_replay_buffer", "eval_every", "video_dir", "learning_starts", "max_steps"):
            assert getattr(a, attr, None) == getattr(b, attr, None), attr
    assert [type(c).__name__ for c in callbacks.create_callbacks(config).callbacks] == ["CheckpointCallback"]


def test_render_and_env_method_match_jax():
    """render() is the current camera frame, as in JAX, after the same seed and actions; env_method
    calls it in each env (in process and in the workers); the shared-memory pool refuses."""
    ours, theirs = FakeInsertionEnv(seed=3), JFakeInsertionEnv(seed=3)
    for env in (ours, theirs):
        env.reset(seed=3)
        for a in np.linspace(-1, 1, 9).reshape(3, 3):
            env.step(a)
    np.testing.assert_array_equal(ours.render(), theirs.render())
    assert ours.render().shape == (64, 64, 3) and ours.render().dtype == np.uint8
    assert FakeInsertionEnv(state_type="touch").render().max() == 0
    fns = [make_env("FakeInsertion", i, seed=5, frame_stack=FS) for i in range(2)]
    direct = []
    for i, fn in enumerate(fns):
        env = fn()
        env.reset(seed=11 + i)  # a pool seeds env i with seed + i
        direct.append(env.render())
    for pool in (SyncVecEnv(fns), SubprocVecEnv(fns)):
        try:
            pool.reset(seed=11)
            frames = pool.env_method("render")
            assert len(frames) == 2 and all(np.array_equal(a, b) for a, b in zip(frames, direct))
            assert len(pool.env_method("render", indices=[1])) == 1
        finally:
            pool.close()
    shm = SharedMemoryVecEnv(fns)
    try:
        with pytest.raises(NotImplementedError, match="SubprocVecEnv"):
            shm.env_method("render")
    finally:
        shm.close()


def test_tensorboard_logger_writes_images(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logger = TensorBoardLogger(str(tmp_path))
    logger.log_scalars({"a": 1.0, "skip": float("nan"), "text": "x"}, 3)
    logger.log_image("recon/float", np.random.default_rng(0).random((2, 8, 8, 3)).astype(np.float32), 3)
    logger.log_image("recon/uint8", np.zeros((8, 8, 3), np.uint8), 4)
    logger.close()
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert acc.Tags()["scalars"] == ["a"] and sorted(acc.Tags()["images"]) == ["recon/float", "recon/uint8"]
    assert (acc.Images("recon/float")[0].width, acc.Images("recon/uint8")[0].step) == (8, 4)


def test_wandb_logger_needs_wandb(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *args, **kwargs):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    with pytest.raises(RuntimeError, match="wandb package"):
        WandbLogger(project="p")


def test_wandb_logger_gates_by_interval_and_multi_logger_fans_out(monkeypatch):
    import sys

    runs = []

    class Run:
        def __init__(self, **kw):
            self.kw, self.logged, self.finished = kw, [], False
            runs.append(self)

        def log(self, record):
            self.logged.append(record)

        def finish(self):
            self.finished = True

    monkeypatch.setitem(sys.modules, "wandb", SimpleNamespace(init=lambda **kw: Run(**kw), Video=lambda path: ("video", path)))
    wb = WandbLogger(project="p", run_id="r", log_interval=10)
    assert runs[0].kw == dict(project="p", entity=None, id="r", config=None, resume="allow")
    seen = []
    other = SimpleNamespace(log_scalars=lambda m, step: seen.append(step))
    multi = MultiLogger(wb, None, other)
    for step in (0, 5, 10, 25):
        multi.log_scalars({"x": 1.0}, step)
    wb.log_video("eval/video", "v.mp4", 25)
    assert [r["global_step"] for r in runs[0].logged] == [10, 25, 25] and seen == [0, 5, 10, 25]
    assert runs[0].logged[-1]["eval/video"] == ("video", "v.mp4")
    multi.close()
    assert runs[0].finished and len(multi.loggers) == 2
