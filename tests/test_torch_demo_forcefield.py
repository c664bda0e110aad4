"""The port's force-field demo CLI (cli/demo_forcefield.py) on the CPU, the video helpers
(utils/video.py) and TacBench's make_video, against the JAX package where both compute the same.

The demo runs headless (``--source dataset``, ``--out``) with ``--device cpu``: the untrained
decoder path, and a trained GeometricForceFieldModule restored from a Trainer checkpoint.
"""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_params import CONV_TOL, carry, images, t
from m3l_tpu_torch.cli import demo_forcefield as demo
from m3l_tpu_torch.train import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = SimpleNamespace(dim=32, depth=2, heads=2, hooks="1", fusion_ch=16, dtype="float32")
SMALL_ARGV = ["--dim", "32", "--depth", "2", "--heads", "2", "--hooks", "1", "--fusion_ch", "16", "--dtype", "float32"]


def test_demo_dataset_source_untrained(tmp_path):
    out = str(tmp_path / "demo.mp4")
    assert demo.main(["--source", "dataset", "--frames", "3", "--out", out, "--device", "cpu"]) == 3
    assert os.path.getsize(out) > 0


def test_demo_trained_module_restore_roundtrip(tmp_path):
    """--module_ckpt restores a Trainer full-state checkpoint into the rebuilt module and runs its
    two-pass forward_fields on every frame."""
    module = demo._build_module_structure(SMALL, 96)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.01)  # not the seeded initial weights
    ckpt = str(tmp_path / "last.ckpt")
    save_checkpoint(ckpt, {"model": module.state_dict()})
    restored = demo._build_trained_module(SimpleNamespace(**vars(SMALL), module_ckpt=ckpt), 96)
    assert all(torch.equal(a, b) for a, b in zip(restored.state_dict().values(), module.state_dict().values()))
    out = str(tmp_path / "demo_trained.mp4")
    n = demo.main(["--module_ckpt", ckpt, *SMALL_ARGV, "--source", "dataset", "--frames", "2", "--out", out, "--device", "cpu"])
    assert n == 2 and os.path.getsize(out) > 0


def test_dataset_source_background_tracks_trajectory():
    src = demo._DatasetSource(48)
    first_traj_len = int((src.tid == 0).sum())
    src.read()
    bg0 = src.background()
    for _ in range(first_traj_len):
        src.read()
    assert not np.array_equal(bg0, src.background())


def test_module_structure_equals_jax():
    """The demo's module structure carries the JAX one's weights one to one, and its two-pass
    forward_fields agrees (f32, 2e-4 with the convolutions on the path)."""
    from m3l_tpu.cli import demo_forcefield as jdemo

    j = jdemo._build_module_structure(SMALL, 96)
    p = carry(j, demo._build_module_structure(SMALL, 96))
    x, xb = images((2, 96, 96, 6), seed=1), images((2, 96, 96, 6), seed=2)
    with torch.no_grad():
        disp, shear = p.forward_fields(t(x), t(xb))
    jd, js = j.forward_fields(jnp.asarray(x), jnp.asarray(xb))
    np.testing.assert_allclose(disp.numpy(), np.asarray(jd), **CONV_TOL)
    np.testing.assert_allclose(shear.numpy(), np.asarray(js), rtol=2e-4, atol=2e-4)


def test_bf16_demo_model_is_finite():
    module = demo._build_module_structure(SimpleNamespace(**{**vars(SMALL), "dtype": "bfloat16"}), 96)
    with torch.no_grad():
        disp, shear = module.forward_fields(t(images((2, 96, 96, 6), seed=3)), t(images((2, 96, 96, 6), seed=4)))
    assert disp.shape == (2, 96, 96, 1) and shear.shape == (2, 96, 96, 2)
    assert torch.isfinite(disp).all() and torch.isfinite(shear).all()


def test_annotate_frame_equals_jax():
    from m3l_tpu.utils import video as jvideo
    from m3l_tpu_torch.utils import video

    frame = images((64, 48, 3), seed=5)
    info = {"pred": 0.25, "label": "slip", "n": 3, "skip": [1, 2]}
    np.testing.assert_array_equal(video.annotate_frame(7, frame, 0.5, info), jvideo.annotate_frame(7, frame, 0.5, info))


def test_tacbench_make_video(tmp_path):
    """An annotated prediction video over a force probe's evaluation batches."""
    from m3l_tpu_torch import eval as tacbench
    from m3l_tpu_torch import tasks
    from m3l_tpu_torch.models.vit import VisionTransformer

    torch.manual_seed(0)
    vit = VisionTransformer(img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=32, depth=1, num_heads=2, pos_embed_fn="sinusoidal")
    module = tasks.ForceSLModule(vit, tasks.ForceLinearProbe(32, num_heads=2))
    rng = np.random.default_rng(6)
    loader = [{"image": images((3, 32, 32, 3), seed=i), "force": rng.uniform(-1, 1, (3, 3)).astype(np.float32)} for i in range(2)]
    path = tacbench.TestForceSL(module).make_video(loader, str(tmp_path / "eval.mp4"), max_frames=5)
    assert os.path.getsize(path) > 0
    import cv2

    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()
