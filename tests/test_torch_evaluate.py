"""The port's TacBench evaluators (eval/tacbench.py, eval/plots.py) and the evaluate CLI
(cli/evaluate.py) against the JAX package on the CPU.

The metrics are numpy in both packages: on the same predictions they must be equal (floats to
1e-12 of their size, everything else exactly). The probe's predictions through ``run_model`` agree
with JAX's to rtol 2e-4 (CONV_TOL: f32 with the patch conv on the path). The CLI runs at
tests/test_eval_cli.py's small overrides (ViT depth 1, 32x32, patch 8) with ``--device cpu``.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_params import CONV_TOL, probe_pair
from m3l_tpu import eval as jeval
from m3l_tpu.cli import evaluate as jevaluate
from m3l_tpu_torch import eval as teval
from m3l_tpu_torch.cli import evaluate
from m3l_tpu_torch.data import DataLoader, make_task_dataset
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 60


def assert_metrics_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float):
            assert isinstance(g, float) and (g == w or (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-12 * abs(w)), (k, g, w)
        else:
            np.testing.assert_array_equal(np.asarray(g, dtype=object if isinstance(w, tuple) else None), np.asarray(w), err_msg=k)


def results_of(task: str, seed: int = 0) -> dict:
    """Predictions and targets of ``task`` as run_model gathers them."""
    rng = np.random.default_rng(seed)
    if task == "force":
        gt = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
        return {"pred": gt + rng.normal(size=(N, 3)).astype(np.float32) * 0.1, "force": gt,
                "force_scale": np.tile(np.float32([2.0, 3.0, 5.0]), (N, 1))}
    if task == "slip":
        labels = (rng.random(N) > 0.6).astype(int)
        return {"pred": rng.normal(size=(N, 2)).astype(np.float32) + np.eye(2)[labels], "slip": labels}
    if task == "slip_force":
        labels = (rng.random(N) > 0.6).astype(int)
        delta = rng.normal(size=(N, 3)).astype(np.float32)
        return {"pred": {"slip": np.stack([1.0 - labels * 2.0, labels * 2.0 - 1.0], axis=1) * 3, "force": delta + rng.normal(size=(N, 3)) * 0.05},
                "slip_label": labels, "delta_force": delta, "delta_force_scale": np.tile([2.0, 2.0, 2.0], (N, 1)), "traj_id": np.repeat([0, 1, 2], N // 3)}
    if task == "pose":
        out = {"pred": {}}
        for head in ("x", "y", "theta"):
            lab = rng.integers(0, 5, N)
            out["pred"][head] = np.eye(5)[lab] + rng.normal(size=(N, 5))
            out[f"pose_{head}"] = lab
        return out
    classes = 20 if task == "textile" else 2
    labels = rng.integers(0, classes, N)
    return {"pred": rng.normal(size=(N, classes)) + np.eye(classes)[labels], task: labels}


EVALUATORS = {"force": "TestForceSL", "slip": "TestSlipSL", "slip_force": "TestSlipSL", "pose": "TestPoseSL", "grasp": "TestGraspSL", "textile": "TestTextileSL"}


@pytest.mark.parametrize("task", sorted(EVALUATORS))
def test_evaluator_metrics_equal_jax(task):
    name = EVALUATORS[task]
    ev, ref = getattr(teval, name).__new__(getattr(teval, name)), getattr(jeval, name).__new__(getattr(jeval, name))
    results = results_of(task)
    assert_metrics_equal(ev.get_overall_metrics(results), ref.get_overall_metrics(results))
    pred = results["pred"]
    first = {k: v[0] for k, v in pred.items()} if isinstance(pred, dict) else pred[0]
    assert ev.format_prediction(first) == ref.format_prediction(first)


def test_classification_helpers_equal_jax():
    rng = np.random.default_rng(3)
    pred, gt = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    assert_metrics_equal(teval.classification_metrics(pred, gt, 5), jeval.classification_metrics(pred, gt, 5))
    raw = rng.integers(0, 2, 40)
    for window in (1, 3, 5):
        np.testing.assert_array_equal(teval.smooth_slip_predictions(raw, window), jeval.smooth_slip_predictions(raw, window))
    assert all(getattr(getattr(teval, n), "__test__", True) is False for n in set(EVALUATORS.values()) | {"TestTaskSL"})


@pytest.mark.parametrize("task", ["force", "slip_force", "pose", "grasp"])
def test_plots_equal_jax(task):
    name = EVALUATORS[task]
    ev, ref = getattr(teval, name).__new__(getattr(teval, name)), getattr(jeval, name).__new__(getattr(jeval, name))
    results = results_of(task)
    if task == "slip_force":
        results = {**results, "force": results["delta_force"], "force_scale": np.ones((N, 3))}
    got, want = ev.make_plots(results), ref.make_plots(results)
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k].ndim == 3 and got[k].shape[-1] == 3
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["force", "pose"])
def test_run_model_equals_jax(name, tmp_path):
    """run_model over a loader: the port's probe on its device under no_grad against JAX's jitted
    predict, the targets passed through, the predictions cached as .npy."""
    probe_kw = {"num_classes": 5} if name == "pose" else {}
    j, p = probe_pair(name, False, probe_kw)
    buf = {"frames": np.random.default_rng(7).integers(0, 256, (14, 32, 32, 3), dtype=np.uint8)}
    if name == "force":
        buf["force"] = np.random.default_rng(8).uniform(-2, 2, (14, 3)).astype(np.float32)
    else:
        buf["pose"] = np.random.default_rng(8).uniform(-1, 1, (14, 3)).astype(np.float32)
    ds = make_task_dataset(buf, name, num_frames=1, pose_bins=5)
    loader = DataLoader(ds, batch_size=4, shuffle=False)
    cls = EVALUATORS[name]
    got = getattr(teval, cls)(p, cache_dir=str(tmp_path)).run_model(loader)
    want = getattr(jeval, cls)(j).run_model(loader)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            for h in want[k]:
                np.testing.assert_allclose(got[k][h], want[k][h], err_msg=h, **CONV_TOL)
        elif k == "pred":
            np.testing.assert_allclose(got[k], want[k], **CONV_TOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cached = sorted(f.name for f in tmp_path.iterdir())
    assert cached == (["t1_force_pred.npy"] if name == "force" else ["t3_pose_pred_theta.npy", "t3_pose_pred_x.npy", "t3_pose_pred_y.npy"])


SMALL = [  # tests/test_eval_cli.py's overrides
    "model.encoder.img_size=[32,32]",
    "model.encoder.patch_size=8",
    "model.encoder.depth=1",
    "model.encoder.in_chans=6",
    "trainer.log_every_n_steps=1000",
    "data.batch_size=4",
]


@pytest.mark.parametrize("task", ["force", "slip", "pose", "grasp", "textile"])
def test_evaluate_cli_on_the_cpu(task, tmp_path):
    metrics = evaluate.main(["--config", "config/default.yaml", "--task", task, "--synthetic", "16", "--epochs", "1", "--device", "cpu",
                             *SMALL, f"trainer.ckpt_dir={tmp_path}/out"])
    want = jevaluate.main(["--config", "config/default.yaml", "--task", task, "--synthetic", "16", "--epochs", "1",
                           *SMALL, f"trainer.ckpt_dir={tmp_path}/jax"])
    assert sorted(metrics) == sorted(want)
    assert (tmp_path / "out" / "last.ckpt").is_file()
    if task == "force":
        assert all(np.isfinite(metrics[k]) for k in ("rmse", "rmse_x", "rmse_y", "rmse_z"))
    elif task == "pose":
        assert all(0.0 <= metrics[f"acc_{h}"] <= 1.0 for h in ("x", "y", "theta"))
    else:
        assert 0.0 <= metrics["accuracy"] <= 1.0 and np.sum(metrics["confusion"]) == 8  # 11 windows at stride 5: 2 batches of 4


@pytest.mark.parametrize("config,train_encoder", [("force/digit_mae.yaml", False), ("force/digit_e2e.yaml", True), ("slip/gelsight_dino.yaml", False)])
def test_evaluate_cli_on_the_downstream_configs(config, train_encoder, tmp_path):
    """The downstream configs' encoder, probe and mode through the CLI: a frozen encoder ends where
    it started, a fine-tuned one moves."""
    from m3l_tpu_torch.train import Trainer

    fits = []
    fit = Trainer.fit

    def recording_fit(self, module, loader, *args, **kw):
        before = {k: v.clone() for k, v in module.model_encoder.state_dict().items()}
        out = fit(self, module, loader, *args, **kw)
        fits.append((module, before))
        return out

    Trainer.fit = recording_fit
    try:
        task = config.split("/")[0]
        metrics = evaluate.main(["--config", str(ROOT / "config" / "experiment" / "downstream_task" / config), "--task", task,
                                 "--synthetic", "24", "--epochs", "1", "--device", "cpu", *SMALL[:3], "trainer.log_every_n_steps=1000",
                                 "data.batch_size=4", f"ckpt_dir={tmp_path}/out"])
    finally:
        Trainer.fit = fit
    (module, before), = fits
    assert module.train_encoder == train_encoder and type(module.model_encoder.encoder).__module__ == "m3l_tpu_torch.models.vit"
    moved = any(not torch.equal(v, before[k]) for k, v in module.model_encoder.state_dict().items())
    assert moved == train_encoder
    assert np.isfinite(metrics["rmse"] if task == "force" else metrics["accuracy"])


def test_evaluate_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--config", "config/default.yaml", "--task", "force", "--synthetic", "8", *SMALL])
