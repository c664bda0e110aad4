"""TacBench-style offline evaluation harness (the port's own numpy copy of
``m3l_tpu/eval/tacbench.py``).

A ``TestTaskSL`` base batches a trained probe over a held-out dataset, optionally caches its
``.npy`` predictions, and computes per-task metrics:

* T1 force: per-axis RMSE +- std, Pearson r, and a bootstrap 95% CI on the RMSE;
* T2 slip / T4 grasp / T6 textile: accuracy, per-class precision / recall / F1, the confusion
  matrix;
* T3 pose: per-head classification accuracy and the expected bin error.

The module runs under ``torch.no_grad()`` on its own device (where the JAX package compiles it
with ``nnx.jit``); the predictions come back as numpy and every metric is numpy, as in JAX.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch


class TestTaskSL:
    __test__ = False  # not a pytest class (evaluation harness)
    task_name = "task"

    def __init__(self, module, *, cache_dir: Optional[str] = None, batch_keys=("image",)):
        self.module = module
        self.cache_dir = cache_dir
        self.batch_keys = batch_keys

    @torch.no_grad()
    def predict(self, batch: dict):
        """The module's prediction for ``batch``'s inputs, on the module's device, as numpy (a dict
        of arrays for a multi-head probe)."""
        device = next(self.module.parameters()).device
        y = self.module.predict(*[torch.as_tensor(batch[k]).to(device) for k in self.batch_keys])
        return {k: v.cpu().numpy() for k, v in y.items()} if isinstance(y, dict) else y.cpu().numpy()

    # ------------------------------------------------------------------ #
    def run_model(self, loader: Iterable[dict]) -> dict:
        """Batch predictions over the dataset; returns {pred, **targets}."""
        preds, targets = [], {}
        for batch in loader:
            preds.append(self.predict(batch))
            for k, v in batch.items():
                if k not in self.batch_keys:
                    targets.setdefault(k, []).append(np.asarray(v))
        if preds and isinstance(preds[0], dict):
            pred = {k: np.concatenate([p[k] for p in preds]) for k in preds[0]}
        else:
            pred = np.concatenate(preds) if preds else np.zeros((0,))
        out = {"pred": pred}
        out.update({k: np.concatenate(v) for k, v in targets.items()})
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            if isinstance(pred, dict):
                for k, v in pred.items():
                    np.save(os.path.join(self.cache_dir, f"{self.task_name}_pred_{k}.npy"), v)
            else:
                np.save(os.path.join(self.cache_dir, f"{self.task_name}_pred.npy"), pred)
        return out

    def get_overall_metrics(self, results: dict) -> dict:
        raise NotImplementedError

    def format_prediction(self, pred_j) -> dict:
        """Per-task caption fields for one sample's prediction; overridden by
        the task evaluators (reference test_task.py:12-48 family annotates the
        full per-task prediction, not a single scalar)."""
        if isinstance(pred_j, dict):
            out = {}
            for k, v in pred_j.items():
                out.update({f"pred_{k}": _fmt_vec(v)})
            return out
        return {"pred": _fmt_vec(pred_j)}

    def format_target(self, key: str, value) -> dict:
        return {key: _fmt_vec(value)}

    def make_video(self, loader, path: str, max_frames: int = 100, fps: int = 10) -> str:
        """An annotated prediction video over the evaluation set: each input frame captioned with
        the probe's whole per-task prediction and the ground truth (host side: cv2)."""
        from ..utils.video import annotate_frame, write_video

        frames = []
        for batch in loader:
            pred = self.predict(batch)
            imgs = np.asarray(batch["image"])[..., :3]  # the first 3 channels
            for j in range(imgs.shape[0]):
                if len(frames) >= max_frames:
                    break
                pj = {k: v[j] for k, v in pred.items()} if isinstance(pred, dict) else pred[j]
                info = self.format_prediction(pj)
                for k, v in batch.items():
                    if k not in self.batch_keys and np.ndim(v[j]) <= 1:
                        info.update(self.format_target(k, np.asarray(v[j])))
                frames.append(annotate_frame(len(frames), imgs[j], 0.0, info))
            if len(frames) >= max_frames:
                break
        return write_video(frames, path, fps=fps)

    def evaluate(self, loader) -> dict:
        return self.get_overall_metrics(self.run_model(loader))


def _fmt_vec(v, max_elems: int = 4):
    """Caption-friendly rendering: scalar -> float, small vector -> string."""
    a = np.ravel(np.asarray(v, np.float64))
    if a.size == 1:
        return float(a[0])
    body = " ".join(f"{x:.3f}" for x in a[:max_elems])
    return "[" + body + (" .." if a.size > max_elems else "") + "]"


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a - a.mean(), b - b.mean()
    denom = np.sqrt((a**2).sum() * (b**2).sum())
    return float((a * b).sum() / denom) if denom > 0 else float("nan")


def _bootstrap_rmse_ci(err: np.ndarray, n_boot: int = 1000, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(err)
    stats = np.sqrt(np.mean(err[rng.integers(0, n, (n_boot, n))] ** 2, axis=1))
    return float(np.percentile(stats, 2.5)), float(np.percentile(stats, 97.5))


class TestForceSL(TestTaskSL):
    task_name = "t1_force"

    def format_prediction(self, pred_j) -> dict:
        p = np.ravel(np.asarray(pred_j, np.float64))
        return {f"pred_f{a}": float(p[i]) for i, a in enumerate("xyz"[: len(p)])}

    def make_plots(self, results: dict) -> dict:
        """Correlation + error plots (reference test_t1_force.py plotting +
        force_sl.py:163-185). Returns RGB arrays keyed by plot name."""
        from .plots import plot_correlation, plot_forces_error

        pred, gt = results["pred"], results["force"]
        scale = results.get("force_scale", np.ones_like(gt))
        img_corr = plot_correlation(gt * scale, pred * scale)
        img_err, img_cone = plot_forces_error(gt * scale, pred * scale)
        return {"correlation": img_corr, "error": img_err, "error_cone": img_cone}

    def get_overall_metrics(self, results: dict) -> dict:
        pred, gt = results["pred"], results["force"]
        scale = results.get("force_scale", np.ones_like(gt))
        pred, gt = pred * scale, gt * scale
        metrics = {}
        for i, axis in enumerate("xyz"):
            err = pred[:, i] - gt[:, i]
            rmse = float(np.sqrt(np.mean(err**2)))
            lo, hi = _bootstrap_rmse_ci(err)
            metrics[f"rmse_{axis}"] = rmse
            metrics[f"rmse_{axis}_std"] = float(np.std(np.abs(err)))
            metrics[f"rmse_{axis}_ci95"] = (lo, hi)
            metrics[f"pearson_{axis}"] = _pearson(pred[:, i], gt[:, i])
        metrics["rmse"] = float(np.sqrt(np.mean((pred - gt) ** 2)))
        return metrics


def classification_metrics(pred_labels: np.ndarray, gt_labels: np.ndarray, num_classes: int) -> dict:
    cm = np.zeros((num_classes, num_classes), np.int64)
    for p, g in zip(pred_labels, gt_labels):
        cm[g, p] += 1
    tp = np.diag(cm).astype(np.float64)
    precision = tp / np.clip(cm.sum(0), 1, None)
    recall = tp / np.clip(cm.sum(1), 1, None)
    f1 = 2 * precision * recall / np.clip(precision + recall, 1e-8, None)
    # balanced accuracy = mean per-class recall (reference test_t2_slip.py:143)
    present = cm.sum(1) > 0
    balanced = float(recall[present].mean()) if present.any() else float("nan")
    return {
        "accuracy": float(tp.sum() / max(cm.sum(), 1)),
        "balanced_accuracy": balanced,
        "precision": precision.tolist(),
        "recall": recall.tolist(),
        "f1": f1.tolist(),
        "macro_f1": float(f1.mean()),
        "confusion": cm.tolist(),
    }


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def smooth_slip_predictions(pred: np.ndarray, window: int = 3) -> np.ndarray:
    """Debounce a binary slip sequence: predict slip only when the last
    ``window`` raw predictions all say slip (reference
    test_t2_slip.py:116-124 deque smoothing)."""
    pred = np.asarray(pred).astype(int)
    out = np.zeros_like(pred)
    for i in range(len(pred)):
        lo = max(i - window + 1, 0)
        w = pred[lo : i + 1]
        out[i] = 1 if (len(w) == window and w.sum() == window) else 0
    return out


class TestSlipSL(TestTaskSL):
    """Slip evaluator with the reference's full depth
    (reference test_t2_slip.py:29-377): probability-threshold decisions
    (th=0.4 on the slip prob, :44,106), per-trajectory prediction smoothing
    (:116-124), and — when the probe also predicts delta forces
    (SlipForceProbe) — per-axis delta-force RMSE +- std and Pearson r in
    Newton scale (:144-149)."""

    task_name = "t2_slip"
    label_key = "slip"
    threshold = 0.4
    smooth_window = 3

    def format_prediction(self, pred_j) -> dict:
        logits = pred_j["slip"] if isinstance(pred_j, dict) else pred_j
        probs = _softmax(np.asarray(logits, np.float64)[None])[0]
        if probs.shape[-1] == 2:
            out = {"p_slip": float(probs[1]), "pred": "slip" if probs[1] > self.threshold else "no-slip"}
        else:
            out = {"pred_class": int(np.argmax(probs)), "p": float(probs.max())}
        if isinstance(pred_j, dict) and "force" in pred_j:
            out["pred_dF"] = _fmt_vec(pred_j["force"])
        return out

    def _labels(self, results: dict) -> np.ndarray:
        # "slip_label" is the sensor dataset's key (data/sensors.py),
        # "slip" the generic task-dataset one
        key = "slip_label" if "slip_label" in results else self.label_key
        return np.asarray(results[key]).astype(int)

    def _slip_decisions(self, results: dict) -> tuple[np.ndarray, np.ndarray]:
        pred = results["pred"]
        logits = pred["slip"] if isinstance(pred, dict) else pred
        labels = self._labels(results)
        probs = _softmax(np.asarray(logits, np.float64))
        if probs.shape[-1] == 2:
            decisions = (probs[:, 1] > self.threshold).astype(int)
        else:
            decisions = np.argmax(probs, -1)
        # per-trajectory smoothing when trajectory ids ride along the batch
        if "traj_id" in results:
            traj = np.asarray(results["traj_id"]).ravel()
            for tid in np.unique(traj):
                m = traj == tid
                decisions[m] = smooth_slip_predictions(decisions[m], self.smooth_window)
        return decisions, labels

    def get_overall_metrics(self, results: dict) -> dict:
        pred = results["pred"]
        logits = pred["slip"] if isinstance(pred, dict) else pred
        decisions, labels = self._slip_decisions(results)
        metrics = classification_metrics(decisions, labels, np.asarray(logits).shape[-1])
        if isinstance(pred, dict) and "force" in pred and "delta_force" in results:
            scale = results.get("delta_force_scale", np.ones(3))
            scale = np.asarray(scale[0] if np.ndim(scale) > 1 else scale, np.float64)
            gt = results["delta_force"] * scale
            hat = pred["force"] * scale
            err = hat - gt
            metrics["delta_force/rmse"] = np.sqrt((err**2).mean(0)).tolist()
            metrics["delta_force/rmse_std"] = np.abs(err).std(0).tolist()
            metrics["delta_force/corr"] = [_pearson(gt[:, i], hat[:, i]) for i in range(gt.shape[1])]
        metrics["n_samples"] = int(len(labels))
        return metrics

    def make_plots(self, results: dict) -> dict:
        """Per-trajectory slip timelines (+friction cone when forces ride
        along) and delta-force curves (reference test_t2_slip.py:165-377)."""
        from .plots import plot_delta_forces, plot_slip_trajectory

        decisions, labels = self._slip_decisions(results)
        plots = {}
        traj = np.asarray(results["traj_id"]).ravel() if "traj_id" in results else np.zeros(len(labels), int)
        pred = results["pred"]
        for tid in np.unique(traj)[:20]:
            m = traj == tid
            force = results["force"][m] * np.asarray(results.get("force_scale", [np.ones(3)])[0]) if "force" in results else None
            plots[f"slip_traj{tid}"] = plot_slip_trajectory(labels[m], decisions[m], force=force)
            if isinstance(pred, dict) and "force" in pred and "delta_force" in results:
                plots[f"delta_forces_traj{tid}"] = plot_delta_forces(results["delta_force"][m], pred["force"][m])
        return plots


class _ConfusionPlotMixin:
    def make_plots(self, results: dict) -> dict:
        """Confusion-matrix heatmap (reference test_t4_grasp.py:124-136,
        test_t6_textile.py:128-142)."""
        from .plots import plot_confusion_matrix

        m = self.get_overall_metrics(results)
        names = getattr(self, "class_names", None)
        return {"confusion_matrix": plot_confusion_matrix(np.asarray(m["confusion"]), names)}


class _ClassifierCaption:
    def format_prediction(self, pred_j) -> dict:
        probs = _softmax(np.asarray(pred_j, np.float64)[None])[0]
        return {"pred_class": int(np.argmax(probs)), "p": float(probs.max())}


class TestGraspSL(_ClassifierCaption, _ConfusionPlotMixin, TestTaskSL):
    task_name = "t4_grasp"
    label_key = "grasp"
    class_names = ("not_gripping", "gripping")

    def get_overall_metrics(self, results: dict) -> dict:
        logits = results["pred"]
        labels = results[self.label_key].astype(int)
        return classification_metrics(np.argmax(logits, -1), labels, logits.shape[-1])


class TestTextileSL(TestGraspSL):
    task_name = "t6_textile"
    label_key = "textile"
    class_names = None


class TestPoseSL(TestTaskSL):
    task_name = "t3_pose"

    def format_prediction(self, pred_j) -> dict:
        if isinstance(pred_j, dict):
            return {f"pred_{k}": int(np.argmax(v)) for k, v in pred_j.items()}
        return {"pred": _fmt_vec(pred_j)}

    def get_overall_metrics(self, results: dict) -> dict:
        metrics = {}
        for head in ("x", "y", "theta"):
            logits = results["pred"][head]
            labels = results[f"pose_{head}"].astype(int)
            pred = np.argmax(logits, -1)
            metrics[f"acc_{head}"] = float((pred == labels).mean())
            metrics[f"bin_err_{head}"] = float(np.abs(pred - labels).mean())
        return metrics

    def make_plots(self, results: dict) -> dict:
        """Per-head confusion matrices (reference test_t3_pose.py:191-218)."""
        from .plots import plot_confusion_matrix

        plots = {}
        for head in ("x", "y", "theta"):
            logits = results["pred"][head]
            labels = results[f"pose_{head}"].astype(int)
            pred = np.argmax(logits, -1)
            n = logits.shape[-1]
            cm = np.zeros((n, n), np.int64)
            for p, g in zip(pred, labels):
                cm[g, p] += 1
            plots[f"confusion_{head}"] = plot_confusion_matrix(cm)
        return plots
