"""Evaluation plots (the port's own copy of ``m3l_tpu/eval/plots.py``): per-axis
prediction / ground-truth correlation scatter, force error histograms and cone, confusion
matrices, slip timelines and delta-force curves, each returned as an RGB array so loggers can
write it without a display. matplotlib is imported inside each function, so importing this
module needs no matplotlib."""
from __future__ import annotations

import numpy as np


def _fig_to_array(fig) -> np.ndarray:
    import matplotlib

    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    import matplotlib.pyplot as plt

    plt.close(fig)
    return buf


def plot_correlation(gt: np.ndarray, pred: np.ndarray, axis_names=("Fx", "Fy", "Fz")) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    n = gt.shape[1]
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        ax.scatter(gt[:, i], pred[:, i], s=4, alpha=0.4)
        lim = [min(gt[:, i].min(), pred[:, i].min()), max(gt[:, i].max(), pred[:, i].max())]
        ax.plot(lim, lim, "k--", lw=1)
        r = np.corrcoef(gt[:, i], pred[:, i])[0, 1] if gt.shape[0] > 1 else np.nan
        ax.set_title(f"{axis_names[i]} (r={r:.3f})")
        ax.set_xlabel("ground truth")
        ax.set_ylabel("prediction")
    fig.tight_layout()
    return _fig_to_array(fig)


def plot_forces_error(gt: np.ndarray, pred: np.ndarray, axis_names=("Fx", "Fy", "Fz")) -> tuple[np.ndarray, np.ndarray]:
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    err = pred - gt
    fig, axes = plt.subplots(1, err.shape[1], figsize=(4 * err.shape[1], 3))
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        ax.hist(err[:, i], bins=40)
        ax.set_title(f"{axis_names[i]} err (RMSE {np.sqrt((err[:, i] ** 2).mean()):.3f})")
    fig.tight_layout()
    img_err = _fig_to_array(fig)

    # shear error "cone": error magnitude vs normal-force magnitude
    fig2, ax = plt.subplots(figsize=(4, 4))
    mag = np.linalg.norm(gt, axis=1)
    emag = np.linalg.norm(err, axis=1)
    ax.scatter(mag, emag, s=4, alpha=0.4)
    ax.set_xlabel("|force| (gt)")
    ax.set_ylabel("|error|")
    fig2.tight_layout()
    img_cone = _fig_to_array(fig2)
    return img_err, img_cone


def plot_confusion_matrix(cm: np.ndarray, class_names=None) -> np.ndarray:
    """Confusion-matrix heatmap (reference test_t4_grasp.py:124-136,
    test_t6_textile.py:128-142, test_t3_pose.py:191-218)."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    cm = np.asarray(cm, np.float64)
    n = cm.shape[0]
    class_names = class_names or [str(i) for i in range(n)]
    norm = cm / np.clip(cm.sum(axis=1, keepdims=True), 1, None)
    fig, ax = plt.subplots(figsize=(max(4, n * 0.6), max(4, n * 0.6)))
    im = ax.imshow(norm, cmap="viridis", vmin=0, vmax=1)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{int(cm[i, j])}", ha="center", va="center",
                    color="white" if norm[i, j] < 0.5 else "black", fontsize=8)
    ax.set_xticks(range(n), class_names, rotation=45, ha="right")
    ax.set_yticks(range(n), class_names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("ground truth")
    fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    return _fig_to_array(fig)


def plot_slip_trajectory(slip_gt: np.ndarray, slip_pred: np.ndarray, *, force: np.ndarray = None, coef_friction: float = None, horizon: int = 0, fps: float = 60.0) -> np.ndarray:
    """Per-trajectory slip timeline + friction-cone scatter (reference
    test_t2_slip.py plot_slip:188-313)."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    n_panels = 2 if force is not None else 1
    fig, axs = plt.subplots(1, n_panels, figsize=(6 * n_panels, 4))
    axs = np.atleast_1d(axs)
    t = np.arange(len(slip_gt)) / fps
    horizon_ms = horizon / fps * 1000.0
    suffix = f" (next {horizon_ms:.0f} ms)" if horizon > 0 else ""
    axs[0].plot(t, slip_gt, color="blue", alpha=0.5, linewidth=5, label="Ground truth" + suffix)
    axs[0].plot(t, slip_pred, color="red", label="Prediction" + suffix)
    axs[0].set_xlabel("t (s)")
    axs[0].set_ylim(-0.5, 1.5)
    axs[0].set_yticks([0, 1], ["No slip", "Slip"])
    axs[0].legend()
    axs[0].grid(True)

    if force is not None:
        colors = {"no_slip": "#369407", "slip": "#bb65fc", "error": "#fc0303"}
        agree0 = (slip_gt == 0) & (slip_pred == 0)
        agree1 = (slip_gt == 1) & (slip_pred == 1)
        err = slip_gt != slip_pred
        mag_shear = np.linalg.norm(force[:, :2], axis=1)
        mag_normal = -force[:, 2]
        if coef_friction:
            x = np.linspace(0, max(mag_shear.max() * 0.9, 1e-6), 100)
            axs[1].plot(x, x / coef_friction, "--", c="gray", label="Friction Boundary")
        axs[1].scatter(mag_shear[agree1], mag_normal[agree1], c=colors["slip"], s=10, label="Slip")
        axs[1].scatter(mag_shear[agree0], mag_normal[agree0], c=colors["no_slip"], s=10, label="No Slip")
        axs[1].scatter(mag_shear[err], mag_normal[err], c=colors["error"], s=20, label="Error")
        axs[1].set_xlabel("GT Shear Force (N)")
        axs[1].set_ylabel("GT Normal Force (N)")
        axs[1].legend()
    fig.tight_layout()
    return _fig_to_array(fig)


def plot_delta_forces(delta_gt: np.ndarray, delta_pred: np.ndarray, fps: float = 60.0) -> np.ndarray:
    """Delta shear/normal magnitude over time (reference
    test_t2_slip.py plot_delta_forces:315-377)."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 2, figsize=(12, 3.5))
    t = np.arange(len(delta_gt)) / fps
    shear_gt = np.linalg.norm(delta_gt[:, :2], axis=1)
    shear_pred = np.linalg.norm(delta_pred[:, :2], axis=1)
    axs[0].plot(t, shear_gt, c="gray", linestyle="--", label="GT Δ shear")
    axs[0].plot(t, shear_pred, c="blue", label="Pred Δ shear")
    axs[0].set_xlabel("t (s)")
    axs[0].set_ylabel("Δ Shear (N)")
    axs[0].legend()
    axs[1].plot(t, delta_gt[:, 2], c="gray", linestyle="--", label="GT Δ normal")
    axs[1].plot(t, delta_pred[:, 2], c="green", label="Pred Δ normal")
    axs[1].set_xlabel("t (s)")
    axs[1].set_ylabel("Δ Normal (N)")
    axs[1].legend()
    fig.tight_layout()
    return _fig_to_array(fig)
