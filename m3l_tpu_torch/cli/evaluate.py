"""Downstream probe training and TacBench evaluation, config-driven (counterpart of
``m3l_tpu/cli/evaluate.py``).

Trains a probe over a pretrained encoder (frozen, or fine-tuned with ``task.train_encoder=true``)
with the Trainer, then runs the task's TacBench evaluator and prints its metrics as JSON.

Usage:
    python -m m3l_tpu_torch.cli.evaluate --config config/experiment/downstream_task/force/digit_mae.yaml \
        --task force --data buffer.pkl task.checkpoint_encoder=outputs/small/last.ckpt

Without ``--data`` it trains on ``--synthetic N`` random frames with random labels (smoke runs).
``--device`` picks where the encoder, the probe and the Trainer run (default: the card; ``cpu``
only when asked). An f32 encoder trains and evaluates with TF32 off (``utils.device.f32_numerics``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..utils.config import instantiate, load_config
from ..utils.device import f32_numerics

_EVALUATORS = {
    "force": "TestForceSL",
    "slip": "TestSlipSL",
    "pose": "TestPoseSL",
    "grasp": "TestGraspSL",
    "textile": "TestTextileSL",
}
MODULE_KEYS = ("checkpoint_encoder", "encoder_type", "train_encoder", "num_classes")  # of the config's task block


def synthetic_task_buffer(task: str, n: int, size: int, rng: np.random.Generator) -> dict:
    """``n`` random uint8 frames of ``size`` x ``size`` x 3 with random labels of ``task``."""
    buf = {"frames": rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8)}
    if task == "force":
        buf["force"] = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    elif task == "slip":
        buf["slip"] = rng.integers(0, 2, n)
    elif task == "pose":
        buf["pose"] = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    elif task == "grasp":
        buf["grasp"] = rng.integers(0, 2, n)
    elif task == "textile":
        buf["textile"] = rng.integers(0, 20, n)
    return buf


def main(argv=None):
    from .. import eval as tacbench
    from ..data import DataLoader, make_task_dataset
    from ..train.builders import build_task_module

    parser = argparse.ArgumentParser("m3l-tpu-torch evaluate")
    parser.add_argument("--config", type=str, default="config/default.yaml")
    parser.add_argument("--task", type=str, required=True, choices=sorted(_EVALUATORS))
    parser.add_argument("--data", type=str, default=None, help="pickled task buffer; synthetic if omitted")
    parser.add_argument("--synthetic", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda", help="torch device to train and evaluate on (default: the card)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    f32_numerics(cfg["model"]["encoder"].get("compute_dtype", "float32"))
    trainer = instantiate(cfg["trainer"], device=args.device)
    encoder = instantiate(cfg["model"]["encoder"])
    task_cfg = cfg.get("task", {})
    module = build_task_module(encoder, args.task, **{k: v for k, v in task_cfg.items() if k in MODULE_KEYS})

    data_cfg = cfg.get("data", {})
    size = cfg["model"]["encoder"].get("img_size", [224, 224])[0]
    source = args.data or synthetic_task_buffer(args.task, args.synthetic, size, np.random.default_rng(0))
    ds = make_task_dataset(
        source,
        args.task,
        num_frames=data_cfg.get("num_frames", 2),
        frame_stride=data_cfg.get("frame_stride", 1),
        out_format=data_cfg.get("out_format", "concat_ch_img"),
    )
    loader = DataLoader(ds, batch_size=min(data_cfg.get("batch_size", 64), max(len(ds) // 2, 1)))

    trainer.max_epochs = args.epochs
    trainer.fit(module, loader)

    batch_keys = ("image", "force") if getattr(module, "use_force", False) else ("image",)
    metrics = getattr(tacbench, _EVALUATORS[args.task])(module, batch_keys=batch_keys).evaluate(loader)
    print(json.dumps({k: v for k, v in metrics.items() if not isinstance(v, list)}, default=str))
    return metrics


if __name__ == "__main__":
    main()
