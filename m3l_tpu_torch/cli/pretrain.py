"""Config-driven SSL pretraining (counterpart of ``m3l_tpu/cli/pretrain.py``).

Usage:
    python -m m3l_tpu_torch.cli.pretrain --config config/experiment/mae_vit.yaml \
        model_size=small trainer.max_epochs=10 data.paths='[buf.pkl]'

``--synthetic N`` trains on N random frames when ``data.paths`` is empty (smoke runs).
``--device`` picks where the model trains (default: the card; ``cpu`` only when asked). An f32
encoder trains with TF32 off (``utils.device.f32_numerics``).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..utils.config import instantiate, load_config
from ..utils.device import f32_numerics


def build_dataloaders(cfg: dict, synthetic: int = 0):
    from ..data import DataLoader, VisionTactileDataset, load_pickle_dataset

    data_cfg = cfg.get("data", {})
    frames_list = []
    for path in data_cfg.get("paths", []) or []:
        buf = load_pickle_dataset(path)
        frames_list.append(np.asarray(buf["frames"] if "frames" in buf else next(iter(buf.values()))))
    if not frames_list:
        if not synthetic:
            raise SystemExit("no data.paths configured; pass --synthetic N for a smoke run")
        rng = np.random.default_rng(0)
        size = cfg["model"]["encoder"].get("img_size", [224, 224])[0]
        frames_list = [rng.integers(0, 255, (synthetic, size, size, 3), dtype=np.uint8)]
    datasets = [
        VisionTactileDataset(
            f,
            num_frames=data_cfg.get("num_frames", 2),
            frame_stride=data_cfg.get("frame_stride", 1),
            out_format=data_cfg.get("out_format", "concat_ch_img"),
            remove_background=data_cfg.get("remove_background", False),
        )
        for f in frames_list
    ]
    ds = datasets[0] if len(datasets) == 1 else _Concat(datasets)
    return DataLoader(ds, batch_size=data_cfg.get("batch_size", 64))


class _Concat:
    def __init__(self, datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - int(self._offsets[d])]


def main(argv=None):
    parser = argparse.ArgumentParser("m3l-tpu-torch pretrain")
    parser.add_argument("--config", type=str, default="config/default.yaml")
    parser.add_argument("--synthetic", type=int, default=0, help="use N synthetic frames (smoke runs)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to train on (default: the card)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    cfg = load_config(args.config, args.overrides)
    f32_numerics(cfg["model"]["encoder"].get("compute_dtype", "float32"))
    trainer = instantiate(cfg["trainer"], device=args.device)
    encoder = instantiate(cfg["model"]["encoder"])
    algorithm = instantiate(cfg["model"]["algorithm"])(encoder)
    loader = build_dataloaders(cfg, synthetic=args.synthetic)
    history = trainer.fit(algorithm, loader)
    return trainer, algorithm, history


if __name__ == "__main__":
    main()
