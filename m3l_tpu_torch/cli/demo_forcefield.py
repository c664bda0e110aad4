"""Live force-field demo (counterpart of ``m3l_tpu/cli/demo_forcefield.py``).

Captures frames from a DIGIT/GelSight-style sensor (any cv2 camera), runs the force-field decoder
and overlays the predicted normal map and shear quiver. With no camera (headless hosts) use
``--source file.mp4``, ``--source synthetic`` (a moving blob, for an untrained smoke run) or
``--source dataset`` (a fresh synthetic DIGIT trajectory from the training renderer). With
``--module_ckpt`` the demo restores a trained GeometricForceFieldModule (a Trainer ``last.ckpt``)
and runs its two-pass ``forward_fields`` as the live path does: the background gel image is
captured once at start-up and concatenated into ``image_bg`` for every frame.

The JAX flags, and ``--device`` (default: the card; ``cpu`` only when asked). An f32 ``--dtype``
runs with TF32 off (``utils.device.f32_numerics``). cv2 is imported by :func:`main` and the
sources that need it, not by this module.

    python -m m3l_tpu_torch.cli.demo_forcefield --source synthetic --frames 30 --out demo.mp4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..train.builders import _seeded
from ..utils.device import f32_numerics, resolve_device


class _DatasetSource:
    """Replays a synthetic DIGIT trajectory (the renderer the force-field stack trains on) and
    exposes the clean gel background, as a real rig does."""

    def __init__(self, size: int, seed: int = 99):
        from ..data.synthetic import synth_digit_trajectories

        data = synth_digit_trajectories(2, 60, size=size, seed=seed)
        self.frames = data["frames"]
        self.tid = data["traj_id"]
        self.bgs = data["bg_frames"]
        self.i = 0

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        f = self.frames[self.i]
        self.i += 1
        return True, np.ascontiguousarray(f[..., ::-1])  # RGB -> cv2 BGR

    def background(self):
        # self.i already points past the frame last read()
        return np.ascontiguousarray(self.bgs[self.tid[max(self.i - 1, 0)]][..., ::-1])

    def release(self):
        pass


class _SyntheticSource:
    """A blob moving with the wall clock."""

    def __init__(self, size: int):
        self.size = size

    def read(self):
        t = time.time()
        yy, xx = np.mgrid[0 : self.size, 0 : self.size].astype(np.float32) / self.size
        blob = np.exp(-(((xx - 0.5 - 0.2 * np.sin(t)) ** 2 + (yy - 0.5) ** 2) / 0.02))
        img = np.stack([blob, blob * 0.5, 1 - blob], -1)
        return True, (img * 255).astype(np.uint8)

    def release(self):
        pass


def _open_source(source: str, size: int):
    import cv2

    if source == "dataset":
        return _DatasetSource(size)
    if source == "synthetic":
        return _SyntheticSource(size)
    cap = cv2.VideoCapture(int(source) if source.isdigit() else source)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video source {source!r}; use --source synthetic on headless hosts")
    return cap


def overlay_field(frame: np.ndarray, field: np.ndarray, stride: int = 8) -> np.ndarray:
    import cv2

    h, w = frame.shape[:2]
    normal = (field[..., 0] * 255).astype(np.uint8)
    heat = cv2.applyColorMap(normal, cv2.COLORMAP_JET)
    out = cv2.addWeighted(frame, 0.6, heat, 0.4, 0)
    for y in range(0, h, stride):
        for x in range(0, w, stride):
            dx, dy = field[y, x, 1] * stride, field[y, x, 2] * stride
            cv2.arrowedLine(out, (x, y), (int(x + dx), int(y + dy)), (255, 255, 255), 1, tipLength=0.3)
    return out


def _build_module_structure(args, size: int):
    """The force-field experiment's GeometricForceFieldModule (a ViT of ``args.dim`` x
    ``args.depth`` with ``args.heads`` heads and one register token, patch 16, 6 channels at
    ``size`` x ``size``; the decoder at ``args.hooks`` and ``args.fusion_ch``), weights from seed 42,
    on the CPU."""
    from ..models.vit import VisionTransformer
    from ..tasks import ForceFieldDecoder, GeometricForceFieldModule

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    def build():
        enc = VisionTransformer(
            img_size=(size, size), patch_size=16, in_chans=6, embed_dim=args.dim, depth=args.depth, num_heads=args.heads,
            pos_embed_fn="sinusoidal", num_register_tokens=1, dtype=dtype,
        )
        hooks = tuple(int(h) for h in args.hooks.split(","))
        dec = ForceFieldDecoder(enc, hooks=hooks, fusion_ch=args.fusion_ch, dtype=dtype)
        return GeometricForceFieldModule(dec, dtype=dtype)

    return _seeded(42, build)


def _build_trained_module(args, size: int):
    """The module structure with a Trainer full-state ``last.ckpt`` (``payload["model"]``, the
    module's state dict, encoder included) restored."""
    from ..train.checkpoint import load_checkpoint

    module = _build_module_structure(args, size)
    module.load_state_dict(load_checkpoint(args.module_ckpt)["model"])
    return module


def main(argv=None):
    from ..models.vit import vit_tiny
    from ..tasks import ForceFieldDecoder
    from ..tasks.sl_module import load_encoder_from_checkpoint

    parser = argparse.ArgumentParser("m3l-tpu-torch forcefield demo")
    parser.add_argument("--source", type=str, default="synthetic", help="camera index, video file, 'synthetic', or 'dataset'")
    parser.add_argument("--checkpoint", type=str, default=None, help="SSL encoder ckpt (untrained-decoder smoke path)")
    parser.add_argument("--module_ckpt", type=str, default=None, help="trained GeometricForceFieldModule Trainer ckpt, e.g. runs/forcefield/ff_mae/last.ckpt")
    parser.add_argument("--encoder_type", type=str, default="mae")
    parser.add_argument("--dim", type=int, default=192)
    parser.add_argument("--depth", type=int, default=6)
    parser.add_argument("--heads", type=int, default=3)
    parser.add_argument("--hooks", type=str, default="1,3,4,5")
    parser.add_argument("--fusion_ch", type=int, default=64)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--size", type=int, default=None, help="default: 96 with --module_ckpt / dataset source, else 224")
    parser.add_argument("--frames", type=int, default=30, help="frames to process (0 = until q)")
    parser.add_argument("--out", type=str, default=None, help="write annotated video here instead of a window")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to run the model on (default: the card)")
    args = parser.parse_args(argv)
    size = args.size or (96 if (args.module_ckpt or args.source == "dataset") else 224)
    device = resolve_device(args.device)
    f32_numerics(args.dtype)

    import cv2

    def tensor(frames):
        """Channel-concatenated uint8 RGB frames -> a (1, H, W, C) f32 batch in [0, 1] on the device."""
        return torch.from_numpy(np.concatenate(frames, -1).astype(np.float32)[None] / 255.0).to(device)

    if args.module_ckpt:
        module = _build_trained_module(args, size).to(device).eval()
        scale_flow = float(module.scale_flow)

        @torch.no_grad()
        def predict_field(frame_rgb, prev_rgb, bg_rgb):
            # the training format (data/synthetic.py forcefield_windows):
            # image = [frame_0, frame_{-1}], image_bg = [frame_0, background]
            disp, shear = module.forward_fields(tensor([frame_rgb, prev_rgb]), tensor([frame_rgb, bg_rgb]))
            return np.concatenate([disp[0].float().cpu().numpy(), shear[0].float().cpu().numpy() / scale_flow], -1)
    else:
        enc = _seeded(0, lambda: vit_tiny(patch_size=16, img_size=(size, size), in_chans=6, pos_embed_fn="sinusoidal"))
        dec = _seeded(1, lambda: ForceFieldDecoder(enc))
        if args.checkpoint:
            load_encoder_from_checkpoint(enc, args.checkpoint, args.encoder_type)
        dec = dec.to(device).eval()

        @torch.no_grad()
        def predict_field(frame_rgb, prev_rgb, bg_rgb):
            return dec(tensor([prev_rgb, frame_rgb]))[0].float().cpu().numpy()

    cap = _open_source(args.source, size)
    writer = None
    prev = None
    bg = None
    n = 0
    try:
        while args.frames == 0 or n < args.frames:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.resize(frame, (size, size))
            if prev is None:
                prev = frame
            if hasattr(cap, "background"):
                bg = cap.background()  # the true clean gel background, per trajectory
            elif bg is None:
                bg = frame  # the background gel image, captured once at start-up
            rgb = lambda f: f[..., ::-1]  # noqa: E731 -- cv2 frames are BGR; the network trained on RGB
            field = predict_field(rgb(frame), rgb(prev), rgb(bg))
            vis = overlay_field(frame, field)
            if args.out:
                if writer is None:
                    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"), 15, (size, size))
                writer.write(vis)
            else:
                cv2.imshow("forcefield", vis)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            prev = frame
            n += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    print(f"processed {n} frames")
    return n


if __name__ == "__main__":
    main()
