"""Geometry-aware force-field SSL (counterpart of ``m3l_tpu/tasks/forcefield_geometry.py``): DIGIT
intrinsics, depth reprojection, pose estimation, and the monodepth-style view-synthesis objective.

* :func:`grid_sample` is the JAX gather (border clipping of each corner index, weights from the
  unclipped coordinates, ``align_corners=True`` scaling), not ``F.grid_sample``.
* The axis-angle norm and the photometric p-norm keep their eps inside the square root, so the
  gradient at an exactly-zero vector is finite.
* Trainable set: the pose ResNet always trains; only ``model_task.encoder`` (the ViT) is frozen
  unless ``train_encoder`` (a filter by the name "encoder" alone would freeze both).
* :func:`plot_quiver`, :func:`plot_quiver_img` and
  :meth:`GeometricForceFieldModule.render_overlay_video` are host-only: matplotlib, PIL and cv2
  are imported where they are called.

Data contract: ``image`` = concat(frame_t, frame_{t-1}) and ``image_bg`` = concat(frame_t,
background), 6 channels, NHWC.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.baselines import ResNet18Encoder
from ..nn.layers import Conv2d
from ..ssl.module import SSLModule, as_float_image
from .forcefield import ForceFieldDecoder, _pixel_grid, bilinear_gather, ssim, warp
from .modules import batch_rmse
from .sl_module import load_encoder_from_checkpoint


# ---------------------------------------------------------------------- #
# intrinsics and projective geometry
# ---------------------------------------------------------------------- #
def digit_intrinsics(height: int = 224, width: int = 224, yfov_deg: float = 60.0) -> tuple[torch.Tensor, torch.Tensor]:
    """DIGIT pinhole intrinsics: the 4 x 4 K and its inverse (f32)."""
    fx = height * 0.5 / np.tan(np.deg2rad(yfov_deg) * 0.5)
    fy = fx
    cx, cy = width / 2.0, height / 2.0
    k = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    return torch.from_numpy(k), torch.from_numpy(np.linalg.inv(k))


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled disparity, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled = min_disp + (max_disp - min_disp) * disp
    return scaled, 1.0 / scaled


def backproject_depth(depth: torch.Tensor, inv_k: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W) -> homogeneous camera points (B, 4, H*W)."""
    b, h, w = depth.shape
    ys, xs = _pixel_grid(h, w, depth.device)
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(h * w, device=depth.device)], dim=0)  # (3, HW)
    cam = depth.reshape(b, 1, -1) * (inv_k[:3, :3] @ pix)[None]
    return torch.cat([cam, torch.ones(b, 1, h * w, device=depth.device)], dim=1)


def project_3d(points: torch.Tensor, k: torch.Tensor, t: torch.Tensor, height: int, width: int, eps: float = 1e-7) -> torch.Tensor:
    """Camera points (B, 4, H*W) and poses T (B, 4, 4) -> normalised [-1, 1] pixel coordinates
    (B, H, W, 2)."""
    b = points.shape[0]
    p = torch.einsum("ij,bjk->bik", k, t)[:, :3]  # (B, 3, 4)
    cam = torch.einsum("bij,bjn->bin", p, points)  # (B, 3, HW)
    pix = cam[:, :2] / (cam[:, 2:3] + eps)
    pix = pix.reshape(b, 2, height, width).permute(0, 2, 3, 1)
    scale = torch.tensor([width - 1.0, height - 1.0], device=points.device)
    return (pix / scale - 0.5) * 2.0


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (B, H, W, C) at normalised [-1, 1] coordinates (B, H', W', 2): border
    padding, ``align_corners=True``."""
    h, w = img.shape[1:3]
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    return bilinear_gather(img, x, y)


# ---------------------------------------------------------------------- #
# axis-angle pose algebra
# ---------------------------------------------------------------------- #
def _homogeneous(r3: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) rotation and (B, 3) translation -> (B, 4, 4)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=r3.device).expand(r3.shape[0], 1, 4)
    return torch.cat([torch.cat([r3, t[:, :, None]], dim=2), bottom], dim=1)


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """(B, 3) axis-angle -> (B, 4, 4) rotation."""
    angle = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-14)  # (B, 1)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    cc = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    row0 = torch.stack([x * x * cc + ca, x * y * cc - z * sa, z * x * cc + y * sa], -1)
    row1 = torch.stack([x * y * cc + z * sa, y * y * cc + ca, y * z * cc - x * sa], -1)
    row2 = torch.stack([z * x * cc - y * sa, y * z * cc + x * sa, z * z * cc + ca], -1)
    return _homogeneous(torch.stack([row0, row1, row2], dim=1), torch.zeros_like(vec))


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> (B, 4, 4) translation."""
    return _homogeneous(torch.eye(3, device=t.device).expand(t.shape[0], 3, 3), t)


def transformation_from_parameters(axisangle: torch.Tensor, translation: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """(axis-angle, translation) -> the 4 x 4 pose."""
    r = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        r = r.transpose(1, 2)
        t = -t
    tm = get_translation_matrix(t)
    return torch.einsum("bij,bjk->bik", r, tm) if invert else torch.einsum("bij,bjk->bik", tm, r)


# ---------------------------------------------------------------------- #
# the pose network
# ---------------------------------------------------------------------- #
class PoseDecoder(nn.Module):
    """Monodepth2's pose decoder over the encoder's last NHWC feature map: squeeze 1 x 1 -> 3 convs
    -> global mean -> 0.01 * (axis-angle, translation) per predicted frame."""

    def __init__(self, num_ch_enc: int, num_frames_to_predict_for: int = 2, *, dtype=torch.float32):
        super().__init__()
        self.squeeze = Conv2d(num_ch_enc, 256, 1, dtype=dtype)
        self.pose0 = Conv2d(256, 256, 3, 1, 1, dtype=dtype)
        self.pose1 = Conv2d(256, 256, 3, 1, 1, dtype=dtype)
        self.pose2 = Conv2d(256, 6 * num_frames_to_predict_for, 1, dtype=dtype)
        self.num_frames = num_frames_to_predict_for

    def forward(self, feat: torch.Tensor):
        x = F.relu(self.squeeze(feat.permute(0, 3, 1, 2)))
        x = F.relu(self.pose0(x))
        x = F.relu(self.pose1(x))
        x = self.pose2(x)
        out = 0.01 * torch.mean(x, dim=(2, 3)).float()  # (B, 6 * frames)
        out = out.reshape(-1, self.num_frames, 6)
        return out[..., :3], out[..., 3:]  # axis-angle, translation


class PoseEstimator(nn.Module):
    """The relative pose between the two stacked frames, passed in temporal order
    [frame_{-1}, frame_0]; the pose is inverted for the backward frame."""

    def __init__(self, *, dtype=torch.float32):
        super().__init__()
        self.encoder = ResNet18Encoder(in_chans=6, dtype=dtype)
        self.decoder = PoseDecoder(self.encoder.embed_dim, num_frames_to_predict_for=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> dict:
        """x: (B, H, W, 6) = concat(frame_0, frame_{-1})."""
        pose_in = torch.cat([x[..., 3:6], x[..., 0:3]], dim=-1)  # temporal order
        axisangle, translation = self.decoder(self.encoder.forward_spatial(pose_in))
        t = transformation_from_parameters(axisangle[:, 0], translation[:, 0], invert=True)
        return {"axisangle": axisangle, "translation": translation, "cam_T_cam": t}


# ---------------------------------------------------------------------- #
# the SSL losses (NHWC)
# ---------------------------------------------------------------------- #
def reprojection_loss(pred: torch.Tensor, target: torch.Tensor, with_ssim: bool = True) -> torch.Tensor:
    """Per-pixel reprojection error (B, H, W, 1): 0.85 SSIM + 0.15 L1 with SSIM, else L1."""
    l1 = torch.mean(torch.abs(target - pred), dim=-1, keepdim=True)
    if not with_ssim:
        return l1
    return 0.85 * torch.mean(ssim(pred, target), dim=-1, keepdim=True) + 0.15 * l1


def edge_aware_smoothness(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-weighted disparity smoothness."""
    gd_x = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    gd_y = torch.abs(disp[:, :-1] - disp[:, 1:])
    gi_x = torch.mean(torch.abs(img[:, :, :-1] - img[:, :, 1:]), dim=-1, keepdim=True)
    gi_y = torch.mean(torch.abs(img[:, :-1] - img[:, 1:]), dim=-1, keepdim=True)
    return torch.mean(gd_x * torch.exp(-gi_x)) + torch.mean(gd_y * torch.exp(-gi_y))


def flow_smooth_1st_loss(flow: torch.Tensor, image: torch.Tensor, alpha: float = 0.0) -> torch.Tensor:
    """First-order flow smoothness of (B, H, W, 2)."""
    img_dx = image[:, :, 1:] - image[:, :, :-1]
    img_dy = image[:, 1:] - image[:, :-1]
    w_x = torch.exp(-torch.mean(torch.abs(img_dx * alpha), dim=-1, keepdim=True))
    w_y = torch.exp(-torch.mean(torch.abs(img_dy * alpha), dim=-1, keepdim=True))
    dx = flow[:, :, 1:] - flow[:, :, :-1]
    dy = flow[:, 1:] - flow[:, :-1]
    return torch.mean(w_x * torch.abs(dx) / 2.0) + torch.mean(w_y * torch.abs(dy) / 2.0)


def robust_photometric_loss(im: torch.Tensor, im_warp: torch.Tensor, p: int = 2, eps: float = 1e-8) -> torch.Tensor:
    """The mean p-norm over channels; for p = 2 with eps inside the square root."""
    if p == 2:
        d = im - im_warp
        return torch.mean(torch.sqrt(torch.sum(d * d, dim=-1) + eps * eps))
    return torch.mean(torch.linalg.vector_norm(im - im_warp, ord=p, dim=-1))


def compute_sl_force(normal: torch.Tensor, shear: torch.Tensor) -> torch.Tensor:
    """The field integrated into a 3-DoF force: normal (B, H, W), shear (B, H, W, 2) -> (B, 3)
    [f_x, f_y, f_z]."""
    denom = float(normal.shape[1] * normal.shape[2])
    f_x = shear[..., 0].sum(dim=(1, 2)) / denom
    f_y = shear[..., 1].sum(dim=(1, 2)) / denom
    f_z = normal.sum(dim=(1, 2)) / denom
    return torch.stack([f_x, f_y, f_z], dim=1)


def _flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """:func:`warp`, with samples from outside the image zeroed."""
    h, w = img.shape[1:3]
    out = warp(img, flow)
    ys, xs = _pixel_grid(h, w, img.device)
    x = xs[None] + flow[..., 0]
    y = ys[None] + flow[..., 1]
    valid = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)).float()
    return out * valid[..., None]


def _smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


# ---------------------------------------------------------------------- #
# the geometry-aware SSL module
# ---------------------------------------------------------------------- #
class GeometricForceFieldModule(SSLModule):
    """Self-supervised normal + shear field training with pose estimation and depth reprojection.

    Normal branch: the normal channel is sigmoid disparity on the background view, turned into
    depth, backprojected with the DIGIT inverse intrinsics, reprojected through the estimated
    relative pose to warp the source frame onto the target; SSIM + L1 reprojection and edge-aware
    disparity smoothness, x5. Shear branch: the shear channels (x ``scale_flow``) are an optical
    flow warping frame_{-1} -> frame_0; robust photometric + first-order smoothness losses.

    Under a mesh every loss term is a mean over rows (the disparity's mean and the SL force are
    per sample), so the loss and each loss scalar are this rank's mean over dp; the SL force's
    RMSEs take their squared errors over the dp group first. The pose ResNet's BatchNorm reads
    only its running statistics, as JAX's (``use_running_average=True``): no batch statistic."""

    def __init__(
        self,
        model_task: ForceFieldDecoder,
        *,
        min_depth: float = 0.1,
        max_depth: float = 100.0,
        disparity_smoothness: float = 1e-3,
        scale_flow: float = 20.0,
        with_ssim: bool = True,
        with_sl_supervision: bool = False,
        with_mask_supervision: bool = False,
        train_encoder: bool = False,
        checkpoint_encoder: Optional[str] = None,
        encoder_type: str = "mae",
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 1,
        dtype=torch.float32,
    ):
        super().__init__()
        self.model_task = model_task
        self.pose_estimator = PoseEstimator(dtype=dtype)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.disparity_smoothness = disparity_smoothness
        self.scale_flow = scale_flow
        self.with_ssim = with_ssim
        self.with_sl_supervision = with_sl_supervision
        self.with_mask_supervision = with_mask_supervision
        self.train_encoder = train_encoder
        self.base_lr = base_lr
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        model_task.frozen_encoder = not train_encoder
        k, inv_k = digit_intrinsics(*model_task.img_size)
        self.register_buffer("k", k, persistent=False)
        self.register_buffer("inv_k", inv_k, persistent=False)
        if checkpoint_encoder is not None:
            load_encoder_from_checkpoint(model_task.encoder, checkpoint_encoder, encoder_type)

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        """Every parameter but the ViT encoder's (``model_task.encoder``), unless it is fine-tuned;
        the pose estimator's ResNet always trains."""
        return {n: p for n, p in self.named_parameters() if self.train_encoder or not n.startswith("model_task.encoder.")}

    def forward_fields(self, image: torch.Tensor, image_bg: torch.Tensor):
        """Two decoder passes with shared weights: the normal (disparity) on ``image_bg``, the
        shear (flow, x ``scale_flow``) on ``image``."""
        disp = self.model_task(image_bg)[..., :1]
        shear = self.model_task(image)[..., 1:] * self.scale_flow
        return disp, shear

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = as_float_image(batch["image"])  # (B, H, W, 6): frame_0 ++ frame_{-1}
        x_bg = as_float_image(batch.get("image_bg", batch["image"]))
        frame0, frame_m1 = x[..., 0:3].float(), x[..., 3:6].float()
        h, w = frame0.shape[1:3]

        disp, shear = self.forward_fields(x, x_bg)
        poses = self.pose_estimator(x)

        # the normal branch: depth reprojection
        _, depth = disp_to_depth(disp[..., 0], self.min_depth, self.max_depth)
        pix = project_3d(backproject_depth(depth, self.inv_k), self.k, poses["cam_T_cam"], h, w)
        pred = grid_sample(frame_m1, pix)
        reproj = torch.mean(reprojection_loss(pred, frame0, self.with_ssim))
        mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
        smooth_n = edge_aware_smoothness(disp / (mean_disp + 1e-7), frame0)
        normal_loss = (reproj + self.disparity_smoothness * smooth_n) * 5.0

        # the shear branch: optical-flow warp
        photo = robust_photometric_loss(frame_m1, _flow_warp(frame0, shear))
        shear_loss = photo + 0.05 * flow_smooth_1st_loss(shear, frame0)

        loss = normal_loss + shear_loss
        aux = {"normal_loss": normal_loss, "shear_loss": shear_loss, "reprojection_loss": reproj, "photometric_loss": photo, "warped_color": pred}

        if self.with_mask_supervision and "mask" in batch:
            mask = batch["mask"][..., None].float()
            normal_m = _smooth_l1(disp, mask * disp)
            loss = loss + normal_m
            aux["normal_loss"] = aux["normal_loss"] + normal_m

        rmse = {}
        if self.with_sl_supervision and "force" in batch:
            sl_loss, rmse = self.sl_force_terms(disp, shear, batch["force"])
            loss = loss + sl_loss

        # each loss is a mean over rows: this rank's share of it (the RMSEs are shares already)
        aux = {k: v if k == "warped_color" else self.share(v) for k, v in aux.items()}
        loss = self.share(loss)
        return loss, {**aux, **rmse, "loss": loss}

    def sl_force_terms(self, disp: torch.Tensor, shear: torch.Tensor, force: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The SL supervision on the integrated force: its smooth-L1 over the rows (a mean, shared
        by the caller) and ``rmse_f{x,y,z}``, each this rank's share of the global batch's RMSE."""
        y_pred = compute_sl_force(disp[..., 0], shear)
        y_gt = force.float()
        rmse = batch_rmse((y_pred - y_gt) ** 2, self.mesh)
        return _smooth_l1(y_pred, y_gt), {f"rmse_f{a}": self.share(rmse[i]) for i, a in enumerate("xyz")}

    def encode(self, x):
        return x

    def predict(self, x):
        field = self.model_task(as_float_image(x))
        return torch.cat([field[..., :1], field[..., 1:] * self.scale_flow], dim=-1)

    def render_overlay_video(self, images: np.ndarray, path: str, *, spacing: int = 16, fps: int = 10, max_frames: int = 50) -> str:
        """A quiver-overlay video of the predicted fields over a batch of tactile frames (host
        side: matplotlib, PIL and cv2)."""
        from ..utils.video import write_video

        device = next(self.parameters()).device
        with torch.no_grad():
            field = self.predict(torch.as_tensor(np.asarray(images[:max_frames]), device=device)).float().cpu().numpy()
        frames = []
        for i in range(min(len(images), max_frames)):
            rgb = np.asarray(images[i][..., :3], np.float32)
            rgb = (rgb - rgb.min()) / max(rgb.max() - rgb.min(), 1e-6)
            normal = field[i, ..., 0]
            frames.append(np.asarray(plot_quiver_img(rgb, field[i, ..., 1:], normal, np.ones(normal.shape), spacing))[..., :3])
        return write_video(frames, path, fps=fps)


# ---------------------------------------------------------------------- #
# quiver visualisations (host-side numpy and matplotlib)
# ---------------------------------------------------------------------- #
def _figure_array(fig) -> np.ndarray:
    """The figure as an RGB(A) array, through a PNG in memory; closes it."""
    import io

    import PIL.Image
    from matplotlib import pyplot as plt

    with io.BytesIO() as buff:
        fig.savefig(buff, format="png", bbox_inches="tight", pad_inches=0)
        buff.seek(0)
        img = np.array(PIL.Image.open(buff))
    plt.close(fig)
    return img


def _quiver_grid(shear: np.ndarray, normal: np.ndarray, spacing: int, margin: int):
    """Sample positions x, y and the shear components u, v and normal m there."""
    h, w = shear.shape[:2]
    nx = max(int((w - 2 * margin) / spacing), 1)
    ny = max(int((h - 2 * margin) / spacing), 1)
    x = np.linspace(margin, w - margin - 1, nx, dtype=np.int64)
    y = np.linspace(margin, h - margin - 1, ny, dtype=np.int64)
    sub = shear[np.ix_(y, x)]
    return x, y, sub[:, :, 0], sub[:, :, 1], normal[np.ix_(y, x)]


def _axes():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt.subplots()


def plot_quiver(shear: np.ndarray, normal: np.ndarray, spacing: int, margin: int = 0, **kwargs) -> np.ndarray:
    """Sparse arrows of the shear field coloured by the normal field; an RGB(A) image array."""
    fig, ax = _axes()
    x, y, u, v, m = _quiver_grid(shear, normal, spacing, margin)
    rad_max, eps = 20.0, 1e-5
    u = np.clip(u / (rad_max + eps), -1.0, 1.0)
    v = np.clip(v / (rad_max + eps), -1.0, 1.0)
    uu, vv = u.copy(), v.copy()
    r = np.sqrt(u**2 + v**2)
    uu[r < 0.01] = 0.0
    vv[r < 0.01] = 0.0
    uu = uu / (np.abs(uu).max() + eps)
    vv = vv / (np.abs(vv).max() + eps)
    kwargs = {**dict(angles="uv", scale_units="dots", scale=0.025, width=0.007, cmap="inferno", edgecolor="face"), **kwargs}
    ax.quiver(y, x, uu, -vv, m, **kwargs)
    ax.set_ylim(sorted(ax.get_ylim(), reverse=True))
    ax.set_facecolor("black")
    ax.set_xticks([])
    ax.set_yticks([])
    return _figure_array(fig)


def plot_quiver_img(img: np.ndarray, shear: np.ndarray, normal: np.ndarray, mask: np.ndarray, spacing: int, margin: int = 0, **kwargs) -> np.ndarray:
    """The quiver overlaid on the tactile image."""
    fig, ax = _axes()
    x, y, u, v, m = _quiver_grid(shear, normal, spacing, margin)
    rad_max, eps = 100.0, 1e-5
    kwargs = {**dict(angles="xy", scale_units="xy", cmap="gnuplot", width=0.005, clim=(0, 1)), **kwargs}
    ax.imshow(img)
    ax.quiver(x, y, u / (rad_max + eps), v / (rad_max + eps), m, **kwargs)
    ax.set_ylim(sorted(ax.get_ylim(), reverse=True))
    ax.set_aspect("equal")
    ax.set_facecolor("black")
    ax.set_xticks([])
    ax.set_yticks([])
    return _figure_array(fig)
