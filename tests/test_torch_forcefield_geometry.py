"""The port's geometry-aware force-field stack (tasks/forcefield_geometry.py) against the JAX package
on the CPU: the intrinsics and projective geometry, grid_sample at and beyond the image edges, the
axis-angle algebra, the pose network (BatchNorm statistics carried over), the losses, and one
GeometricForceFieldModule step built from config/experiment/downstream_task/forcefield/digit_dino.yaml
(ViT-tiny at depth 4 on 32 x 32 x 6, hooks (0, 1, 2, 3), fusion 16).

Tolerances: geometry, gathers and losses alone at 1e-5 relative; with a convolution on the path at
rtol 2e-4 (gradients plus 1e-5 of the largest one).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, TOL, carry, flat_variables, images, t
from m3l_tpu.tasks import forcefield_geometry as jgeo
from m3l_tpu_torch.kernels import LAUNCHES, reset_launches
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.tasks import forcefield_geometry as geo
from m3l_tpu_torch.train import Trainer
from test_torch_baselines import random_batch_stats
from test_torch_forcefield import check_grads, edge_flow, loss_and_grads, module_pair
from test_torch_ssl_dino import count_attention
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jt(x):
    return jnp.asarray(np.asarray(x))


def test_digit_intrinsics_equal_jax():
    k, inv_k = geo.digit_intrinsics(224, 160)
    jk, jinv = jgeo.digit_intrinsics(224, 160)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(inv_k.numpy(), np.asarray(jinv))
    np.testing.assert_allclose((k @ inv_k).numpy(), np.eye(4), atol=1e-4)
    assert abs(k[0, 0].item() - 224 * 0.5 / np.tan(np.deg2rad(30))) < 1e-3


def test_disp_to_depth_equals_jax():
    disp = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    for a, b in zip(geo.disp_to_depth(t(disp), 0.1, 100.0), jgeo.disp_to_depth(jt(disp), 0.1, 100.0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    _, depth = geo.disp_to_depth(t(disp), 0.1, 100.0)
    assert abs(depth[0].item() - 100.0) < 1e-4 and abs(depth[-1].item() - 0.1) < 1e-4


def test_backproject_and_project_equal_jax():
    """Both against JAX under a random pose, and the identity-pose round trip to the pixel grid."""
    h, w = 12, 16
    k, inv_k = geo.digit_intrinsics(h, w)
    depth = 1.0 + images((2, h, w), seed=1) * 5.0
    points = geo.backproject_depth(t(depth), inv_k)
    jpoints = jgeo.backproject_depth(jt(depth), jt(inv_k))
    np.testing.assert_allclose(points.numpy(), np.asarray(jpoints), **TOL)
    rng = np.random.default_rng(2)
    pose = geo.transformation_from_parameters(t(rng.normal(size=(2, 3)).astype(np.float32) * 0.1), t(rng.normal(size=(2, 3)).astype(np.float32) * 0.05))
    pix = geo.project_3d(points, k, pose, h, w)
    np.testing.assert_allclose(pix.numpy(), np.asarray(jgeo.project_3d(jpoints, jt(k), jt(pose), h, w)), rtol=1e-5, atol=1e-5)
    ident = geo.project_3d(points, k, torch.eye(4).expand(2, 4, 4), h, w)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    np.testing.assert_allclose(ident[0, ..., 0].numpy(), (xs / (w - 1) - 0.5) * 2, atol=1e-3)
    np.testing.assert_allclose(ident[1, ..., 1].numpy(), (ys / (h - 1) - 0.5) * 2, atol=1e-3)


def test_grid_sample_equals_jax_at_and_beyond_the_edges():
    """Border clipping of each corner index with weights from the unclipped coordinates (as the JAX
    gather, not F.grid_sample): values and gradients to the image and the coordinates."""
    img = images((2, 8, 8, 3), seed=3)
    coords = edge_flow(4) / 5.0  # [-2.2, 2.2]: inside, on and beyond every edge
    coords[0, 0, 0] = [-1.0, -1.0]
    coords[0, 0, 1] = [1.0, 1.0]
    cot = images((2, 8, 8, 3), seed=5)
    ti, tc = t(img).requires_grad_(), t(coords).requires_grad_()
    out = geo.grid_sample(ti, tc)
    (out * t(cot)).sum().backward()
    want, vjp = jax.vjp(jgeo.grid_sample, jt(img), jt(coords))
    gi, gc = vjp(jt(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi), **TOL)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[0, 0, 0].detach().numpy(), img[0, 0, 0], **TOL)
    np.testing.assert_allclose(out[0, 0, 1].detach().numpy(), img[0, 7, 7], **TOL)
    far = geo.grid_sample(t(img[:1]), torch.full((1, 2, 2, 2), 5.0))
    np.testing.assert_allclose(far[0, 0, 0].numpy(), img[0, 7, 7], **TOL)  # far outside: the border pixel


def test_grid_sample_identity():
    img = images((1, 8, 8, 3), seed=6)
    xs, ys = np.meshgrid(np.arange(8), np.arange(8), indexing="xy")
    coords = np.stack([(xs / 7 - 0.5) * 2, (ys / 7 - 0.5) * 2], -1)[None].astype(np.float32)
    np.testing.assert_allclose(geo.grid_sample(t(img), t(coords)).numpy(), img, atol=1e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.5, 2.0], ids=["zero", "tiny", "half", "large"])
def test_axis_angle_algebra_equals_jax(scale):
    """rot_from_axisangle and transformation_from_parameters (both directions), values and
    gradients; at an exactly-zero axis-angle the gradient is finite (eps inside the square root)."""
    rng = np.random.default_rng(7)
    aa = (rng.normal(size=(3, 3)) * scale).astype(np.float32)
    tr = (rng.normal(size=(3, 3)) * 0.05).astype(np.float32)
    cot = rng.normal(size=(3, 4, 4)).astype(np.float32)
    for invert in (False, True):
        ta, tt = t(aa).requires_grad_(), t(tr).requires_grad_()
        out = geo.transformation_from_parameters(ta, tt, invert=invert)
        (out * t(cot)).sum().backward()
        want, vjp = jax.vjp(lambda a, b: jgeo.transformation_from_parameters(a, b, invert=invert), jt(aa), jt(tr))
        ga, gt = vjp(jt(cot))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt), rtol=1e-5, atol=1e-6)
        assert torch.isfinite(ta.grad).all()
    fwd = geo.transformation_from_parameters(t(aa), t(tr))
    bwd = geo.transformation_from_parameters(t(aa), t(tr), invert=True)
    np.testing.assert_allclose((fwd @ bwd).numpy(), np.broadcast_to(np.eye(4), (3, 4, 4)), atol=1e-5)


def test_rotation_about_z():
    r = geo.rot_from_axisangle(t(np.array([[0.0, 0.0, np.pi / 2]], np.float32)))
    np.testing.assert_allclose(r[0, :3, :3].numpy() @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-5)
    np.testing.assert_allclose(geo.rot_from_axisangle(torch.zeros(1, 3))[0].numpy(), np.eye(4), atol=1e-5)


def test_pose_estimator_equals_jax():
    j = random_batch_stats(jgeo.PoseEstimator(rngs=nnx.Rngs(0)))
    p = carry(j, geo.PoseEstimator())
    x = images((2, 64, 64, 6), seed=8)
    with torch.no_grad():
        out = p(t(x))
    want = j(jt(x))
    for k in ("axisangle", "translation", "cam_T_cam"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=1e-7, err_msg=k)
    assert out["axisangle"].shape == out["translation"].shape == (2, 2, 3)
    for b in range(2):
        r = out["cam_T_cam"][b, :3, :3].numpy()
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
        np.testing.assert_allclose(out["cam_T_cam"][b, 3].numpy(), [0, 0, 0, 1], atol=1e-6)


def test_compute_sl_force_equals_jax():
    normal, shear = images((2, 5, 6), seed=9), images((2, 5, 6, 2), seed=10) - 0.5
    np.testing.assert_allclose(geo.compute_sl_force(t(normal), t(shear)).numpy(), np.asarray(jgeo.compute_sl_force(jt(normal), jt(shear))), **TOL)
    f = geo.compute_sl_force(torch.ones(2, 4, 4), torch.stack([torch.full((2, 4, 4), 2.0), torch.full((2, 4, 4), -1.0)], -1))
    np.testing.assert_allclose(f.numpy(), np.tile([[2.0, -1.0, 1.0]], (2, 1)), atol=1e-6)


@pytest.mark.parametrize("name", ["reprojection_ssim", "reprojection_l1", "edge_aware", "flow_smooth", "photometric_p2", "photometric_p1", "flow_warp", "smooth_l1"])
def test_losses_equal_jax(name):
    a, b = images((2, 9, 8, 3), seed=11), images((2, 9, 8, 3), seed=12)
    flow = edge_flow(13)[:, :, :, :] * 0.5
    flow = np.concatenate([flow, flow[:, :1]], axis=1)  # (2, 9, 8, 2)
    disp = images((2, 9, 8, 1), seed=14)
    cases = {
        "reprojection_ssim": lambda m, x: m.reprojection_loss(x(a), x(b), True),
        "reprojection_l1": lambda m, x: m.reprojection_loss(x(a), x(b), False),
        "edge_aware": lambda m, x: m.edge_aware_smoothness(x(disp), x(a)),
        "flow_smooth": lambda m, x: m.flow_smooth_1st_loss(x(flow), x(a), alpha=0.5),
        "photometric_p2": lambda m, x: m.robust_photometric_loss(x(a), x(b)),
        "photometric_p1": lambda m, x: m.robust_photometric_loss(x(a), x(b), p=1),
        "flow_warp": lambda m, x: m._flow_warp(x(a), x(flow)),
        "smooth_l1": lambda m, x: m._smooth_l1(x(a) * 3.0, x(b)),
    }
    np.testing.assert_allclose(cases[name](geo, t).numpy(), np.asarray(cases[name](jgeo, jt)), rtol=1e-5, atol=1e-6)


def test_photometric_gradient_finite_on_identical_frames():
    im = t(images((2, 8, 8, 3), seed=15))
    w = torch.tensor(1.0, requires_grad=True)
    loss = geo.robust_photometric_loss(im, im * w)  # w = 1: an exactly-zero difference
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(w.grad)


def geo_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "image": images((2, 32, 32, 6), seed=seed),
        "image_bg": images((2, 32, 32, 6), seed=seed + 1),
        "mask": (rng.random((2, 32, 32)) > 0.5).astype(np.float32),
        "force": rng.random((2, 3), dtype=np.float32),
    }


SUPERVISED = ["task.with_sl_supervision=true", "task.with_mask_supervision=true"]


@pytest.mark.parametrize("train_encoder", [False, True], ids=["frozen", "finetuned"])
def test_geometric_module_step_equals_jax(train_encoder):
    """One GeometricForceFieldModule step from the config (mask and force supervision on): the loss,
    every scalar of aux, the warped colours and the trainable gradients. The pose ResNet trains
    either way; only the ViT is frozen."""
    ov = [f"task.train_encoder={str(train_encoder).lower()}", *SUPERVISED]
    j, p = module_pair(True, ov)
    random_batch_stats(j.pose_estimator)
    carry(j, p)
    jloss, jaux, jgrads, loss, aux = loss_and_grads(j, p, geo_batch(16))
    np.testing.assert_allclose(loss.item(), float(jloss), **CONV_TOL)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]), err_msg=k, **CONV_TOL)
    names = p.trainable_parameters()
    assert any(n.startswith("pose_estimator.encoder.") for n in names)
    assert any(n.startswith("model_task.encoder.") for n in names) == train_encoder
    check_grads(p, module_pair(True, ov)[1], flat_variables(j), jgrads)


def test_predict_and_fields_equal_jax():
    j, p = module_pair(True)
    x = images((2, 32, 32, 6), seed=18)
    with torch.no_grad():
        got = p.predict(t(x))
        disp, shear = p.forward_fields(t(x), t(x[::-1].copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(j.predict(jt(x))), **CONV_TOL)
    jd, js = j.forward_fields(jt(x), jt(x[::-1].copy()))
    np.testing.assert_allclose(disp.numpy(), np.asarray(jd), **CONV_TOL)
    np.testing.assert_allclose(shear.numpy(), np.asarray(js), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("train_encoder,launches", [(False, {fa.KERNEL: 8}), (True, {fa.KERNEL: 8, fa.BWD_KERNEL: 8})], ids=["frozen", "finetuned"])
def test_attention_launches_per_step(monkeypatch, train_encoder, launches):
    """Two decoder passes (forward_fields), each through every encoder block (depth 4 here: 24 + 0
    frozen and 24 + 24 fine-tuned at ViT-small)."""
    count_attention(monkeypatch)
    _, p = module_pair(True, [f"task.train_encoder={str(train_encoder).lower()}"])
    reset_launches()
    loss, _ = p.training_loss({k: t(v) for k, v in geo_batch(19).items()}, None, 0)
    loss.backward()
    assert dict(LAUNCHES) == launches
    reset_launches()


def test_trainer_keeps_the_vit_and_trains_the_pose_network():
    _, p = module_pair(True, SUPERVISED)
    before = {k: v.clone() for k, v in p.state_dict().items()}
    batches = [{k: t(v) for k, v in geo_batch(20 + 2 * i).items()} for i in range(2)]
    hist = Trainer(max_epochs=1, verbose=0, device="cpu").fit(p, batches)
    assert np.isfinite(hist[-1]["train_loss"])
    for k, v in p.state_dict().items():
        if k.startswith("model_task.encoder."):
            assert torch.equal(v, before[k]), k
    assert any(not torch.equal(v, before[k]) for k, v in p.state_dict().items() if k.startswith("pose_estimator.encoder.") and k.endswith("weight"))
    for k in ("running_mean", "running_var"):  # BatchNorm's statistics never move
        assert torch.equal(p.pose_estimator.encoder.stem.bn.state_dict()[k], before[f"pose_estimator.encoder.stem.bn.{k}"])


def test_uint8_windows_equal_their_float_form():
    _, p = module_pair(True)
    batch = geo_batch(24)
    u8 = {k: (v * 255).astype(np.uint8) if k.startswith("image") else v for k, v in batch.items()}
    f32 = {k: v.astype(np.float32) / 255.0 if k.startswith("image") else v for k, v in u8.items()}
    with torch.no_grad():
        a, _ = p.training_loss({k: t(v) for k, v in u8.items()}, None, 0)
        b, _ = p.training_loss({k: t(v) for k, v in f32.items()}, None, 0)
    assert a.item() == b.item()


def test_quiver_plots_and_overlay_video(tmp_path):
    rng = np.random.default_rng(0)
    shear = rng.normal(size=(32, 32, 2)).astype(np.float32) * 5
    normal = rng.random((32, 32)).astype(np.float32)
    assert geo.plot_quiver(shear, normal, spacing=8).ndim == 3
    assert np.asarray(geo.plot_quiver_img(rng.random((32, 32, 3)).astype(np.float32), shear, normal, np.ones((32, 32)), spacing=8)).ndim == 3
    _, p = module_pair(True)
    out = p.render_overlay_video(images((3, 32, 32, 6), seed=25), str(tmp_path / "overlay.mp4"), spacing=8, max_frames=3)
    assert os.path.getsize(out) > 0
