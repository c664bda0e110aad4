"""The SSL Trainer's mesh for DINO, DINOv2, I-JEPA, V-JEPA and VTDINO (m3l_tpu_torch/train/mesh.py,
the ``mesh`` arguments of m3l_tpu_torch/ssl/losses.py) on the CPU over gloo.

The contract is JAX's: a mesh run computes the single-process result on the global batch, so the
DINO centers, Sinkhorn-Knopp's sums, KoLeo's nearest neighbours and the iBOT and I-JEPA counts are
taken over the global batch. One spawned group of four ranks (dp 2 x mp 2, ``launch`` with a
timeout of its own) trains each family for one epoch of two steps of a global batch of 8 (four
rows a rank, one of the two heads), from JAX's weights under JAX's masks, and runs the
statistics' checks; meanwhile this process computes the references:

* (a) the port's single process on the global batch: each step's loss and logged scalars (rtol
  1e-5, atol 1e-6), and SINGLE_TOL's fixed bounds on each parameter's AdamW moments after each
  step, the trained parameters, the EMA teachers and the centers (the key third of each packed qkv
  bias apart: its gradient is zero analytically, so f32 noise, which Adam divides by its own size);
  each rank's attention calls the single process's at batch / dp and heads / mp; rank 0's
  ``last.ckpt`` resumes into one process bit for bit, teachers and centers included;
* (b) JAX's Trainer on ``make_mesh(8, mp=1)`` (GSPMD over the suite's 8 virtual CPU devices), the
  same masks injected: the first step's loss at rtol 2e-4 / atol 2e-5 (patch convolutions on the
  path);
* (c) each batch statistic from a rank's rows with the mesh against the same function on the global
  batch, within 1e-5 of the largest value, and the same function without the mesh on the rank's
  rows alone (what a mesh run must not compute) outside 2e-4 of it, so each check can fail.

Tiny widths: test_ssl_modules_train_on_dp_mesh's ViT (32 x 32, patch 8, dim 32, depth 1, 2 heads),
its DINO heads (32 wide, hidden 16, bottleneck 16) and I-JEPA predictor; DINO with the
reconstruction probe (256 wide, 8 heads); V-JEPA on two frames at tubelet 2; VTDINO on
tests/test_torch_vtdino.py's multimodal VTT. f32, warm-up 0 so the first steps move the weights.
"""
import concurrent.futures as futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import m3l_tpu.ssl.vjepa as jvjepa_module
from m3l_tpu import ssl as jssl
from m3l_tpu.models import MultimodalVTT as JVTT
from m3l_tpu.models.vit import VisionTransformer as JViT
from m3l_tpu.models.vit import vit_predictor as jvit_predictor
from m3l_tpu.ssl.masks import random_tube_masks as jrandom_tube_masks
from m3l_tpu.train import Trainer as JTrainer
from m3l_tpu.train.mesh import make_mesh as jmake_mesh
from jax_params import flat_variables
from m3l_tpu_torch.train import Trainer
from m3l_tpu_torch.train import mesh_workers as mw
from m3l_tpu_torch.train.checkpoint import load_checkpoint
from m3l_tpu_torch.train.mesh import launch
from m3l_tpu_torch.utils.convert import load_jax_params
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GROUP_TIMEOUT = 300  # seconds, the spawned group
BATCH, STEPS, LR = 8, 2, 1e-3
VIT = dict(img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=32, depth=1, num_heads=2, pos_embed_fn="sinusoidal")
VIDEO = dict(num_frames=2, tubelet_size=2)
PREDICTOR = dict(patch_size=8, embed_dim=32, depth=1, num_heads=2, img_size=(32, 32), in_chans=3)
HEADS = dict(dino_out_dim=32, dino_hidden_dim=16, dino_bottleneck_dim=16, num_local_masks=2)
MM = dict(image_size=(28, 28), tactile_size=(28, 28), image_patch_size=14, tactile_patch_size=14, dim=32, depth=1, heads=2, mlp_dim=64,
          num_register_tokens=1)
COMMON = dict(base_lr=LR, warmup_epochs=0)
# family: (the JAX module's class, encoder kwargs, predictor kwargs or None, module kwargs)
FAMILIES = {
    "dino": ("DINOModule", dict(VIT, num_register_tokens=1), None, dict(HEADS, with_reconstruction_probe=True)),
    "dinov2": ("DINOv2Module", dict(VIT, num_register_tokens=1), None, dict(HEADS, with_reconstruction_probe=False)),
    "ijepa": ("IJEPAModule", VIT, dict(PREDICTOR, num_mask_tokens=2), dict(num_target_masks=2)),
    "vjepa": ("VJEPAModule", dict(VIT, **VIDEO), dict(PREDICTOR, **VIDEO, num_mask_tokens=1), dict(mask_ratio=0.75)),
    "vtdino": ("VTDINOModule", MM, None, dict(HEADS, with_reconstruction_probe=False)),
}
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# set from readings (the largest of the five families in brackets): moments 3e-5 of their norm
# (3.031e-6), parameters 0.05 lr (1.173e-2) and 3e-4 of the single process's update of each
# (3.417e-5), teachers 2e-4 lr (1.490e-5), centers 1e-6 (1.192e-7), and the key third of each qkv
# bias 2 lr (9.704e-1: its gradient is f32 noise, which Adam makes a step of up to lr in each of
# the two runs)
SINGLE_TOL = dict(moment_rel=3e-5, param_per_lr=0.05, update_rel=3e-4, teacher_per_lr=2e-4, center_abs=1e-6, key_bias_per_lr=2.0)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_TOL, LOCAL_FLOOR = 1e-5, 2e-4
STAT_CHECKS = ["update_center cls", "update_center patch", "sinkhorn_knopp cls", "sinkhorn_knopp patches", "ibot_patch_loss_all_pairs",
               "koleo_loss", "koleo_loss gradient", "ijepa smooth-L1 normaliser", "dinov2 centering loss", "dinov2 centering centers",
               "dinov2 sinkhorn_knopp loss"]


def jax_module(family: str):
    name, enc, pred, kw = FAMILIES[family]
    encoder = JVTT(rngs=nnx.Rngs(0), **enc) if family == "vtdino" else JViT(rngs=nnx.Rngs(0), **enc)
    if pred is None:
        return getattr(jssl, name)(encoder, rngs=nnx.Rngs(1), **kw, **COMMON)
    return getattr(jssl, name)(encoder, jvit_predictor(enc["embed_dim"], rngs=nnx.Rngs(2), **pred), rngs=nnx.Rngs(1), **kw, **COMMON)


def batches(family: str) -> list:
    rng = np.random.default_rng(3)
    if family == "vtdino":
        return [{k: rng.random((BATCH, 28, 28, 3), dtype=np.float32) for k in ("image", "tactile1", "tactile2")} for _ in range(STEPS)]
    shape = (BATCH, 2, 32, 32, 3) if family == "vjepa" else (BATCH, 32, 32, 3)
    return [{"image": rng.random(shape, dtype=np.float32)} for _ in range(STEPS)]


def jax_masks(j, family: str, step: int):
    """Global masks for one step, drawn by the JAX module's own sampler."""
    key = jax.random.PRNGKey(100 + step)
    if family == "vjepa":
        return np.array(jrandom_tube_masks(key, BATCH, j.grid, j.mask_ratio, j.num_masks))
    return tuple(np.array(m) for m in j.sample_masks(key, BATCH))


def family_case(family: str, ckpt_dir: str):
    """The JAX module (centers randomised) and the port case of its weights, batches and masks."""
    j = jax_module(family)
    for name in ("center", "ibot_center"):
        if hasattr(j, name):
            var = getattr(j, name)
            var[...] = jnp.asarray(np.random.default_rng(5).normal(size=var[...].shape).astype(np.float32))
    name, enc, pred, kw = FAMILIES[family]
    case = dict(family=family, encoder=enc, module=dict(kw, **COMMON), dtype="float32", batches=batches(family),
                masks=[jax_masks(j, family, s) for s in range(STEPS)], epochs=1, ckpt_dir=ckpt_dir)
    if pred is not None:
        case["predictor"] = pred
    twin = mw.ssl_module(dict(case, init=None))
    load_jax_params(twin, flat_variables(j))
    case["init"] = twin.state_dict()
    return j, case


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ssl")
    cases, jax_modules = {}, {}
    for family in FAMILIES:
        jax_modules[family], cases[family] = family_case(family, str(tmp / family))
    jobs = [(mw.ssl_rank, (cases[f], 4, 2, "cpu")) for f in FAMILIES] + [(mw.ssl_losses_rank, (4, 2, "cpu"))]
    pool = futures.ThreadPoolExecutor(1)
    run = pool.submit(launch, mw.jobs_rank, jobs, world=4, device="cpu", timeout=GROUP_TIMEOUT)

    def results() -> dict:
        ranks = run.result(timeout=2 * GROUP_TIMEOUT)
        return {k: [r[i][0] for r in ranks] for i, k in enumerate([*FAMILIES, "losses"])}

    yield cases, jax_modules, results
    pool.shutdown(wait=True)


# --------------------------------------------------------------------------------------------- #
# (a) against the port's single process
# --------------------------------------------------------------------------------------------- #
def expected_calls(single: dict, dp: int, mp: int) -> dict:
    """The single process's attention calls {(direction, batch, heads): n} as each rank of the mesh
    makes them: every call of these paths is on the global batch (or M views of it), at B / dp rows
    and H / mp heads."""
    out = {}
    for (kind, b, h), n in single.items():
        key = (kind, b // dp, h // mp)
        out[key] = out.get(key, 0) + n
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ssl_mesh_equals_the_single_process(group, family):
    """Two Trainer steps at dp 2 x mp 2 against the port's single process on the global batch: each
    step's loss and scalars, AdamW's moments, the parameters, the teachers and the centers; every
    rank's replicated parameters and buffers bit-identical, its attention calls at its shapes; and
    rank 0's last.ckpt, restored into one process, bit-equal to the mesh's state."""
    cases, _, results = group
    ranks = results()[family]
    case = cases[family]
    assert all(r["replicated"] for r in ranks), "replicated parameters or buffers differ across ranks"
    assert all(r["steps"] == ranks[0]["steps"] for r in ranks)
    with mw.AttentionLog(torch.device("cpu")) as log:
        _, module, steps, moments = mw.ssl_fit(dict(case, ckpt_dir=None))
    assert len(steps) == STEPS and steps[0].keys() == ranks[0]["steps"][0].keys()
    for got, want in zip(ranks[0]["steps"], steps):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **STEP_TOL)
    readings = mw.ssl_readings(module, STEPS, 1, ranks[0]["moments"], ranks[0]["state"], moments, module.state_dict(), case["init"])
    assert all(readings[k] <= tol for k, tol in SINGLE_TOL.items()), str(readings)
    if family in ("dino", "dinov2", "vtdino"):
        assert readings["teacher_per_lr_worst"] and readings["center_abs_worst"]
    want_calls = expected_calls(dict(log.calls), 2, 2)
    assert all(r["attention"] == want_calls for r in ranks), (ranks[0]["attention"], want_calls)

    ckpt = load_checkpoint(os.path.join(case["ckpt_dir"], "last.ckpt"))
    assert ckpt["global_step"] == STEPS and all(torch.equal(ckpt["model"][n], v) for n, v in ranks[0]["state"].items())
    restored = mw.ssl_module(dict(case, masks=[]))
    Trainer(max_epochs=1, verbose=0, device="cpu", ckpt_dir=case["ckpt_dir"]).fit(restored, case["batches"])  # resumes at its end
    state = restored.state_dict()
    assert state.keys() == ckpt["model"].keys() and all(torch.equal(state[n], v) for n, v in ckpt["model"].items())


# --------------------------------------------------------------------------------------------- #
# (b) against JAX's mesh Trainer
# --------------------------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", list(FAMILIES))
def test_ssl_mesh_loss_matches_jax_on_the_mesh(group, family):
    """The first step's loss on dp 2 x mp 2 against JAX's Trainer on make_mesh(8, mp=1) from the same
    weights, batch and masks (injected into JAX's sampler)."""
    cases, jax_modules, results = group
    ranks = results()[family]
    j, case = jax_modules[family], cases[family]
    masks = case["masks"][0]
    with pytest.MonkeyPatch.context() as mp:
        if family == "vjepa":
            mp.setattr(jvjepa_module, "random_tube_masks", lambda *a, **k: jnp.asarray(masks))
        else:
            mp.setattr(type(j), "sample_masks", lambda self, key, b: tuple(jnp.asarray(m) for m in masks))
        hist = JTrainer(max_epochs=1, verbose=0, mesh=jmake_mesh(8, mp=1)).fit(j, case["batches"][:1])
    np.testing.assert_allclose(ranks[0]["steps"][0]["loss"], hist[-1]["train_loss"], **JAX_TOL)


# --------------------------------------------------------------------------------------------- #
# (c) each batch statistic
# --------------------------------------------------------------------------------------------- #
@pytest.mark.parametrize("check", STAT_CHECKS)
def test_batch_statistic_is_the_global_batchs(group, check):
    """ssl_losses_rank on every rank: the statistic with the mesh equals the global batch's (within
    1e-5 of its largest value), and the rank's rows alone give a value outside 2e-4 of it."""
    _, _, results = group
    ranks = results()["losses"]
    assert all(set(r) == set(STAT_CHECKS) for r in ranks)
    for r in ranks:
        assert r[check]["mesh"] <= STAT_TOL and r[check]["local"] > LOCAL_FLOOR, r[check]

