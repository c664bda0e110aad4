"""The downstream task modules on the SSL Trainer's mesh (m3l_tpu_torch/train/mesh.py): the probes
(m3l_tpu_torch/tasks/modules.py), the force field and the geometric force field, on the CPU over
gloo.

The contract is JAX's: a mesh run computes the single-process result on the global batch, so the
class-weighted cross-entropy divides by the weights applied over the global batch and the RMSEs
take their squared errors over it before the root. One spawned group of four ranks (dp 2 x mp 2,
``launch`` with a timeout of its own) trains each case for one epoch of two steps of a global batch
of 8 (four rows a rank, one of the encoder's two heads, one of the pooler's two), from JAX's
weights, and runs the statistics' checks and the sharded slip-with-force probe; meanwhile this
process computes the references:

* (a) the port's single process on the global batch: each step's loss and logged scalars (rtol
  1e-5, atol 1e-6; the convolutions' cases too, which read 1.434e-7), and TASK_TOL's fixed bounds
  on each parameter's AdamW moments after each step and on the trained parameters (the key part of
  each packed attention bias apart, as in tests/test_torch_mesh_ssl.py); a frozen encoder and the
  pose network's BatchNorm statistics unmoved; each rank's attention calls the single process's at
  batch / dp and heads / mp; rank 0's ``last.ckpt`` resumes into one process bit for bit;
* (b) JAX's Trainer on ``make_mesh(8, mp=1)`` (GSPMD over the suite's 8 virtual CPU devices): the
  first step's loss at rtol 2e-4 / atol 2e-5 (patch convolutions on the path), class weights set on
  slip and pose;
* (c) ``weighted_ce`` with class weights (and its gradient) and each RMSE from a rank's rows with
  the mesh against the same function on the global batch, within 1e-5 of the largest value, and the
  same function without the mesh on the rank's rows alone outside 2e-4 of it, so each check can
  fail.

Tiny widths: a ViT of 32 x 32, patch 8, dim 32, 2 heads, depth 2 under the probes (32 wide, 2
pooler heads) and depth 4 under the force-field decoder (hooks 0-3, fusion 8). f32, warm-up 0 so
the first steps move the weights. The card's twin of one case (4 ranks sharing cuda:0 over gloo) is
in tests/test_torch_cuda.py, which imports no JAX.
"""
import concurrent.futures as futures
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from m3l_tpu import tasks as jtasks
from m3l_tpu.models.vit import VisionTransformer as JViT
from m3l_tpu.train import Trainer as JTrainer
from m3l_tpu.train.mesh import make_mesh as jmake_mesh
from jax_params import flat_variables
from m3l_tpu_torch.train import Trainer
from m3l_tpu_torch.train import mesh_workers as mw
from m3l_tpu_torch.train.checkpoint import load_checkpoint
from m3l_tpu_torch.train.mesh import launch
from m3l_tpu_torch.utils.convert import load_jax_params
from test_torch_baselines import random_batch_stats
from test_torch_mesh_ssl import expected_calls
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GROUP_TIMEOUT = 300  # seconds, the spawned group
BATCH, STEPS, LR = 8, 2, 1e-3
VIT = dict(img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=32, depth=2, num_heads=2, pos_embed_fn="sinusoidal")
FF_VIT = dict(VIT, in_chans=6, depth=4)
TARGET = "m3l_tpu_torch.models.vit.VisionTransformer"  # a case's encoder is a config block
DECODER = dict(hooks=(0, 1, 2, 3), fusion_ch=8)
COMMON = dict(base_lr=LR, warmup_epochs=0)
SLIP_WEIGHTS, GRASP_WEIGHTS = [1.0, 3.0], [2.0, 0.5]
TEXTILE_WEIGHTS = list(np.linspace(0.5, 2.0, 20))
POSE_WEIGHTS = {"x": list(np.linspace(0.5, 1.5, 10)), "y": list(np.linspace(2.0, 0.2, 10)), "theta": [1.0, 3.0] * 5}
# case: (probe class and its keyword arguments, or None for a force-field decoder; the module's
# class and keyword arguments)
CASES = {
    "force_frozen": (("ForceLinearProbe", {}), ("ForceSLModule", {})),
    "force_finetuned": (("ForceLinearProbe", {}), ("ForceSLModule", dict(train_encoder=True))),
    "slip_frozen": (("SlipProbe", {}), ("SlipSLModule", dict(class_weights=SLIP_WEIGHTS))),
    "slip_force_frozen": (("SlipForceProbe", {}), ("SlipSLModule", dict(class_weights=SLIP_WEIGHTS, use_force=True))),
    "slip_force_finetuned": (("SlipForceProbe", {}), ("SlipSLModule", dict(class_weights=SLIP_WEIGHTS, use_force=True, train_encoder=True))),
    "grasp_finetuned": (("GraspLinearProbe", {}), ("GraspSLModule", dict(class_weights=GRASP_WEIGHTS, train_encoder=True))),
    "textile_frozen": (("TextileLinearProbe", {}), ("TextileSLModule", dict(class_weights=TEXTILE_WEIGHTS))),
    "pose_frozen": (("PoseLinearProbe", {}), ("PoseSLModule", dict(class_weights=POSE_WEIGHTS))),
    "pose_finetuned": (("PoseLinearProbe", {}), ("PoseSLModule", dict(class_weights=POSE_WEIGHTS, train_encoder=True))),
    "forcefield_supervised": (None, ("ForceFieldModule", {})),
    "forcefield_photometric": (None, ("ForceFieldModule", dict(train_encoder=True))),
    "geometric_sl": (None, ("GeometricForceFieldModule", dict(with_sl_supervision=True))),
    "geometric_sl_mask_finetuned": (None, ("GeometricForceFieldModule", dict(with_sl_supervision=True, with_mask_supervision=True,
                                                                             train_encoder=True))),
}
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# set from readings on the CPU (the largest of the cases in brackets): moments 6e-5 of their norm
# (5.551e-6), parameters 0.02 lr (7.242e-3) and 2e-3 of the single process's update of each
# (1.885e-4), a frozen encoder and the BatchNorm statistics exactly, and the key part of each packed
# attention bias 4 lr (1.545: its gradient is f32 noise, which Adam makes a step of up to ~lr a step
# in either direction in each run, two steps of two runs). The geometric force field's pose
# ResNet-18 sums its convolutions over 4 rows in another order than over 8: its BatchNorm weights'
# moments read 4.253e-5 and its parameters 3.291e-2 lr, held at 4e-4 and 0.08 lr.
TASK_TOL = dict(moment_rel=6e-5, param_per_lr=0.02, update_rel=2e-3, teacher_per_lr=0.0, center_abs=0.0, key_bias_per_lr=4.0)
GEOMETRIC_TOL = dict(TASK_TOL, moment_rel=4e-4, param_per_lr=0.08)
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_TOL, LOCAL_FLOOR = 1e-5, 2e-4
STAT_CHECKS = ["weighted_ce", "weighted_ce gradient", "rmse_x", "rmse_y", "rmse_z", "rmse_fx", "rmse_fy", "rmse_fz"]


def force_field(name: str) -> bool:
    return CASES[name][0] is None


def jax_module(name: str):
    """The JAX module of case ``name`` (the pose network's BatchNorm statistics randomised)."""
    probe, (module, kw) = CASES[name]
    kw = dict(kw, **COMMON)
    if probe is None:
        dec = jtasks.ForceFieldDecoder(JViT(rngs=nnx.Rngs(0), **FF_VIT), **DECODER, rngs=nnx.Rngs(2))
        if module == "GeometricForceFieldModule":
            return random_batch_stats(jtasks.GeometricForceFieldModule(dec, rngs=nnx.Rngs(3), **kw))
        return getattr(jtasks, module)(dec, **kw)
    pose_weights = kw.pop("class_weights") if module == "PoseSLModule" else None
    j = getattr(jtasks, module)(JViT(rngs=nnx.Rngs(0), **VIT), getattr(jtasks, probe[0])(32, num_heads=2, rngs=nnx.Rngs(3), **probe[1]), **kw)
    if pose_weights is not None:
        # the JAX PoseSLModule cannot take its dict of class weights in __init__ under flax >= 0.12
        # (a dict of arrays in a static attribute); set it as nnx data, as flax asks
        j.class_weights = nnx.data({k: jnp.asarray(v, jnp.float32) for k, v in pose_weights.items()})
    return j


def batches(name: str) -> list:
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        if force_field(name):
            b = {"image": rng.random((BATCH, 32, 32, 6), dtype=np.float32)}
            if CASES[name][1][0] == "GeometricForceFieldModule":
                b.update(image_bg=rng.random((BATCH, 32, 32, 6), dtype=np.float32), mask=(rng.random((BATCH, 32, 32)) > 0.5).astype(np.float32),
                         force=rng.uniform(-0.5, 0.5, (BATCH, 3)).astype(np.float32))
            elif "supervised" in name:
                b["forcefield"] = rng.random((BATCH, 32, 32, 3), dtype=np.float32)
        else:
            b = {"image": rng.random((BATCH, 32, 32, 3), dtype=np.float32), "force": rng.uniform(-1, 1, (BATCH, 3)).astype(np.float32),
                 "force_scale": np.tile(np.float32([[5.0, 5.0, 10.0]]), (BATCH, 1)), "slip": rng.integers(0, 2, BATCH).astype(np.int32),
                 "grasp": rng.integers(0, 2, BATCH).astype(np.int32), "textile": rng.integers(0, 20, BATCH).astype(np.int32),
                 **{f"pose_{h}": rng.integers(0, 10, BATCH).astype(np.int32) for h in ("x", "y", "theta")}}
        out.append(b)
    return out


def task_case(name: str, ckpt_dir: str):
    """The JAX module and the port case of its weights and batches."""
    j = jax_module(name)
    probe, (module, kw) = CASES[name]
    case = dict(module=(module, dict(kw, **COMMON)), dtype="float32", batches=batches(name), epochs=1, ckpt_dir=ckpt_dir)
    if probe is None:
        case.update(encoder=dict(FF_VIT, _target_=TARGET), decoder=DECODER)
    else:
        case.update(encoder=dict(VIT, _target_=TARGET), probe=(probe[0], dict(probe[1], num_heads=2)))
    twin = mw.task_module(dict(case, init=None))
    load_jax_params(twin, flat_variables(j))
    case["init"] = twin.state_dict()
    return j, case


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_tasks")
    cases, jax_modules = {}, {}
    for name in CASES:
        jax_modules[name], cases[name] = task_case(name, str(tmp / name))
    jobs = [(mw.task_rank, (cases[n], 4, 2, "cpu")) for n in CASES] + [(mw.task_stats_rank, (4, 2, "cpu")),
                                                                       (mw.slip_force_shard_rank, (4, 2, "cpu"))]
    pool = futures.ThreadPoolExecutor(1)
    run = pool.submit(launch, mw.jobs_rank, jobs, world=4, device="cpu", timeout=GROUP_TIMEOUT)

    def results() -> dict:
        ranks = run.result(timeout=2 * GROUP_TIMEOUT)
        return {k: [r[i][0] for r in ranks] for i, k in enumerate([*CASES, "stats", "shard"])}

    yield cases, jax_modules, results
    pool.shutdown(wait=True)


# --------------------------------------------------------------------------------------------- #
# (a) against the port's single process
# --------------------------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CASES))
def test_task_mesh_equals_the_single_process(group, name):
    """Two Trainer steps at dp 2 x mp 2 against the port's single process on the global batch: each
    step's loss and scalars, AdamW's moments and the parameters; every rank's replicated parameters
    bit-identical, its attention calls at its shapes; and rank 0's last.ckpt, restored into one
    process, bit-equal to the mesh's state."""
    cases, _, results = group
    ranks = results()[name]
    case = cases[name]
    with mw.AttentionLog(torch.device("cpu")) as log:
        _, module, steps, moments = mw.task_fit(dict(case, ckpt_dir=None))
    assert all(r["replicated"] for r in ranks), "replicated parameters or buffers differ across ranks"
    assert all(r["steps"] == ranks[0]["steps"] for r in ranks)
    assert len(steps) == STEPS and steps[0].keys() == ranks[0]["steps"][0].keys()
    for got, want in zip(ranks[0]["steps"], steps):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **STEP_TOL)
    readings = mw.ssl_readings(module, STEPS, 1, ranks[0]["moments"], ranks[0]["state"], moments, module.state_dict(), case["init"])
    tol = GEOMETRIC_TOL if case["module"][0] == "GeometricForceFieldModule" else TASK_TOL
    assert all(readings[k] <= bound for k, bound in tol.items()), str(readings)
    frozen = not case["module"][1].get("train_encoder", False)
    assert (readings["teacher_per_lr_worst"] is not None) == frozen  # a frozen encoder, held unmoved
    assert (readings["center_abs_worst"] is not None) == (case["module"][0] == "GeometricForceFieldModule")  # the pose network's BatchNorm
    want_calls = expected_calls(dict(log.calls), 2, 2)
    assert all(r["attention"] == want_calls for r in ranks), (ranks[0]["attention"], want_calls)
    assert sum(n for (kind, _, _), n in want_calls.items() if kind == "bwd") == (0 if frozen else sum(want_calls.values()) // 2)

    ckpt = load_checkpoint(os.path.join(case["ckpt_dir"], "last.ckpt"))
    assert ckpt["global_step"] == STEPS and all(torch.equal(ckpt["model"][n], v) for n, v in ranks[0]["state"].items())
    restored = mw.task_module(case)
    Trainer(max_epochs=1, verbose=0, device="cpu", ckpt_dir=case["ckpt_dir"]).fit(restored, case["batches"])  # resumes at its end
    state = restored.state_dict()
    assert state.keys() == ckpt["model"].keys() and all(torch.equal(state[n], v) for n, v in ckpt["model"].items())


# --------------------------------------------------------------------------------------------- #
# (b) against JAX's mesh Trainer
# --------------------------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(CASES))
def test_task_mesh_loss_matches_jax_on_the_mesh(group, name):
    """The first step's loss on dp 2 x mp 2 against JAX's Trainer on make_mesh(8, mp=1) from the same
    weights and batch."""
    cases, jax_modules, results = group
    ranks = results()[name]
    hist = JTrainer(max_epochs=1, verbose=0, mesh=jmake_mesh(8, mp=1)).fit(jax_modules[name], cases[name]["batches"][:1])
    np.testing.assert_allclose(ranks[0]["steps"][0]["loss"], hist[-1]["train_loss"], **JAX_TOL)


# --------------------------------------------------------------------------------------------- #
# (c) each batch statistic, and the sharded slip-with-force probe
# --------------------------------------------------------------------------------------------- #
@pytest.mark.parametrize("check", STAT_CHECKS)
def test_task_statistic_is_the_global_batchs(group, check):
    """task_stats_rank on every rank: the statistic with the mesh equals the global batch's (within
    1e-5 of its largest value), and the rank's rows alone give a value outside 2e-4 of it."""
    _, _, results = group
    ranks = results()["stats"]
    assert all(set(r) == set(STAT_CHECKS) for r in ranks)
    for r in ranks:
        assert r[check]["mesh"] <= STAT_TOL and r[check]["local"] > LOCAL_FLOOR, r[check]


def test_shard_module_splits_the_slip_force_probe(group):
    """At mp 2 the probe's fc1 becomes column-parallel and its fc2 row-parallel, each on half of the
    dim / 4 hidden units; the force projection stays whole (no rule matches it, as in JAX); the
    output and every gradient equal the unsharded probe's."""
    _, _, results = group
    for r in results()["shard"]:
        assert r["layers"] == {"force_proj": ("Linear", 3, 8), "fc1": ("ColumnParallelLinear", 40, 4), "fc2": ("RowParallelLinear", 4, 2)}
        assert max(r["out"], r["grad_in"], r["grad_w"]) <= 1e-6, r
