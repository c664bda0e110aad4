"""The port's downstream-probe modules (data/task_datasets.py, tasks/) against the JAX package on
the CPU.

Tiny widths: the ViT at depth 2, dim 64, 2 heads x 32 on 32x32x3 images, patch 8 (16 tokens); each
probe pools with 2 heads. Weights carried from JAX with load_jax_params. f32 with the patch conv
on the path: the loss and metrics at rtol 2e-4 (CONV_TOL), gradients at rtol 2e-4 plus 1e-5 of
the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, VIDEO, VIT, carry, dino_twin, flat_state, flat_variables, ijepa_twin, images, probe_pair, t, vjepa_twin
from m3l_tpu.data import task_datasets as jtd
from m3l_tpu.data import datasets as jdata
from m3l_tpu.tasks import modules as jmodules
from m3l_tpu_torch import tasks
from m3l_tpu_torch.data import DataLoader, LABEL_KEYS, bin_labels, make_task_dataset
from m3l_tpu_torch.kernels import LAUNCHES, reset_launches
from m3l_tpu_torch.models.vit import VisionTransformer
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.ssl import MAEModule
from m3l_tpu_torch.train import Trainer, save_checkpoint
from m3l_tpu_torch.train.builders import build_task_module
from m3l_tpu_torch.utils.convert import load_jax_params
from test_torch_ssl_dino import count_attention
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH = 4
N_FRAMES = 23


def task_buffer(task: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    buf = {"frames": rng.integers(0, 256, (N_FRAMES, 8, 8, 3), dtype=np.uint8)}
    if task in ("force", "slip"):
        buf["force"] = rng.uniform(-3, 3, (N_FRAMES, 3)).astype(np.float32)
    if task == "slip":
        buf["slip"] = rng.integers(0, 2, N_FRAMES)
    elif task == "pose":
        buf["pose"] = rng.uniform(-1, 1, (N_FRAMES, 3)).astype(np.float32)
    elif task in ("grasp", "textile"):
        buf[task] = rng.integers(0, 20 if task == "textile" else 2, N_FRAMES)
    return buf


@pytest.mark.parametrize("task", sorted(LABEL_KEYS))
def test_make_task_dataset_equals_jax(task):
    kw = dict(num_frames=2, frame_stride=3, out_format="concat_ch_img", pose_bins=5)
    ds, ref = make_task_dataset(task_buffer(task), task, **kw), jtd.make_task_dataset(task_buffer(task), task, **kw)
    assert len(ds) == len(ref) == N_FRAMES - 3 and sorted(ds.labels) == sorted(ref.labels)
    assert set(LABEL_KEYS[task]) <= set(ds.labels)
    for k in ds.labels:
        np.testing.assert_array_equal(ds.labels[k], ref.labels[k], err_msg=k)
        assert ds.labels[k].dtype == ref.labels[k].dtype, k
    for a, b in zip(DataLoader(ds, batch_size=BATCH, seed=1), jdata.DataLoader(ref, batch_size=BATCH, seed=1)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_force_scale_and_pose_bins_equal_jax():
    buf = task_buffer("force")
    scale = np.array([[2.0, 4.0, 8.0]], np.float32)
    ds, ref = make_task_dataset(buf, "force", force_scale=scale), jtd.make_task_dataset(task_buffer("force"), "force", force_scale=scale)
    np.testing.assert_array_equal(ds.labels["force"], ref.labels["force"])
    np.testing.assert_array_equal(ds.labels["force_scale"], np.broadcast_to(scale, (N_FRAMES, 3)))
    values = np.random.default_rng(2).normal(size=50).astype(np.float32)
    for args in ((7,), (4, -0.5, 0.5), (3, 1.0, 1.0)):
        np.testing.assert_array_equal(bin_labels(values, *args), jtd.bin_labels(values, *args))
    with pytest.raises(ValueError, match="unknown task"):
        make_task_dataset(task_buffer("force"), "forcefield")


@pytest.mark.parametrize("weights", [None, [0.5, 2.0, 1.0], [0.0, 0.0, 0.0]], ids=["none", "weighted", "all_zero"])
def test_weighted_ce_and_smooth_l1_equal_jax(weights):
    rng = np.random.default_rng(4)
    logits, labels = rng.normal(size=(6, 3)).astype(np.float32), rng.integers(0, 3, 6)
    w = None if weights is None else np.asarray(weights, np.float32)
    got = tasks.weighted_ce(t(logits), t(labels), None if w is None else t(w))
    np.testing.assert_allclose(got.item(), float(jmodules.weighted_ce(jnp.asarray(logits), jnp.asarray(labels), None if w is None else jnp.asarray(w))), rtol=1e-6)
    pred, target = rng.normal(size=(5, 3)).astype(np.float32) * 0.05, rng.normal(size=(5, 3)).astype(np.float32) * 0.05
    np.testing.assert_allclose(tasks.smooth_l1(t(pred), t(target), beta=0.02).numpy(),
                               np.asarray(jmodules.smooth_l1(jnp.asarray(pred), jnp.asarray(target), beta=0.02)), rtol=1e-6, atol=1e-8)


def sl_batch(seed: int = 0, classes: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "image": images((BATCH, 32, 32, 3), seed=seed),
        "force": rng.uniform(-1, 1, (BATCH, 3)).astype(np.float32),
        "force_scale": np.broadcast_to(np.array([[2.0, 3.0, 5.0]], np.float32), (BATCH, 3)).copy(),
        "slip": rng.integers(0, 2, BATCH),
        "grasp": rng.integers(0, 2, BATCH),
        "textile": rng.integers(0, classes, BATCH),
        **{f"pose_{h}": rng.integers(0, classes, BATCH) for h in ("x", "y", "theta")},
    }


# (probe kwargs, module kwargs) of each case: SlipForceProbe, pose's three heads and class weights
CASES = {
    "force": ({}, {}),
    "slip": ({}, {"class_weights": [0.3, 1.7]}),
    "slip_force": ({}, {"use_force": True, "class_weights": [1.0, 2.0]}),
    "pose": ({"num_classes": 5}, {"class_weights": {"x": [1.0, 2.0, 0.5, 1.0, 3.0], "y": [0.2, 0.4, 0.6, 0.8, 1.0]}}),
    "grasp": ({}, {"class_weights": [0.5, 1.5]}),
    "textile": ({"num_classes": 5}, {}),
}


@pytest.mark.parametrize("train_encoder", [False, True], ids=["frozen", "finetuned"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sl_module_loss_and_gradients_equal_jax(name, train_encoder):
    probe_kw, kw = CASES[name]
    j, p = probe_pair(name, train_encoder, probe_kw, **kw)
    batch = sl_batch(seed=5, classes=5)

    @nnx.jit
    def step_fn(m, batch):
        return nnx.value_and_grad(lambda m: m.training_loss(batch, None, 0), has_aux=True, argnums=nnx.DiffState(0, m.trainable_filter))(m)

    (jloss, jaux), jgrads = step_fn(j, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux = p.training_loss({k: t(v) for k, v in batch.items()}, None, 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **CONV_TOL)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), err_msg=k, **CONV_TOL)

    trainable = p.trainable_parameters()
    ref = probe_pair(name, train_encoder, probe_kw, **kw)[1]
    load_jax_params(ref, {**flat_variables(j), **flat_state(jgrads)})
    want = dict(ref.named_parameters())
    assert len(flat_state(jgrads)) == len(trainable)
    assert any(n.startswith("model_encoder.") for n in trainable) == train_encoder
    scale = max(q.grad.abs().max().item() for q in trainable.values())
    for n, q in p.named_parameters():
        if n in trainable:
            np.testing.assert_allclose(q.grad.numpy(), want[n].detach().numpy(), rtol=2e-4, atol=1e-5 * scale, err_msg=n)
        else:
            assert q.grad is None, n  # the frozen encoder ran without autograd


@pytest.mark.parametrize("name", ["force", "pose"])
def test_predict_equals_jax(name):
    probe_kw, kw = CASES[name]
    j, p = probe_pair(name, False, probe_kw, **kw)
    x = images((BATCH, 32, 32, 3), seed=9)
    with torch.no_grad():
        got = p.predict(t(x))
    want = j.predict(jnp.asarray(x))
    if name == "pose":
        assert sorted(got) == ["theta", "x", "y"]
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **CONV_TOL)
    else:
        assert got.shape == (BATCH, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


def tiny_probe(train_encoder: bool, **kw):
    torch.manual_seed(0)
    return tasks.ForceSLModule(VisionTransformer(**VIT), tasks.ForceLinearProbe(64, num_heads=2), train_encoder=train_encoder,
                               base_lr=1e-2, warmup_epochs=0, **kw)


@pytest.mark.parametrize("train_encoder", [False, True], ids=["frozen", "finetuned"])
def test_a_frozen_step_leaves_the_encoder_bit_equal(train_encoder):
    """Trainer steps with weight decay: a frozen encoder stays bit for bit (it is neither in the
    optimizer nor in autograd), the probe moves; fine-tuned, the encoder moves too."""
    module = tiny_probe(train_encoder)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    opt = module.configure_optimizer(2, 1)
    n_encoder = len(list(module.model_encoder.parameters())) if train_encoder else 0
    assert len(opt.params) == len(module.trainable_parameters()) == len(list(module.model_task.parameters())) + n_encoder
    batches = [{k: v for k, v in sl_batch(seed=20 + i).items()} for i in range(2)]
    Trainer(max_epochs=1, verbose=0, device="cpu").fit(module, batches)
    for k, v in module.state_dict().items():
        same = torch.equal(v, before[k])
        if k.startswith("model_encoder."):
            assert same != train_encoder, k
        elif k.endswith("weight"):
            assert not same, k


@pytest.mark.parametrize("train_encoder,launches", [(False, {fa.KERNEL: 2}), (True, {fa.KERNEL: 2, fa.BWD_KERNEL: 2})], ids=["frozen", "finetuned"])
def test_attention_launches_per_step(monkeypatch, train_encoder, launches):
    """A frozen step runs the encoder forward only (depth 2 here; 12 + 0 at ViT-small, which
    chip_smoke.py phase 11 checks); a fine-tuned one forward and backward (12 + 12)."""
    count_attention(monkeypatch)
    module = tiny_probe(train_encoder)
    reset_launches()
    loss, _ = module.training_loss({k: t(v) for k, v in sl_batch().items()}, None, 0)
    loss.backward()
    assert dict(LAUNCHES) == launches
    assert module.encode(t(images((2, 32, 32, 3)))).requires_grad == train_encoder
    reset_launches()


def trained(module, tmp_path, shape=(2, 32, 32, 3)):
    """``module`` after one Trainer epoch of two batches of ``shape``; returns its last.ckpt."""
    batches = [{"image": images(shape, seed=90 + i)} for i in range(2)]
    Trainer(max_epochs=1, verbose=0, device="cpu", ckpt_dir=str(tmp_path)).fit(module, batches)
    return tmp_path / "last.ckpt"


@pytest.mark.parametrize("encoder_type", ["mae", "jepa", "dino"])
def test_load_encoder_from_a_trainer_checkpoint(tmp_path, encoder_type):
    """The port's Trainer checkpoint of each SSL kind: the encoder the key surgery picks, bit for
    bit, loaded by build_task_module through checkpoint_encoder."""
    torch.manual_seed(0)
    if encoder_type == "mae":
        ssl, pick, vit = MAEModule(VisionTransformer(**VIT), decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2), "encoder", VIT
    elif encoder_type == "jepa":
        ssl, pick, vit = ijepa_twin(), "target_encoder", VIT
    else:
        ssl, pick, vit = dino_twin(), "teacher_backbone", {**VIT, "num_register_tokens": 1}
    ckpt = trained(ssl, tmp_path)
    torch.manual_seed(1)
    module = build_task_module(VisionTransformer(**vit), "force", checkpoint_encoder=str(ckpt), encoder_type=encoder_type, num_heads=2)
    want = getattr(ssl, pick).state_dict()
    got = module.model_encoder.encoder.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if encoder_type == "dino":  # the teacher, not the student
        assert not all(torch.equal(got[k], v) for k, v in ssl.student_backbone.state_dict().items())


def test_load_encoder_nested_backbone_and_missing_subtree(tmp_path):
    torch.manual_seed(2)
    src = VisionTransformer(**VIT)
    save_checkpoint(tmp_path / "vtdino.ckpt", {"model": {f"teacher_encoder.backbone.{k}": v for k, v in src.state_dict().items()}})
    enc = VisionTransformer(**VIT)
    tasks.load_encoder_from_checkpoint(enc, str(tmp_path / "vtdino.ckpt"), "vtdino")
    for k, v in src.state_dict().items():
        assert torch.equal(enc.state_dict()[k], v), k
    with pytest.raises(KeyError, match="no encoder subtree"):
        tasks.load_encoder_from_checkpoint(enc, str(tmp_path / "vtdino.ckpt"), "jepa")


def test_a_video_checkpoint_into_a_still_image_encoder_fails_clearly(tmp_path):
    """The downstream configs build the 2-D encoder of config/default.yaml; a V-JEPA checkpoint's
    tubelet embedding does not fit it. The JAX package fails at its first forward (the Conv3d
    kernel replaces the Conv2d one unchecked); the port fails at the load, naming the parameter."""
    ckpt = trained(vjepa_twin(), tmp_path, shape=(2, 2, 32, 32, 3))
    with pytest.raises(RuntimeError, match="size mismatch for patch_embed.proj.weight"):
        tasks.load_encoder_from_checkpoint(VisionTransformer(**VIT), str(ckpt), "vjepa")
    video = VisionTransformer(**VIT, **VIDEO)
    tasks.load_encoder_from_checkpoint(video, str(ckpt), "vjepa")  # a video encoder takes it


@pytest.mark.parametrize("task", ["force", "slip", "pose", "grasp", "textile"])
def test_build_task_module_carries_the_jax_parameters(task):
    """build_task_module picks the same probe and module as JAX's, with parameter names that take
    JAX's weights one to one."""
    from m3l_tpu.models.vit import VisionTransformer as JViT
    from m3l_tpu.train.builders import build_task_module as jbuild

    j = jbuild(JViT(rngs=nnx.Rngs(0), **VIT), task, num_heads=2)
    p = build_task_module(VisionTransformer(**VIT), task, num_heads=2)
    assert type(p).__name__ == type(j).__name__ and type(p.model_task).__name__ == type(j.model_task).__name__
    carry(j, p)
    assert sorted(p.trainable_parameters()) == sorted(n for n, _ in p.named_parameters() if n.startswith("model_task."))
