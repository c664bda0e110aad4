"""The port's SSL pretraining path against the JAX package on the CPU: the config loader
(utils/config.py), the datasets (data/datasets.py), the Trainer (train/trainer.py) with its
checkpoints, and the pretrain CLI (cli/pretrain.py), for MAE, DINO, DINOv2 and I-JEPA.

Tiny widths (ViT depth 2, dim 64, 2 heads x 32, 32x32 images, patch 8; decoder depth 1; DINO
heads 32 wide). The Trainer epochs run the JAX Trainer's masking draws (its key chain from the
same seed) through MAEModule.sample_noise and DINOModule.sample_masks. f32 with the patch conv on
the path: rtol 2e-4.
"""
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from jax_params import CONV_TOL, MAE, VIT, carry, dino_pair, dino_twin, flat_variables, images, mae_pair
from m3l_tpu.data import datasets as jdata
from m3l_tpu.train import Trainer as JTrainer
from m3l_tpu.utils.config import load_config as jload_config
from m3l_tpu_torch.cli import pretrain
from m3l_tpu_torch.data import DataLoader, VisionTactileDataset, background_difference, random_flip
from m3l_tpu_torch.models.vit import VisionTransformer
from m3l_tpu_torch.ssl import MAEModule
from m3l_tpu_torch.train import Trainer
from m3l_tpu_torch.utils.convert import load_jax_params
from m3l_tpu_torch.train.checkpoint import load_checkpoint
from m3l_tpu_torch.utils.config import instantiate, load_config, target_path
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXPERIMENTS = sorted((ROOT / "config" / "experiment").rglob("*.yaml"))
ENCODER = ["model.encoder.img_size=[32,32]", "model.encoder.patch_size=8", "model.encoder.depth=1", "trainer.log_every_n_steps=1000"]
TINY = ENCODER + ["model.algorithm.decoder_depth=1", "model.algorithm.decoder_embed_dim=32", "model.algorithm.decoder_num_heads=2"]
TINY_BY_CONFIG = {
    "mae_vit": TINY,
    "dino_vit": ENCODER + ["model.algorithm.dino_out_dim=32", "model.algorithm.dino_hidden_dim=48", "model.algorithm.dino_bottleneck_dim=16"],
    "dinov2_vit": ENCODER + ["model.algorithm.dino_out_dim=32", "model.algorithm.dino_hidden_dim=48", "model.algorithm.dino_bottleneck_dim=16"],
    "ijepa_vit": ENCODER + ["model.algorithm.predictor_depth=1", "model.algorithm.predictor_dim=96"],
}


@pytest.mark.parametrize("path", EXPERIMENTS, ids=lambda p: str(p.relative_to(ROOT / "config")))
def test_load_config_equals_jax(path):
    assert load_config(str(path)) == jload_config(str(path))


@pytest.mark.parametrize("overrides", [
    ["model_size=base", "trainer.max_epochs=3"],
    ["model.encoder.img_size=[32,32]", "trainer.ckpt_dir=null", "model.encoder.compute_dtype=bfloat16", "data.paths=[a.pkl, b.pkl]"],
    ["ckpt_dir=smoke_checkpoints/ssl", "model.algorithm.decode_masked_only=false", "model.algorithm.base_lr=1.0e-3", "seed=7"],
])
def test_load_config_overrides_equal_jax(overrides):
    path = str(ROOT / "config" / "experiment" / "mae_vit.yaml")
    assert load_config(path, overrides) == jload_config(path, overrides)


def test_instantiate_builds_the_port_and_imports_no_jax_package():
    assert target_path("m3l_tpu.train.builders.build_vit") == "m3l_tpu_torch.train.builders.build_vit"
    code = (
        "import sys\n"
        "from m3l_tpu_torch.utils.config import instantiate, load_config\n"
        f"cfg = load_config('config/experiment/mae_vit.yaml', {TINY!r})\n"
        "enc = instantiate(cfg['model']['encoder'])\n"
        "mae = instantiate(cfg['model']['algorithm'])(enc)\n"
        "tr = instantiate(cfg['trainer'], device='cpu')\n"
        "assert [type(o).__module__ for o in (enc, mae, tr)] == "
        "['m3l_tpu_torch.models.vit', 'm3l_tpu_torch.ssl.mae', 'm3l_tpu_torch.train.trainer'], (enc, mae, tr)\n"
        "assert mae.decode_masked_only and mae.mask_ratio == 0.75 and enc.embed_dim == 384 and tr.max_epochs == 200\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'flax', 'optax', 'orbax'} or m.split('.')[0] == 'm3l_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_unported_targets_fail_to_import():
    cfg = load_config(str(ROOT / "config" / "experiment" / "vjepa_vit.yaml"), ENCODER)
    with pytest.raises(AttributeError, match="build_vjepa"):
        instantiate(cfg["model"]["algorithm"])


@pytest.mark.parametrize("out_format,remove_background", [("concat_ch_img", True), ("single_image", False), ("video", False)])
def test_datasets_equal_jax(out_format, remove_background):
    frames = np.random.default_rng(0).integers(0, 256, (23, 8, 8, 3), dtype=np.uint8)
    kw = dict(num_frames=2, frame_stride=5, out_format=out_format, remove_background=remove_background)
    ds, ref = VisionTactileDataset(frames, **kw), jdata.VisionTactileDataset(frames, **kw)
    assert len(ds) == len(ref) == 18
    batches = list(DataLoader(ds, batch_size=4, seed=3))
    want = list(jdata.DataLoader(ref, batch_size=4, seed=3))
    assert len(batches) == len(want) == 4
    for a, b in zip(batches, want):
        np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(background_difference(frames), jdata.background_difference(frames))
    item = ds[0]
    np.testing.assert_array_equal(random_flip(item, np.random.default_rng(1), p=1.0)["image"],
                                  jdata.random_flip(item, np.random.default_rng(1), p=1.0)["image"])


def jax_trainer_noise(seed, steps, batch, n=16):
    """The masking noise of each step of the JAX Trainer seeded ``seed``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k, (batch, n))))
    return out


def key_bias(name: str, dim: int):
    """The key part of an attention bias (or None): its gradient is zero analytically (softmax
    ignores a shift shared by all keys), so it carries only f32 noise."""
    if name.endswith("attn.qkv.bias"):
        return slice(dim, 2 * dim)
    if name.endswith("xattn.kv.bias"):
        return slice(0, dim)
    return None


@pytest.mark.parametrize("accum,clip", [(1, None), (2, 0.05)])
def test_trainer_epoch_equals_jax(accum, clip):
    """One Trainer.fit epoch of the tiny MAE (lr 1e-3, no warm-up, 4 batches): the loss history
    and every parameter after it.

    Adam's update lr * g / (|g| + eps) turns f32 noise on a gradient near zero into a step of up
    to lr of either sign, so such elements may differ by up to 2 * sum(lr): every key-bias
    element (``key_bias``), and at most one element in a thousand of any other parameter. Every
    other element is held to rtol 2e-4 (the optimizer alone, on equal gradients, is held to 1e-5
    in tests/test_torch_ssl_mae.py)."""
    j, p = mae_pair(decode_masked_only=True, base_lr=1e-3, warmup_epochs=0)
    batches = [{"image": images((4, 32, 32, 3), seed=30 + i)} for i in range(4)]
    kw = dict(max_epochs=1, grad_accum_steps=accum, clip_gradients=clip, seed=5, verbose=0)
    ref = JTrainer(**kw).fit(j, batches)
    noise = jax_trainer_noise(5, len(batches), 4)
    p.sample_noise = lambda b, g: torch.from_numpy(noise.pop(0))
    hist = Trainer(device="cpu", **kw).fit(p, batches)
    assert not noise and len(hist) == len(ref) == 1
    np.testing.assert_allclose(hist[0]["train_loss"], ref[0]["train_loss"], **CONV_TOL)
    want = dict(carry(j, MAEModule(VisionTransformer(**VIT), **{**MAE, "decode_masked_only": True})).named_parameters())
    noise_bound = 2 * 1e-3 * (len(batches) // accum)
    for name, q in p.named_parameters():
        got, exp = q.detach().numpy(), want[name].detach().numpy()
        outside = np.abs(got - exp) > CONV_TOL["atol"] + CONV_TOL["rtol"] * np.abs(exp)
        assert np.abs(got - exp)[outside].max(initial=0.0) <= noise_bound, name
        kb = key_bias(name, q.shape[0] // (3 if "qkv" in name else 2))
        if kb is not None:
            outside[kb] = False
        assert outside.sum() <= max(1, outside.size // 1000), (name, int(outside.sum()))


def jax_trainer_dino_masks(j, seed, steps, batch):
    """The masks each step of the JAX Trainer seeded ``seed`` draws for the DINO module ``j``."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, k = jax.random.split(key)
        g, l = j.sample_masks(jax.random.split(k)[0], batch)
        out.append((torch.from_numpy(np.array(g)), torch.from_numpy(np.array(l))))
    return out


def test_dino_trainer_epoch_equals_jax():
    """One Trainer.fit epoch of the tiny DINO with the probe (lr 1e-3, no warm-up, the momentum
    ramp 0.9 -> 1.0 and the temperature warm-up inside the epoch, 4 batches): the loss history,
    the center and every parameter after it, students and teachers. Elements that f32 noise
    under Adam's first steps may move by up to 2 * sum(lr) are allowed as in
    test_trainer_epoch_equals_jax: every key-bias element, and at most one in a thousand of any
    other parameter."""
    kw = dict(base_lr=1e-3, warmup_epochs=0, moving_average_decay=(0.9, 1.0), teacher_warmup_epochs=1)
    j, p = dino_pair(**kw)
    batches = [{"image": images((4, 32, 32, 3), seed=70 + i)} for i in range(4)]
    fit = dict(max_epochs=1, seed=5, verbose=0)
    masks = jax_trainer_dino_masks(j, 5, len(batches), 4)
    ref = JTrainer(**fit).fit(j, batches)
    p.sample_masks = lambda generator, batch: masks.pop(0)
    hist = Trainer(device="cpu", **fit).fit(p, batches)
    assert not masks and len(hist) == len(ref) == 1
    for k in ("train_loss", "train_ssl_loss", "train_reconstruction_loss", "train_teacher_temp"):
        np.testing.assert_allclose(hist[0][k], ref[0][k], err_msg=k, **CONV_TOL)
    want = dino_twin(**kw)
    load_jax_params(want, flat_variables(j))
    np.testing.assert_allclose(p.center.numpy(), want.center.numpy(), **CONV_TOL)
    noise_bound = 2 * 1e-3 * len(batches)
    want = dict(want.named_parameters())
    for name, q in p.named_parameters():
        got, exp = q.detach().numpy(), want[name].detach().numpy()
        outside = np.abs(got - exp) > CONV_TOL["atol"] + CONV_TOL["rtol"] * np.abs(exp)
        assert np.abs(got - exp)[outside].max(initial=0.0) <= noise_bound, name
        kb = key_bias(name, q.shape[0] // 3) if name.endswith("attn.qkv.bias") else None
        if kb is not None:
            outside[kb] = False
        assert outside.sum() <= max(1, outside.size // 1000), (name, int(outside.sum()))


def test_dino_checkpoints_keep_the_teacher_and_resume(tmp_path):
    """last.ckpt holds the teachers, the center and AdamW's moments, and a fresh module resumes
    them exactly; the trainable-only task checkpoint leaves the teachers out."""
    batches = [{"image": images((2, 32, 32, 3), seed=80 + i)} for i in range(2)]
    kw = dict(ckpt_dir=str(tmp_path), num_task_checkpoints=1, verbose=0, device="cpu")
    torch.manual_seed(0)
    m1 = dino_twin()
    Trainer(max_epochs=1, **kw).fit(m1, batches)
    last, task = load_checkpoint(tmp_path / "last.ckpt"), load_checkpoint(tmp_path / "task-0001.ckpt")
    assert "center" in last["model"] and any(k.startswith("teacher_head.") for k in last["model"])
    assert sorted(task["model"]) == sorted(m1.trainable_parameters()) and not any(k.startswith("teacher_") for k in task["model"])
    assert m1.center.abs().sum() > 0
    torch.manual_seed(1)
    m2 = dino_twin()
    second = Trainer(max_epochs=2, **kw)
    opt = m2.configure_optimizer(2, 2)
    assert second._try_resume(m2, opt) and second.global_step == 2
    for (n, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n
    for s_, r in zip(last["opt"]["adamw"]["state"].values(), opt.adamw.state_dict()["state"].values()):
        assert torch.equal(s_["exp_avg"], r["exp_avg"]) and torch.equal(s_["exp_avg_sq"], r["exp_avg_sq"])


@pytest.mark.parametrize("config", ["dino_vit", "dinov2_vit", "ijepa_vit"])
def test_ssl_configs_instantiate_and_train_through_the_cli(tmp_path, config):
    path = str(ROOT / "config" / "experiment" / f"{config}.yaml")
    trainer, algorithm, history = pretrain.main(
        ["--config", path, "--synthetic", "12", "--device", "cpu", *TINY_BY_CONFIG[config], "trainer.max_epochs=1",
         f"trainer.ckpt_dir={tmp_path}/out", "data.batch_size=4"]
    )
    want = {"dino_vit": "DINOModule", "dinov2_vit": "DINOv2Module", "ijepa_vit": "IJEPAModule"}[config]
    assert type(algorithm).__name__ == want and type(algorithm).__module__.startswith("m3l_tpu_torch.ssl.")
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"]) and trainer.global_step == 1
    assert (tmp_path / "out" / "last.ckpt").is_file()
    if config == "dinov2_vit":
        assert algorithm.num_global_masks == 2 and algorithm.centering == "centering" and "train_ibot_loss" in history[0]
    if config == "ijepa_vit":
        assert algorithm.predictor.num_mask_tokens == 4 and algorithm.target_encoder.num_register_tokens == 0


def tiny_mae(**kw):
    torch.manual_seed(0)
    return MAEModule(VisionTransformer(**VIT), **{**MAE, "decode_masked_only": True, **kw})


def test_checkpoints_and_resume(tmp_path):
    batches = [{"image": images((4, 32, 32, 3), seed=40 + i)} for i in range(3)]
    kw = dict(ckpt_dir=str(tmp_path), save_ckpt_every_n_epochs=1, num_task_checkpoints=2, verbose=0, device="cpu")
    first = Trainer(max_epochs=2, **kw)
    m1 = tiny_mae()
    assert len(first.fit(m1, batches)) == 2 and first.global_step == 6
    names = sorted(f.name for f in tmp_path.iterdir())
    assert names == ["epoch-0001.ckpt", "epoch-0002.ckpt", "last.ckpt", "task-0001.ckpt", "task-0002.ckpt"]
    task = load_checkpoint(tmp_path / "task-0002.ckpt")
    assert "opt" not in task and sorted(task["model"]) == sorted(dict(m1.named_parameters())) and task["global_step"] == 6

    # a fresh module and optimizer restore the saved state exactly
    second = Trainer(max_epochs=3, **kw)
    m2 = tiny_mae()
    opt = m2.configure_optimizer(3, 3)
    assert second._try_resume(m2, opt) and (second.global_step, second.current_epoch) == (6, 2)
    for (n, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n
    saved = load_checkpoint(tmp_path / "last.ckpt")["opt"]
    assert opt.count == saved["count"] == 6
    for s, r in zip(saved["adamw"]["state"].values(), opt.adamw.state_dict()["state"].values()):
        assert torch.equal(s["exp_avg"], r["exp_avg"]) and torch.equal(s["exp_avg_sq"], r["exp_avg_sq"])

    # resuming in fit runs only the epochs left
    third = Trainer(max_epochs=3, **kw)
    hist = third.fit(tiny_mae(), batches)
    assert [h["epoch"] for h in hist] == [3] and third.global_step == 9


def test_signal_saves_last_checkpoint_and_stops(tmp_path, monkeypatch):
    handlers = {}
    monkeypatch.setattr("signal.signal", lambda sig, fn: handlers.__setitem__(sig, fn))
    trainer = Trainer(max_epochs=5, ckpt_dir=str(tmp_path), verbose=0, device="cpu")

    def loader():
        for i in range(4):
            if i == 2:  # preemption arrives before the third batch
                handlers[next(iter(handlers))](10, None)
            yield {"image": images((2, 32, 32, 3), seed=i)}

    class Loader:
        def __len__(self):
            return 4

        def __iter__(self):
            return loader()

    hist = trainer.fit(tiny_mae(), Loader())
    assert len(handlers) == 2 and trainer.global_step == 2 and len(hist) == 1
    assert load_checkpoint(tmp_path / "last.ckpt")["global_step"] == 2


def test_profiler_window_writes_a_trace(tmp_path):
    batches = [{"image": images((2, 32, 32, 3), seed=60 + i)} for i in range(4)]
    trainer = Trainer(max_epochs=1, verbose=0, profile_dir=str(tmp_path), profile_steps=(1, 2), device="cpu")
    trainer.fit(tiny_mae(), batches)
    assert [f.name for f in tmp_path.iterdir()] == ["trace_step2.json"]


def test_validation_is_deterministic_and_images_are_logged():
    class CaptureLogger:
        def __init__(self):
            self.images, self.scalars = {}, []

        def log_scalars(self, metrics, step):
            self.scalars.append(metrics)

        def log_image(self, tag, image, step):
            self.images[tag] = image

    logger = CaptureLogger()
    train = [{"image": images((4, 32, 32, 3), seed=50)}]
    val = [{"image": images((4, 32, 32, 3), seed=51)}, {"image": images((4, 32, 32, 3), seed=52)}]
    trainer = Trainer(max_epochs=2, verbose=0, log_images_every_n_epochs=1, logger=logger, device="cpu")
    module = tiny_mae()
    hist = trainer.fit(module, train, val)
    assert all(np.isfinite(h["val_loss"]) for h in hist)
    assert sorted(logger.images) == ["reconstruction/masked", "reconstruction/original", "reconstruction/reconstruction"]
    assert all(img.shape == (32, 4 * 32, 3) and img.min() >= 0 and img.max() <= 1 for img in logger.images.values())
    assert any("val/loss" in s for s in logger.scalars)
    assert trainer._validate(module, val) == trainer._validate(module, val)


def test_pretrain_cli_smoke(tmp_path):
    trainer, algorithm, history = pretrain.main(
        ["--config", str(ROOT / "config" / "experiment" / "mae_vit.yaml"), "--synthetic", "12", "--device", "cpu",
         *TINY, "model.encoder.in_chans=6", "trainer.max_epochs=1", f"trainer.ckpt_dir={tmp_path}/out", "data.batch_size=4"]
    )
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert (tmp_path / "out" / "last.ckpt").is_file() and trainer.global_step == 1  # 12 frames, stride 5: 7 windows
    assert trainer.device == torch.device("cpu") and algorithm.encoder.patch_embed.proj.weight.device.type == "cpu"
