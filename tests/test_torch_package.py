"""Boundaries of the PyTorch port: no JAX, no gymnasium, nothing of m3l_tpu, the card by default,
no fallback."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import m3l_tpu_torch
from m3l_tpu_torch.kernels import build
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.models import VTTConfig
from m3l_tpu_torch.nn.flash_attention import flash_attention_qkv
from m3l_tpu_torch.rl import PPOMAE
from m3l_tpu_torch.serve import build_policy
from m3l_tpu_torch.utils.device import resolve_device

PKG = pathlib.Path(m3l_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gymnasium", "m3l_tpu")


def _modules():
    return sorted(p for p in PKG.rglob("*.py"))


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(PKG)))
def test_module_imports_no_jax_and_nothing_of_m3l_tpu(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(PKG)} imports {bad}"


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_numerics.py"])
def test_chip_script_imports_no_jax_and_nothing_of_m3l_tpu(script):
    """The scripts run on the H100 machine, which has no JAX, import only torch and the port."""
    bad = sorted(set(_imported_roots(PKG.parent / script)) & set(FORBIDDEN))
    assert not bad, f"{script} imports {bad}"


def _probe_path():
    return [p for p in _modules() if p.relative_to(PKG).parts[0] in ("tasks", "eval") or p.relative_to(PKG).as_posix() == "cli/evaluate.py"]


def _module_level_roots(path):
    """The roots imported by ``path``'s module-level statements (not inside a function)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _probe_path(), ids=lambda p: str(p.relative_to(PKG)))
def test_probe_path_imports_no_matplotlib_at_import_time(path):
    """The H100 machine has no matplotlib: the plots import it inside their functions only."""
    bad = sorted(set(_module_level_roots(path)) & {"matplotlib", *FORBIDDEN})
    assert not bad, f"{path.relative_to(PKG)} imports {bad} at import time"


def test_importing_the_probe_path_loads_no_jax_and_no_matplotlib():
    code = (
        "import sys\n"
        "import m3l_tpu_torch.tasks, m3l_tpu_torch.eval, m3l_tpu_torch.cli.evaluate, m3l_tpu_torch.data\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'flax', 'optax', 'matplotlib'} or m.split('.')[0] == 'm3l_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


HOST_ONLY = ("cv2", "matplotlib", "PIL")  # imported inside the functions that draw or encode video


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(PKG)))
def test_module_imports_no_cv2_or_matplotlib_at_import_time(path):
    """Neither the H100 machine's package list nor a headless host is sure to have them."""
    bad = sorted(set(_module_level_roots(path)) & set(HOST_ONLY))
    assert not bad, f"{path.relative_to(PKG)} imports {bad} at import time"


def test_importing_the_forcefield_and_vtdino_slice_loads_no_jax_cv2_or_matplotlib():
    code = (
        "import sys\n"
        "import m3l_tpu_torch.models.baselines, m3l_tpu_torch.models.multimodal_vtt, m3l_tpu_torch.models.multimodal_transformer\n"
        "import m3l_tpu_torch.tasks.forcefield, m3l_tpu_torch.tasks.forcefield_geometry, m3l_tpu_torch.ssl.vtdino\n"
        "import m3l_tpu_torch.data.synthetic, m3l_tpu_torch.utils.video, m3l_tpu_torch.cli.demo_forcefield, m3l_tpu_torch.train.builders\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'jaxlib', 'flax', 'optax', 'gymnasium', 'cv2', 'matplotlib', 'PIL'}"
        " or m.split('.')[0] == 'm3l_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


VARIANT_AND_EVAL_MODULES = ("models/dinov2_interop.py", "models/vtmae_cnn.py", "rl/frozen_features.py", "rl/dino_fusion_features.py",
                            "cli/traindino.py", "cli/train_dino_cat_mae.py", "cli/train_dino_tac_mae.py", "cli/train_cnn.py",
                            "rl/callbacks.py", "utils/loggers.py", "utils/video.py")


def test_the_boundary_walks_cover_the_feature_variants_and_the_rl_evaluation():
    """The AST walks above (JAX, gymnasium, m3l_tpu; cv2 and matplotlib at import time) run over
    every module of the package, these included."""
    walked = {p.relative_to(PKG).as_posix() for p in _modules()}
    assert set(VARIANT_AND_EVAL_MODULES) <= walked


def test_importing_the_feature_variants_and_rl_evaluation_loads_no_jax_cv2_or_matplotlib():
    names = ", ".join("m3l_tpu_torch." + m.removesuffix(".py").replace("/", ".") for m in VARIANT_AND_EVAL_MODULES)
    code = (
        "import sys\n"
        f"import {names}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'jaxlib', 'flax', 'optax', 'gymnasium', 'cv2', 'matplotlib', 'PIL',"
        " 'tensorboard', 'wandb'} or m.split('.')[0] == 'm3l_tpu')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("name", ["traindino", "train_dino_cat_mae", "train_dino_tac_mae", "train_cnn"])
def test_the_variant_clis_default_to_the_card_and_raise_without_one(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    import importlib

    cli = importlib.import_module(f"m3l_tpu_torch.cli.{name}")
    assert cli.build_parser().parse_args([]).device == "cuda"
    from m3l_tpu_torch.cli import train

    monkeypatch.setattr(train, "make_env", lambda *a, **k: pytest.fail("an env was built before the device check"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--env", "FakeInsertion"])


def test_the_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from m3l_tpu_torch.cli import demo_forcefield

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo_forcefield.main(["--source", "synthetic", "--frames", "1"])


def test_importing_every_module_loads_no_jax():
    names = [
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__") for p in _modules()
    ]
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'jaxlib', 'flax', 'optax', 'gymnasium'} or m.startswith('m3l_tpu.') or m == 'm3l_tpu')\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_policy()
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = VTTConfig(dim=64, depth=1, heads=2, mlp_dim=128)
    policy = build_policy(cfg, decoder_depth=1, decoder_heads=2, dtype=torch.float32, device="cpu")
    env = SyncVecEnv([make_env("FakeInsertion", 0)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PPOMAE(policy, env, n_steps=4, batch_size=4)
    from m3l_tpu_torch import bench_attention
    from m3l_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_attention.make_inputs(2, 8, 64)
    config = train.build_parser().parse_args([])
    assert config.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.check_config(config)
    from m3l_tpu_torch import compare_kernels

    assert compare_kernels.main(["m3l_tpu_torch/csrc"]) == 2  # no card: usage, no comparison


def test_wrapper_has_no_plain_fallback_off_the_cpu():
    qkv = torch.empty(2, 10, 3 * 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention_qkv(qkv, 1)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("flash_attention_qkv_fwd", {})
    # the wrapper's kernel path raises too, rather than returning the plain result
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._launch(torch.zeros(2, 10, 3 * 64), 1, None, 0.125)
    assert not (tmp_path / "build").exists()


def test_library_path_is_keyed_on_source_and_flags(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one")
    monkeypatch.setattr(build, "CSRC_DIR", src)
    first = build.library_path("k")
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")
    (src / "k.cu").write_text("// two")
    assert build.library_path("k") != first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    (src / "k.cu").write_text("// one")
    assert build.library_path("k") != first


def test_ssl_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from m3l_tpu_torch.cli import pretrain
    from m3l_tpu_torch.train import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer()
    assert Trainer(device="cpu").device == torch.device("cpu")
    # the CLI builds its Trainer first, so it raises before it builds a model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(["--config", str(PKG.parent / "config" / "experiment" / "mae_vit.yaml"), "--synthetic", "8"])
