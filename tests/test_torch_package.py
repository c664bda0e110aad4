"""Boundaries of the PyTorch port: no JAX, nothing of m3l_tpu, the card by default, no fallback."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import m3l_tpu_torch
from m3l_tpu_torch.kernels import build
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import flash_attention_qkv
from m3l_tpu_torch.serve import build_policy
from m3l_tpu_torch.utils.device import resolve_device

PKG = pathlib.Path(m3l_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "m3l_tpu")


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


def test_importing_every_module_loads_no_jax():
    names = [
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__") for p in _modules()
    ]
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'jaxlib', 'flax', 'optax'} or m.startswith('m3l_tpu.') or m == 'm3l_tpu')\n"
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
