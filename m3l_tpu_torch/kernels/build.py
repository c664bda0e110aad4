"""Builds the CUDA sources of ``m3l_tpu_torch/csrc`` at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into ``_build/<name>-<hash>.so`` beside this file. The hash covers the source, the
shared headers ``csrc/*.cuh`` and the compiler flags, so an edited source or header builds anew
and an unchanged one loads from the cache. Nothing
is built when the package is imported: the first wrapper that needs a library calls
:func:`load_library`, which keeps the one loaded copy of each library. Without ``nvcc`` the build
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``nvcc`` on ``PATH``."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the cached library for its hash exists; returns its path."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a half-written file
    return out


def _timed_build(name: str) -> float:
    t0 = time.perf_counter()
    build(name)
    return time.perf_counter() - t0


def build_all() -> dict[str, float]:
    """Build every source, one nvcc each, all started together; returns seconds per source."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(_timed_build, names)))


def load_library(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C function to its ``(argtypes, restype)``; they are set once, when
    the library is loaded."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return _loaded[name]
