"""m3l_tpu_torch — the PyTorch/CUDA port of m3l_tpu for NVIDIA Hopper.

Each module sits at the same relative path as its JAX counterpart in ``m3l_tpu/``. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a hand-written CUDA kernel
(``csrc/``, built by ``kernels/build.py`` at first use). The package imports nothing of JAX and
nothing of ``m3l_tpu``.

Package layout:
  utils/    device resolution, obs packing (vt_load), JAX-weight conversion
  ops/      positional tables, NHWC patchify
  nn/       flax-semantics layers, transformer stack, EarlyCNN, the attention kernel wrapper
  models/   VTT, VTMAE
  rl/       ActorCritic policy over VTMAE features
  kernels/  nvcc build + ctypes loading, launch counts
  csrc/     CUDA C++ sources (sm_90a)
  serve.py  build_policy + PolicyServer: raw obs -> actions on the card
"""

__version__ = "0.1.0"
