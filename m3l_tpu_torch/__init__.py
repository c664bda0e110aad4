"""m3l_tpu_torch — the PyTorch/CUDA port of m3l_tpu for NVIDIA Hopper.

Each module sits at the same relative path as its JAX counterpart in ``m3l_tpu/``. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a hand-written CUDA kernel
(``csrc/``, built by ``kernels/build.py`` at first use). The package imports nothing of JAX and
nothing of ``m3l_tpu``.

Package layout:
  utils/    device resolution, obs packing (vt_load), JAX-weight conversion
  ops/      positional tables, NHWC patchify, modal masking
  nn/       flax-semantics layers, transformer stack, EarlyCNN, the attention kernel wrappers
  models/   VTT, VTMAE (embeddings and the masked-reconstruction loss)
  rl/       ActorCritic policy, PPOMAE (joint mode), GAE, rollout buffer, reward normalizer
  train/    FlatAdam
  envs/     host-side fake env, FrameStack, SyncVecEnv, make_env (no gymnasium)
  kernels/  nvcc build + ctypes loading, launch counts
  csrc/     CUDA C++ sources (sm_90a)
  serve.py  build_policy + PolicyServer: raw obs -> actions on the card
  profile_paths.py  torch.profiler breakdown of serving and training on the card
"""

__version__ = "0.1.0"
