"""m3l_tpu_torch — the PyTorch/CUDA port of m3l_tpu for NVIDIA Hopper.

Each module sits at the same relative path as its JAX counterpart in ``m3l_tpu/``. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a hand-written CUDA kernel
(``csrc/``, built by ``kernels/build.py`` at first use). The package imports nothing of JAX and
nothing of ``m3l_tpu``.

Package layout:
  utils/    device resolution, obs packing (vt_load), JAX-weight conversion, TensorBoard logger,
            the YAML config tree with _target_ instantiation, quaternions and small helpers
  ops/      positional tables, NHWC patchify, modal masking
  nn/       flax-semantics layers, transformer stack, EarlyCNN, the attention kernels as
            registered m3l:: operators (packed qkv and split-head v1), the DINOv2-style ViT
            layers, the Gumbel vector quantizer
  models/   VTT, VTMAE (embeddings and the masked-reconstruction loss), the ViT zoo
  rl/       ActorCritic policy, PPOMAE (joint, separate and plain-PPO modes, target_kl,
            checkpoints), GAE, rollout buffer, reward normalizer, callbacks; SAC+MAE
  ssl/      the SSL module protocol and its AdamW, schedules, reconstruction decoders, MAE
  data/     pickled sensor buffers, the frame-window dataset, the DataLoader, the DIGIT /
            GelSight loaders (numpy)
  train/    FlatAdam, FlatAdamW, checkpoint files, the SSL Trainer, the config builders,
            torch.distributed rank discovery and start-up
  envs/     host-side fake env, FrameStack, SyncVecEnv and the process pools, make_env
            (no gymnasium)
  cli/      the entry points: PPO and SAC training (cli.train, cli.train_sacmae) and SSL
            pretraining (python -m m3l_tpu_torch.cli.pretrain)
  kernels/  nvcc build + ctypes loading, launch counts
  csrc/     CUDA C++ sources (sm_90a)
  serve.py  build_policy + PolicyServer: raw obs -> actions on the card, one CUDA graph replay
            per request signature; torch.export artifacts of the policy and the encoder
            (cli/export_policy.py)
  bench_attention.py  one attention layer fwd+bwd on the card: einsum vs v1 vs v2
  profile_paths.py  torch.profiler breakdown of serving and training on the card
  bench_host.py  host cost of the attention wrapper, batch-8 serving and the PPO update
"""

__version__ = "0.1.0"
