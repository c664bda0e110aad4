"""Export a trained PPO+MAE policy checkpoint to a serving artifact (counterpart of
``m3l_tpu/cli/export_policy.py``): a ``torch.export`` program (``m3l_tpu_torch/serve.py``) that
computes raw obs -> actions with the weights baked in, written as a ``.pt2`` file.

Takes the same model flags as ``m3l_tpu_torch.cli.train`` (the architecture must match the
checkpoint), whose ``--device`` (default ``cuda``; ``cpu`` only when asked) takes the place of
JAX's ``--platforms``: the program is exported on that device and runs there. Plus::

    python -m m3l_tpu_torch.cli.export_policy --env FakeInsertion \\
        --dim_embedding 128 --frame_stack 2 \\
        --ckpt runs/.../model_400000_steps.ckpt --out policy.pt2 --serve_batch 1

The export is verified by reloading the file and serving seeded observations through it and
through the in-process policy on the same device (for ``--stochastic``, with the same noise on
both sides); ``main`` returns the largest difference.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def seeded_obs(space, batch: int, seed: int) -> dict:
    """Raw observations of ``space``'s keys, shapes and dtypes, drawn from ``seed``: uint8 over
    [0, 255], floats over [-1, 1] (the tactile maps' range)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, box in space.spaces.items():
        shape = (batch, *box.shape)
        out[k] = rng.integers(0, 256, shape, dtype=np.uint8) if box.dtype == np.uint8 else rng.uniform(-1, 1, shape).astype(box.dtype)
    return out


def main(argv=None) -> float:
    from .. import serve
    from ..envs import make_env, make_vec_env
    from .train import build_model, build_parser, check_config

    parser = build_parser()
    parser.add_argument("--ckpt", default=None, help="checkpoint from CheckpointCallback / PPOMAE.save (omit to export the random init, e.g. for pipeline tests)")
    parser.add_argument("--out", required=True, help="artifact output path (.pt2)")
    parser.add_argument("--serve_batch", type=int, default=1, help="static serving batch size (one artifact per signature)")
    parser.add_argument("--stochastic", action="store_true", help="export the sampling policy (obs, noise) -> actions instead of the deterministic mean")
    config = parser.parse_args(argv)
    device = check_config(config)

    env = make_vec_env(
        [make_env(config.env, 0, config.seed, config.state_type, frame_stack=config.frame_stack, allow_fake=config.allow_fake)],
        subproc=False,
    )
    try:
        model = build_model(config, env)
        if config.ckpt:
            model.load(config.ckpt)
            print(f"[export] restored {config.ckpt} (num_timesteps={model.num_timesteps})")
        else:
            print("[export] WARNING: no --ckpt given, exporting the random init")
        bounds = dict(action_low=env.action_space.low, action_high=env.action_space.high)
        example = serve.example_obs_for(env, batch=config.serve_batch, frame_stack=config.frame_stack)
        program = serve.export_policy(model.policy, example, deterministic=not config.stochastic, **bounds)
        serve.save_artifact(config.out, program)
        print(f"[export] wrote {config.out} ({os.path.getsize(config.out) / 1e6:.1f} MB, device {device})")

        server = serve.PolicyServer(model.policy, **bounds)
        obs = seeded_obs(env.observation_space, config.serve_batch, config.seed)
        runner = serve.load_artifact(config.out).module()
        with torch.inference_mode():
            if config.stochastic:
                seed = config.seed + 1
                noise = torch.randn((config.serve_batch, env.action_space.shape[0]), generator=torch.Generator(device).manual_seed(seed), device=device)
                served = runner(server.to_device(obs), noise).cpu().numpy()
                direct = server.sample(obs, torch.Generator(device).manual_seed(seed))
            else:
                served = runner(server.to_device(obs)).cpu().numpy()
                direct = server(obs)
        err = float(np.abs(served - direct).max())
        print(f"[export] verified reload: max|served-direct| = {err:.2e}")
        return err
    finally:
        env.close()


if __name__ == "__main__":
    main()
