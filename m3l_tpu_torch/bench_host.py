"""Host cost of calling the attention kernels, where the PPO update and small-batch serving are
host-bound: the packed attention wrapper at N = 10 (forward under inference mode, forward with
autograd, forward + backward), batch-8 serving through ``PolicyServer``, the first and second
request of each of six new batch sizes through one ``PolicyServer`` (what a new request signature
costs) and one joint PPO+MAE minibatch update at minibatch 512, on the card.

    python -m m3l_tpu_torch.bench_host

It uses only entry points that older trees of the port have too, so the same file times another
checkout: copied out of the package, ``PYTHONPATH=<checkout> python <copy>`` imports that
checkout's package. Compare two trees only within one call, in turns. The wrapper's times are CUDA-event means over
``WRAPPER_CALLS`` back-to-back calls (host-bound at this size: the enqueue rate); serving is the
median request of ``REQUESTS`` (numpy obs in, numpy actions out); each new batch size's two
requests are timed once each, labelled by the server's counters where it has them (``capture``,
``replay``, ``eager``; a tree without CUDA graphs serves all eagerly); the update is the median of
``UPDATES`` synchronised ``minibatch_update`` calls. Prints one JSON line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from m3l_tpu_torch.envs import SyncVecEnv, make_env
from m3l_tpu_torch.nn.flash_attention import flash_attention_qkv
from m3l_tpu_torch.profile_paths import random_minibatch
from m3l_tpu_torch.rl import PPOMAE
from m3l_tpu_torch.serve import PolicyServer, build_policy, random_obs

WRAPPER_CALLS, REQUESTS, UPDATES = 200, 50, 10
NEW_BATCHES = range(3, 9)  # with PolicyServer's four graphs, the first four capture and the last two are past the cap
B, N, H, DH, FRAME_STACK, TRAIN_BATCH = 512, 10, 4, 64, 4, 512


def event_ms(fn, calls: int) -> float:
    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def wrapper_ms() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, N, 3 * H * DH), generator=g, device="cuda").bfloat16()
    cot = torch.randn((B, N, H * DH), generator=g, device="cuda").bfloat16()
    leaf = qkv.clone().requires_grad_(True)

    def inference():
        with torch.inference_mode():
            flash_attention_qkv(qkv, H)

    def fwd_bwd():
        torch.autograd.grad(flash_attention_qkv(leaf, H), leaf, cot)

    return dict(inference_ms=event_ms(inference, WRAPPER_CALLS), autograd_fwd_ms=event_ms(lambda: flash_attention_qkv(leaf, H), WRAPPER_CALLS),
                fwd_bwd_ms=event_ms(fwd_bwd, WRAPPER_CALLS))


def serving_p50_ms() -> float:
    torch.manual_seed(0)
    server = PolicyServer(build_policy(dtype=torch.bfloat16, device="cuda"), action_low=[-1.0] * 3, action_high=[1.0] * 3)
    rng = np.random.default_rng(0)
    batches = [random_obs(rng, 8, FRAME_STACK) for _ in range(REQUESTS)]
    server(batches[0])
    times = []
    for obs in batches:
        t0 = time.perf_counter()
        server(obs)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_counts(server: PolicyServer) -> tuple:
    """(captures, replays) of a server that counts them; (0, 0) of one without CUDA graphs."""
    return tuple(getattr(server, k, 0) for k in ("graph_captures", "graph_replays"))


def serving_new_batches_ms() -> list[dict]:
    torch.manual_seed(0)
    server = PolicyServer(build_policy(dtype=torch.bfloat16, device="cuda"), action_low=[-1.0] * 3, action_high=[1.0] * 3)
    rng = np.random.default_rng(1)
    out = []
    for b in NEW_BATCHES:
        row = dict(batch=b)
        for which, obs in (("first", random_obs(rng, b, FRAME_STACK)), ("second", random_obs(rng, b, FRAME_STACK))):
            before = graph_counts(server)
            t0 = time.perf_counter()
            server(obs)
            row[f"{which}_ms"] = (time.perf_counter() - t0) * 1e3
            captures, replays = (n - m for n, m in zip(graph_counts(server), before))
            row[which] = "capture" if captures else "replay" if replays else "eager"
        out.append(row)
    return out


def update_ms() -> float:
    torch.manual_seed(0)
    policy = build_policy(dtype=torch.bfloat16, device="cuda")
    env = SyncVecEnv([make_env("FakeInsertion", i, frame_stack=FRAME_STACK) for i in range(8)])
    try:
        model = PPOMAE(policy, env, n_steps=TRAIN_BATCH // 8, batch_size=TRAIN_BATCH, frame_stack=FRAME_STACK, device="cuda")
        mb = random_minibatch(np.random.default_rng(0), TRAIN_BATCH, model.device)
        idx = torch.arange(TRAIN_BATCH, device=model.device)
        gen = torch.Generator(device=model.device).manual_seed(0)
        times = []
        for i in range(UPDATES + 1):
            mask = policy.features.mae.sample_mask(gen, TRAIN_BATCH)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.minibatch_update(mb["data"], idx, mb["advantages"], mb["returns"], mask)
            torch.cuda.synchronize()
            if i:  # the first is a warm-up
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    finally:
        env.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_host: no CUDA device", file=sys.stderr)
        return 1
    import m3l_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = dict(package=m3l_tpu_torch.__file__, card=card, wrapper_n10=wrapper_ms(), serve_batch8_p50_ms=serving_p50_ms(),
               serve_new_batches=serving_new_batches_ms(), ppo_update_ms=update_ms())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
