"""Where the serving time goes: the full-width policy under ``torch.profiler`` on the card.

    python -m m3l_tpu_torch.profile_serve

For batch 8 (the CLI's default env count) and batch 512 (the PPO minibatch): the host time
per request (``PolicyServer.__call__``, raw numpy obs in, numpy actions out) untraced and
traced, the device time per request summed over the kernels and copies the profiler saw, the
device's idle share of the untraced request (1 - device / host), and the top kernels by
device time. Weights and obs are random from seed 0; timing does not depend on them. The
``REQUESTS`` profiled requests follow one warm-up request per batch size. Prints one JSON line
per batch.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .serve import PolicyServer, build_policy, random_obs

BATCHES = (8, 512)
REQUESTS = 5
TOP = 12


def profile_batch(server: PolicyServer, batch: int, requests: int, rng: np.random.Generator) -> dict:
    obs = [random_obs(rng, batch) for _ in range(requests)]
    server(obs[0])  # warm-up
    t0 = time.perf_counter()
    for o in obs:
        server(o)
    host_s = time.perf_counter() - t0  # untraced
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for o in obs:
            server(o)
        traced_s = time.perf_counter() - t0
    per_kernel: dict[str, float] = defaultdict(float)
    n_device = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name] += evt.time_range.elapsed_us()
            n_device += 1
    device_us = sum(per_kernel.values())
    host_ms = host_s * 1e3 / requests
    device_ms = device_us / 1e3 / requests
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        batch=batch, requests=requests, host_ms_per_request=host_ms, traced_host_ms_per_request=traced_s * 1e3 / requests,
        device_ms_per_request=device_ms,
        device_idle_share=1.0 - device_ms / host_ms, device_ops_per_request=n_device / requests,
        top_kernels=[dict(name=k[:120], ms_per_request=v / 1e3 / requests, share_of_device=v / device_us) for k, v in ranked],
    )


def main() -> None:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.manual_seed(0)
    server = PolicyServer(build_policy(dtype=torch.bfloat16, device="cuda"))
    rng = np.random.default_rng(0)
    print(f"device: {torch.cuda.get_device_name(0)}")
    for batch in BATCHES:
        r = profile_batch(server, batch, REQUESTS, rng)
        print(f"batch {batch}: host {r['host_ms_per_request']:.3f} ms/request ({r['traced_host_ms_per_request']:.3f} traced), device {r['device_ms_per_request']:.3f} ms/request, "
              f"idle share {r['device_idle_share']:.3f}, {r['device_ops_per_request']:.0f} device ops/request")
        for k in r["top_kernels"]:
            print(f"  {k['ms_per_request']:9.4f} ms  {k['share_of_device']:6.1%}  {k['name']}")
        print(json.dumps(r))


if __name__ == "__main__":
    main()
