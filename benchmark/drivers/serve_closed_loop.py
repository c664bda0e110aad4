"""Closed-loop serving: one client sends a batch of raw observations to ``PolicyServer.__call__``
and sends the next only after the reply.

Set-up builds the policy as ``serve.build_policy`` does, loads the benchmark's weights, makes a
pool of seeded observation batches on the card and keeps it as host arrays (what an env hands
the server), and serves ``warmup_requests`` of them. Request i of the window serves pool entry
i mod ``pool``; its latency is the host time from the call to the numpy actions in hand. Every
answer of the window is kept and checked afterwards against the reference's actions for its
entry.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import stats
from ..devtrace import record
from ..reference.numerics import numerics
from ..reference.vtt import VTTReference
from ..weights import load_into, make_weights, parameter_shapes, stream_seed
from .ppo_update import host, make_obs

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def setup(ctx):
    from m3l_tpu_torch.models import VTTConfig
    from m3l_tpu_torch.serve import PolicyServer, build_policy

    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    vtt = VTTConfig(dim=cfg["dim_embedding"], depth=cfg["depth"], heads=cfg["heads"], dim_head=cfg["dim_head"], mlp_dim=cfg["mlp_dim"],
                    num_tactiles=cfg["num_tactiles"], frame_stack=cfg["frame_stack"])
    policy = build_policy(vtt, action_dim=cfg["action_dim"], decoder_depth=cfg["decoder_depth"], decoder_heads=cfg["decoder_heads"],
                          dtype=_DTYPES[cfg["compute_dtype"]], device=device)
    shapes = parameter_shapes(policy)
    weights = make_weights(shapes, ctx.seed, device)
    load_into(policy, weights)
    low, high = np.full(cfg["action_dim"], -1.0, np.float32), np.full(cfg["action_dim"], 1.0, np.float32)
    server = PolicyServer(policy, action_low=low, action_high=high)
    gen = torch.Generator(device=device).manual_seed(stream_seed(ctx.seed, 2))
    b = tr["batch"]
    flat = host(make_obs(gen, tr["pool"] * b, cfg, device))
    pool = [{k: v[i * b : (i + 1) * b] for k, v in flat.items()} for i in range(tr["pool"])]
    for i in range(tr["warmup_requests"]):
        server(pool[i % len(pool)])
    state = {"server": server, "pool": pool, "weights": weights, "answers": []}
    if ctx.fault is not None:
        _plant(state, ctx.fault)
    return state


def _plant(state, fault: str) -> None:
    if fault != "answer_altered":
        raise ValueError(f"no fault {fault!r} in this cell")
    server = state["server"]
    orig, calls = server.__call__, [0]

    def altered(obs):  # the window's first answer leaves the server with one action moved
        out = orig(obs)
        calls[0] += 1
        if calls[0] == 1:
            out = out.copy()
            out[0, 0] += 0.25
        return out

    state["serve"] = altered


def window(state, ctx, seconds):
    serve = state.get("serve", state["server"])
    pool, answers, lat = state["pool"], state["answers"], []
    t_start = time.perf_counter()
    i = 0
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        out = serve(pool[i % len(pool)])
        lat.append(time.perf_counter() - t0)
        answers.append(out)
        i += 1
    ctx.counts.update(requests=i, window_s=time.perf_counter() - t_start)
    return {"serve_p95_ms": 1e3 * stats.percentile(lat, 95.0)}, i, 0


def traced(state, ctx):
    """``trace_requests`` more requests traced with device activity alone, then as many with host
    operators."""
    serve, pool = state["server"], state["pool"]
    n = ctx.traffic["trace_requests"]

    def run():
        for i in range(n):
            serve(pool[i % len(pool)])

    ctx.counts["requests_traced"] = n
    return record(ctx.device, False, run), record(ctx.device, True, run)


def reference_actions(ctx, weights, pool, kind: str = "f32") -> list[np.ndarray]:
    """The reference's clipped actions for every pool entry, in blocks of ``check_block``."""
    ref = VTTReference(ctx.config, ctx.device)
    block = ctx.traffic["check_block"]
    out = []
    with numerics(kind) as num, torch.no_grad():
        for s in range(0, len(pool), block):
            entries = pool[s : s + block]
            obs = {k: torch.as_tensor(np.concatenate([e[k] for e in entries])).to(ctx.device) for k in entries[0]}
            mean, _ = ref.act(num, weights, obs)
            acts = torch.clamp(mean, -1.0, 1.0).cpu().numpy()
            out += list(acts.reshape(len(entries), -1, acts.shape[-1]))
    return out


def gaps(answers: list[np.ndarray], reference: list[np.ndarray], gauge: list[np.ndarray]) -> dict:
    """Each answer's distance from the float32 reference's actions for its pool entry, in units
    of the distance of the gauge (the reference with every product's operands rounded to
    bfloat16) from the same: ``action_gap`` the widest over every action of every answer,
    ``action_rms_gap`` the root mean square. Measured so, a seed's own sensitivity to rounding
    (random weights differ in it by several times) cancels."""
    pool = len(reference)
    ref = np.stack([reference[i % pool] for i in range(len(answers))]).astype(np.float64)
    diff = np.stack(answers).astype(np.float64) - ref
    unit = np.stack([gauge[i % pool] for i in range(len(answers))]).astype(np.float64) - ref
    return {"action_gap": float(np.abs(diff).max() / max(np.abs(unit).max(), 1e-30)),
            "action_rms_gap": float(np.sqrt(np.mean(diff**2)) / max(np.sqrt(np.mean(unit**2)), 1e-30))}


def reference_gaps(ctx, weights, pool, answers) -> dict:
    return gaps(answers, reference_actions(ctx, weights, pool), reference_actions(ctx, weights, pool, "bf16"))


def check(state, ctx) -> dict:
    answers, pool, weights = state["answers"], state["pool"], state["weights"]
    state["server"] = state["serve"] = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return reference_gaps(ctx, weights, pool, answers)


def control(state, ctx, kind: str) -> dict:
    """The reference in ``kind`` serving the window's requests in the program's place."""
    pool = state["pool"]
    served = reference_actions(ctx, state["weights"], pool, kind)
    answers = [served[i % len(pool)] for i in range(len(state["answers"]))]
    return reference_gaps(ctx, state["weights"], pool, answers)
