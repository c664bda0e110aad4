"""The program's spans (``m3l_tpu_torch/utils/trace.py``) in one cell's measured window, with no
profiler running: what each span takes on the host when nothing traces the device.

    python3 -m benchmark.window_spans --workload vtt-serve-b8 --seed 12345 --seconds 40

``benchmark.spans`` reads its span metrics from traced windows, where the profiler's hooks on the
CUDA calls lengthen some of them (a CUDA graph's launch most), and its ``--window-spans 1`` records
the measured window's spans without printing them. This module runs the cell as the command does
(``--trace 0``), records the program's spans in the measured window, and prints the command's
result line with ``window_spans`` added: each span name's mean and median host ms and count. Where
the cell's state holds a ``server``, ``server`` holds what each of its counters (those of
``COUNTERS`` it has) gained in the window.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import time
from collections import defaultdict

from . import harness

COUNTERS = ("requests", "eager_requests", "graph_captures", "graph_replays", "capture_failures")


def counters(state) -> dict:
    server = state.get("server")
    return {k: getattr(server, k) for k in COUNTERS if hasattr(server, k)}


def run(workload: str, seed: int, seconds: float, device, t0: float, *, bench: dict | None = None,
        overrides: dict | None = None) -> dict:
    """One run of the cell as ``harness.run_cell`` makes it untraced, the program's spans recorded
    in its measured window."""
    from m3l_tpu_torch.utils import trace

    bench = bench or harness.load_benchmark(prepared=True)
    cell = harness.cell_spec(bench, workload)
    traffic = harness._merge(harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"), (overrides or {}).get("traffic"))
    runner = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    window, kept = runner.window, {}

    def recorded(state, ctx, secs):
        before = counters(state)
        trace.start()
        try:
            return window(state, ctx, secs)
        finally:
            kept["spans"] = trace.stop()
            kept["server"] = {k: v - before[k] for k, v in counters(state).items()}

    runner.window = recorded
    try:
        result, _ = harness.run_cell(workload, seed, seconds, False, device, t0, bench=bench, overrides=overrides)
    finally:
        runner.window = window
    by_name = defaultdict(list)
    for s in kept["spans"]:
        by_name[s.name].append(1e-6 * (s.end_ns - s.start_ns))
    result["window_spans"] = {n: {"mean_ms": statistics.fmean(v), "p50_ms": statistics.median(v), "n": len(v)}
                              for n, v in sorted(by_name.items())}
    if kept["server"]:
        result["server"] = kept["server"]
    return result


def main(argv: list[str], t0: float) -> int:
    parser = argparse.ArgumentParser("benchmark.window_spans")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("benchmark.window_spans: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.workload, args.seed, args.seconds, "cuda", t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
