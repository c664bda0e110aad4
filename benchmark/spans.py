"""The program's own spans (``m3l_tpu_torch/utils/trace.py``) read against a traced window's device
timeline: where the device's idle time falls in the program, and six per-layer numbers.

The program stamps its spans with ``time.time_ns()``, the clock of the profiler's events, so a
span and the device operations of the same window need no offset. The command (``run.py``) does
not record them: its traced windows (``devtrace.Recorder``) leave the program's recorder off. This
module runs one cell as the command does, with each traced window recording the program's spans
too, and prints the command's result line with a ``program_spans`` object added:

    python3 -m benchmark.spans --workload vtt-serve-b8 --seed 12345 --seconds 40

``program_spans`` holds ``idle_spans`` (the timeline window's idle time grouped by the innermost
program span open on the main thread in the middle of each gap, ``outside`` where none was; the
ten largest groups, [[name, s], ...]), ``idle_s`` (all the window's idle time: the groups' sum
when there are ten or fewer), ``metrics`` (those of ``METRICS`` that the window holds), ``mean_ms``
(every span name's mean host ms and count) and, where the window copied anything back,
``dtoh_outside_readback_us``: how far the end of each device-to-host copy lies outside every
``serve.readback`` span, the largest and the count of copies; ``host_waits`` (the CUDA calls that
took a tenth of a millisecond or more, by the span they fell in) and ``detail_host_waits``, the
same in the second traced window, which records host operators. With ``--window-spans 1`` the
measured window records the program's spans too (no traced window; ``--trace 0``'s result): the
cost of recording, against the command's own run of the same seed.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import json
import sys
import threading
import time
from collections import defaultdict

from . import devtrace, harness

OUTSIDE = "outside"


def main_thread(spans: list) -> list:
    ident = threading.main_thread().ident
    return sorted((s for s in spans if s.thread == ident), key=lambda s: s.start_ns)


def innermost(spans: list, starts: list[int], t_ns: float):
    """The innermost of ``spans`` (one thread's, sorted by start; ``starts`` their starts) open at
    ``t_ns``: the latest begun of those that hold it, since one thread's spans nest."""
    for j in range(bisect.bisect_right(starts, t_ns) - 1, -1, -1):
        if spans[j].end_ns >= t_ns:
            return spans[j]
    return None


def window_gaps(tr) -> list[tuple[float, float]]:
    """The idle stretches (s, trace clock) of the traced window ``tr.window_ns``."""
    lo, hi = (t * 1e-9 for t in tr.window_ns)
    return devtrace.idle_gaps([(d.start, d.end) for d in tr.device_ops], lo, hi)


def idle_by_span(tr, k: int = 10) -> tuple[list[list], float]:
    """The window's idle time grouped by the innermost program span open on the main thread at each
    gap's midpoint (``outside`` where none was): the ``k`` largest groups, [[name, s], ...], and the
    idle time in all. Nothing when the window ran no device operation."""
    if not tr.device_ops:
        return [], 0.0
    spans = main_thread(tr.program_spans)
    starts = [s.start_ns for s in spans]
    total: dict[str, float] = defaultdict(float)
    for lo, hi in window_gaps(tr):
        s = innermost(spans, starts, (lo + hi) * 0.5e9)
        total[OUTSIDE if s is None else s.name] += hi - lo
    return [[n, v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:k]], sum(total.values())


def span_ms(tr, name: str) -> float | None:
    """Mean host ms of the program's span ``name`` in the window."""
    xs = [s.end_ns - s.start_ns for s in tr.program_spans if s.name == name]
    return 1e-6 * sum(xs) / len(xs) if xs else None


def idle_share_inside(tr, name: str) -> float | None:
    """% of the window in which the device ran nothing while the main thread was inside the span
    ``name``."""
    if not tr.device_ops or tr.window_s <= 0:
        return None
    inside = [(s.start_ns * 1e-9, s.end_ns * 1e-9) for s in main_thread(tr.program_spans) if s.name == name]
    if not inside:
        return None
    both, i = 0.0, 0
    for lo, hi in window_gaps(tr):  # both lists sorted and disjoint (a span of one name does not nest in itself)
        while i < len(inside) and inside[i][1] <= lo:
            i += 1
        j = i
        while j < len(inside) and inside[j][0] < hi:
            both += min(hi, inside[j][1]) - max(lo, inside[j][0])
            j += 1
    return 100.0 * both / tr.window_s


METRICS = {  # the per-layer numbers the spans give, by name
    "update_host_ms.update": lambda tr: span_ms(tr, "ppo.update"),
    "dispatch_ms.serve": lambda tr: span_ms(tr, "serve.forward"),
    "readback_ms.serve": lambda tr: span_ms(tr, "serve.readback"),
    "loader_span_ms.pretrain": lambda tr: span_ms(tr, "data.batch"),
    "step_host_ms.pretrain": lambda tr: span_ms(tr, "trainer.step"),
    "loader_idle_share.pretrain": lambda tr: idle_share_inside(tr, "data.batch"),
}


def dtoh_outside(tr, name: str = "serve.readback") -> tuple[float, int] | None:
    """The largest distance (us) by which a device-to-host copy ends outside every span ``name``
    (0 inside one), and the count of copies; None without copies."""
    ends = [d.end for d in tr.device_ops if "DtoH" in d.name]
    if not ends:
        return None
    spans = sorted(((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in tr.program_spans if s.name == name))
    starts = [s for s, _ in spans]
    worst = 0.0
    for t in ends:
        i = bisect.bisect_right(starts, t)
        near = [spans[j] for j in (i - 1, i) if 0 <= j < len(spans)]
        worst = max(worst, min((max(lo - t, t - hi, 0.0) for lo, hi in near), default=float("inf")))
    return 1e6 * worst, len(ends)


def host_waits(tr, k: int = 10, min_s: float = 1e-4) -> list[list]:
    """CUDA API calls of at least ``min_s`` (a launch takes microseconds; a call
    that long waited: for the device, or for room in the launch queue) grouped by the innermost
    program span open on the main thread at the call's middle and the call's name: the ``k``
    largest groups, [[span, call, s, count], ...]."""
    spans = main_thread(tr.program_spans)
    starts = [s.start_ns for s in spans]
    total: dict[tuple, list] = defaultdict(lambda: [0.0, 0])
    for name, lo, hi in tr.runtime_calls:
        if hi - lo >= min_s:
            s = innermost(spans, starts, (lo + hi) * 0.5e9)
            group = total[(OUTSIDE if s is None else s.name, name)]
            group[0] += hi - lo
            group[1] += 1
    return [[a, b, v, n] for (a, b), (v, n) in sorted(total.items(), key=lambda kv: -kv[1][0])[:k]]


def summary(tr) -> dict:
    groups, idle = idle_by_span(tr)
    out = {"idle_spans": groups, "idle_s": idle, "window_s": tr.window_s, "busy_s": tr.busy_s(), "metrics": {}}
    for name, read in METRICS.items():
        value = read(tr)
        if value is not None:
            out["metrics"][name] = value
    by_name = defaultdict(list)
    for s in tr.program_spans:
        by_name[s.name].append(s.end_ns - s.start_ns)
    out["mean_ms"] = {n: [1e-6 * sum(xs) / len(xs), len(xs)] for n, xs in sorted(by_name.items())}
    copies = dtoh_outside(tr)
    if copies is not None:
        out["dtoh_outside_readback_us"] = list(copies)
    out["host_waits"] = host_waits(tr)
    return out


class SpanRecorder(devtrace.Recorder):
    """``devtrace.Recorder`` whose window also records the program's spans: the ``Trace`` it
    returns has ``program_spans`` and ``window_ns``, the window's first and last instant on the
    profiler's clock (after the synchronise that opens it, after the one that closes it)."""

    def start(self):
        from m3l_tpu_torch.utils import trace

        super().start()
        self.lo_ns = time.time_ns()
        trace.start()

    def stop(self) -> devtrace.Trace:
        from m3l_tpu_torch.utils import trace

        self._sync()
        hi_ns = time.time_ns()
        window = time.perf_counter() - self.t0
        spans = trace.stop()
        self.prof.stop()
        tr = devtrace.Trace.from_profiler(self.prof, window)
        tr.program_spans, tr.window_ns = spans, (self.lo_ns, hi_ns)
        tr.runtime_calls = runtime_calls(self.prof)
        return tr


def runtime_calls(prof) -> list[tuple[str, float, float]]:
    """The host's CUDA API calls (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
    ``cudaStreamSynchronize``, ...) in a profiler's events: (name, start s, end s)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("cu"):
            start = e.start_ns() * 1e-9
            out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return out


@contextlib.contextmanager
def recording_spans(runner, window_spans: bool, kept: dict):
    """The cell's traced windows record the program's spans (their traces kept in ``kept``), or,
    with ``window_spans``, its measured window does; ``runner`` is the module under
    ``benchmark/drivers/`` that runs the cell."""
    from m3l_tpu_torch.utils import trace

    saved = devtrace.Recorder, {k: getattr(runner, k) for k in ("Recorder", "window", "traced") if hasattr(runner, k)}
    window, traced = runner.window, runner.traced

    def window_recorded(state, ctx, seconds):
        trace.start()
        try:
            return window(state, ctx, seconds)
        finally:
            trace.stop()

    def traced_kept(state, ctx):
        kept["traces"] = traced(state, ctx)
        return kept["traces"]

    devtrace.Recorder = SpanRecorder
    if hasattr(runner, "Recorder"):
        runner.Recorder = SpanRecorder
    if window_spans:
        runner.window = window_recorded
    runner.traced = traced_kept
    try:
        yield
    finally:
        devtrace.Recorder = saved[0]
        for key, value in saved[1].items():
            setattr(runner, key, value)


def run(workload: str, seed: int, seconds: float, window_spans: bool, device, t0: float, *, bench: dict | None = None,
        overrides: dict | None = None) -> dict:
    """One run of the cell as ``harness.run_cell`` makes it, its traced windows recording the
    program's spans (``--trace 1``), or its measured window (``window_spans``, ``--trace 0``)."""
    bench = bench or harness.load_benchmark(prepared=True)
    cell = harness.cell_spec(bench, workload)
    traffic = harness._merge(harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"), (overrides or {}).get("traffic"))
    runner = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    kept: dict = {}
    with recording_spans(runner, window_spans, kept):
        result, _ = harness.run_cell(workload, seed, seconds, not window_spans, device, t0, bench=bench, overrides=overrides)
    if "traces" in kept:
        timeline, detail = kept["traces"]
        result["program_spans"] = summary(timeline)
        result["program_spans"]["detail_host_waits"] = host_waits(detail)
    return result


def main(argv: list[str], t0: float) -> int:
    parser = argparse.ArgumentParser("benchmark.spans")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--window-spans", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("benchmark.spans: no CUDA device", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.window_spans), "cuda", t0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], time.perf_counter()))
