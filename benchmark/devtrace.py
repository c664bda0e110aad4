"""The reduction of a ``torch.profiler`` trace to the numbers the per-layer readers take.

The profiler's own events are read (``kineto_results.events()``), not its summary tables: device
operations (kernels, copies, fills) with their start and end, and host operators with their
start, end, input shapes and dtypes. A device operation is tied to the host operator that launched
it by the profiler's correlation id; an operator's device time is that of every device operation
launched while it ran (its children's included). Busy time is the union of the device operations'
intervals, so overlapping operations count once.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class DeviceOp:
    name: str
    start: float  # seconds, trace clock
    end: float
    launcher: int  # correlation id of the host operator that launched it (0: none known)


@dataclass
class HostOp:
    name: str
    start: float
    end: float
    ident: int
    thread: int
    shapes: list = field(default_factory=list)
    dtypes: list = field(default_factory=list)


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by the intervals, each point counted once."""
    total, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def idle_gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


def profiler(device, detail: bool):
    """A ``torch.profiler`` for one traced window. Without ``detail`` it records device activity
    only, which costs the host least: the busy time, the idle share and the device operations are
    read from it. With ``detail`` it records host operators with their input shapes too, for
    what needs to know which operator launched what (rooflines, the idle gaps' causes); its host
    overhead stretches the window, so no idle share is read from it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else []
    if detail or not acts:
        acts = [torch.profiler.ProfilerActivity.CPU] + acts
    return torch.profiler.profile(activities=acts, record_shapes=detail)


class Recorder:
    """Starts and stops one traced window: a synchronise before the profiler starts and before it
    stops, the host clock between them."""

    def __init__(self, device, detail: bool):
        self.device, self.prof = device, profiler(device, detail)

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        import time

        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> "Trace":
        import time

        self._sync()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        return Trace.from_profiler(self.prof, window)


def record(device, detail: bool, run) -> "Trace":
    """The trace of ``run()``."""
    rec = Recorder(device, detail)
    rec.start()
    run()
    return rec.stop()


class Trace:
    """Device and host operations of one traced window, and ``window_s``, its length on the host's
    clock (from a synchronise before the profiler starts to one before it stops)."""

    def __init__(self, device_ops: list[DeviceOp], host_ops: list[HostOp], window_s: float):
        self.device_ops = sorted(device_ops, key=lambda d: d.start)
        self.host_ops = sorted(host_ops, key=lambda h: h.start)
        self.window_s = window_s
        self._by_id = {h.ident: h for h in self.host_ops}

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            end = start + e.duration_ns() * 1e-9
            kind = e.device_type()
            if kind == DeviceType.CUDA:
                dev.append(DeviceOp(e.name(), start, end, e.linked_correlation_id()))
            elif kind == DeviceType.CPU and e.linked_correlation_id() == 0:
                host.append(HostOp(e.name(), start, end, e.correlation_id(), e.start_thread_id(), e.shapes(), e.dtypes()))
        return cls(dev, host, window_s)

    # --------------------------------------------------------------------------------------- #
    def busy_s(self) -> float:
        return union_length([(d.start, d.end) for d in self.device_ops])

    def span(self) -> tuple[float, float]:
        """First and last instant of the traced operations (host and device)."""
        starts = [d.start for d in self.device_ops] + [h.start for h in self.host_ops]
        ends = [d.end for d in self.device_ops] + [h.end for h in self.host_ops]
        return (min(starts), max(ends)) if starts else (0.0, 0.0)

    def launcher(self, op: DeviceOp) -> HostOp | None:
        return self._by_id.get(op.launcher)

    def under(self, names: tuple[str, ...]) -> list[tuple[HostOp, list[DeviceOp]]]:
        """Each call of a host operator named in ``names`` with the device operations launched
        while it ran (by it or by operators it called)."""
        calls = [h for h in self.host_ops if h.name in names]
        starts = [c.start for c in calls]
        out = [(c, []) for c in calls]
        for d in self.device_ops:
            h = self.launcher(d)
            if h is None:
                continue
            i = bisect.bisect_right(starts, h.start) - 1
            if i >= 0 and calls[i].start <= h.start <= calls[i].end:
                out[i][1].append(d)
        return out

    def top_device_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations (by name) that took most device time: [[name, s], ...]."""
        total: dict[str, float] = defaultdict(float)
        for d in self.device_ops:
            total[d.name[:160]] += d.end - d.start
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def top_idle_gaps(self, k: int = 10) -> list[list]:
        """The device's idle time inside the traced span grouped by what the host was doing in the
        middle of each gap (the innermost host operator open then, or ``host`` when none was, as
        in Python between operators): the ``k`` largest groups, [[name, s], ...]."""
        lo, hi = self.span()
        gaps = idle_gaps([(d.start, d.end) for d in self.device_ops], lo, hi)
        total: dict[str, float] = defaultdict(float)
        opens = self.host_ops
        starts = [h.start for h in opens]
        for s, e in gaps:
            name, mid = "host", (s + e) / 2
            i = bisect.bisect_right(starts, mid) - 1
            # the innermost operator open at mid: scan back over the few that started just before
            for j in range(i, max(i - 64, -1), -1):
                if opens[j].start <= mid <= opens[j].end:
                    name = opens[j].name
                    break
            total[name[:160]] += e - s
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:k]]
