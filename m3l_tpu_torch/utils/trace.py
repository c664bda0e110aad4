"""Spans of the program's work on the host, on the profiler's clock.

A span names one stretch of host time at a layer boundary (``ppo.update``, ``serve.readback``,
``trainer.step``, ...): its start and end from ``time.time_ns()``, which is the clock of
``torch.profiler``'s events (``KinetoEvent.start_ns()`` reads Unix-epoch nanoseconds), so a span
lies on the same timeline as the device operations a profiler records beside it.

Recording is off until :func:`start` and off again after :func:`stop`, which returns what was
kept; spans are kept in memory only. Off, :func:`span` reads one module-level flag and returns a
shared do-nothing context: it allocates nothing and reads no clock. Spans never emit a
``torch.profiler.record_function``, so a profiler's own trace is the same with recording on or
off. One recording is kept at a time: :func:`start` inside a recording drops what it held.

    trace.start()
    with trace.span("serve.request", 7):
        ...
    spans = trace.stop()  # [Span("serve.request", start_ns, end_ns, -1, 7, thread), ...]
"""
from __future__ import annotations

import json
import threading
import time
from typing import NamedTuple

__all__ = ["Span", "span", "start", "stop", "add_to_chrome_trace"]


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns(): the profiler's clock
    end_ns: int
    parent: int  # index of the innermost span open on the same thread when this one began, or -1
    ident: int | None  # the unit of work: a request number, an update's index, a global step
    thread: int  # threading.get_ident() of the thread that ran it


class _Recording:
    """What one recording keeps: a record per span in the order the spans began, ``[name,
    start_ns, end_ns or None while open, parent, ident, thread]``, and each thread's stack of
    open spans."""

    def __init__(self):
        self.records: list[list] = []
        self.stacks: dict[int, list[int]] = {}
        self.lock = threading.Lock()


class _Off:
    """The do-nothing context of every span while recording is off (cheaper to enter than
    ``contextlib.nullcontext``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()
_recording: _Recording | None = None  # the recording kept while on; None while off


class _Open:
    __slots__ = ("rec", "name", "ident", "index", "stack")

    def __init__(self, rec: _Recording, name: str, ident):
        self.rec, self.name, self.ident = rec, name, ident

    def __enter__(self):
        thread = threading.get_ident()
        rec = self.rec
        with rec.lock:
            stack = rec.stacks.setdefault(thread, [])
            self.index, self.stack = len(rec.records), stack
            rec.records.append([self.name, time.time_ns(), None, stack[-1] if stack else -1, self.ident, thread])
        stack.append(self.index)

    def __exit__(self, *exc):
        self.rec.records[self.index][2] = time.time_ns()
        self.stack.pop()


def span(name: str, ident: int | None = None):
    """A context manager that records the host time of its body as the span ``name`` while
    recording is on, and does nothing while it is off."""
    rec = _recording  # read once: another thread may stop the recording meanwhile
    if rec is None:
        return _OFF
    return _Open(rec, name, ident)


def start() -> None:
    """Turn recording on, with nothing kept."""
    global _recording
    _recording = _Recording()


def stop() -> list[Span]:
    """Turn recording off and return the spans that closed while it was on, in the order they
    began. A span still open is left out, and a span whose parent was still open gets parent -1
    (that parent's own parents were open too)."""
    global _recording
    rec, _recording = _recording, None
    if rec is None:
        return []
    with rec.lock:
        records = [list(r) for r in rec.records]
    closed = [i for i, r in enumerate(records) if r[2] is not None]
    index = {old: new for new, old in enumerate(closed)}
    return [Span(r[0], r[1], r[2], index.get(r[3], -1), r[4], r[5]) for r in (records[i] for i in closed)]


def add_to_chrome_trace(path: str, spans: list[Span]) -> None:
    """Add ``spans`` to the Chrome trace ``path`` that ``torch.profiler`` exported, as complete
    events (``ph: "X"``; ``ts`` and ``dur`` in microseconds, ``ts`` from the file's
    ``baseTimeNanoseconds`` as the profiler's own) on a track of their own, a row a thread."""
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), "program spans"
    doc["traceEvents"].append({"ph": "M", "name": "process_name", "pid": pid, "args": {"name": pid}})
    for s in spans:
        doc["traceEvents"].append({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                                   "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"ident": s.ident, "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(doc, f)
