"""One run of one cell: set-up, the measured window, the traced window (``--trace 1``), the check
against the plain reference, and the result line.

Everything that belongs to one cell is found by name:

* ``BENCHMARK.json`` (at the root of the checkout) names the cell's configuration, traffic and
  metrics;
* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic's parameters, and the ``driver`` that runs it
  (``drivers/<driver>.py``, one per kind of entry point of the program);
* ``limits/<workload>.json``: the limit of each number that decides ``correct``;
* ``metrics/<metric name>.py``: the reader of each per-layer metric, ``read(readings)`` -> a
  number, or None when the traced window holds nothing it reads;
* ``prepared/<workload>.json``: a cell that is not in ``BENCHMARK.json``, with its entries
  (``workload``, ``end_to_end``, ``per_layer``); the tests rehearse it, and ``limit_readings.py``
  reads it, but the command does not run it.

A driver module has ``setup(ctx) -> state``, ``window(state, ctx, seconds) -> (values,
attempted, failed)``, ``traced(state, ctx) -> (timeline, detail)`` (two ``devtrace.Trace``: one of
device activity alone, one with host operators) and ``check(state, ctx) -> {name: value}``.
``setup_s`` leaves out the seconds of the driver's span ``setup.reference``: the plain reference's
own work in set-up, where it makes inputs.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "m3l_tpu")


@dataclass
class Context:
    """What a driver knows of its run."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    device: object
    trace: bool
    fault: str | None = None  # a planted fault, for the tests and the readings of limits
    spans: dict = field(default_factory=dict)  # name -> list of host seconds
    counts: dict = field(default_factory=dict)  # what the readers divide by

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


@dataclass
class Readings:
    """What a per-layer reader reads."""

    trace: object  # devtrace.Trace of the traced window, device activity only
    detail: object  # devtrace.Trace of a second traced window, with host operators and shapes
    counts: dict
    spans: dict
    config: dict
    traffic: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(prepared: bool = False) -> dict:
    """``BENCHMARK.json``; with ``prepared``, the prepared cells' entries added to it."""
    bench = load_json(ROOT / "BENCHMARK.json")
    for path in sorted((HERE / "prepared").glob("*.json")) if prepared else ():
        cell = load_json(path)
        bench = {**bench, "workloads": bench["workloads"] + [cell["workload"]], "end_to_end": bench["end_to_end"] + cell["end_to_end"],
                 "per_layer": bench["per_layer"] + cell["per_layer"]}
    return bench


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, with the end-to-end and per-layer metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = dict(cells[workload])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    cell["end_to_end"], cell["per_layer"] = e2e, per_layer
    return cell


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t0: float, *, bench: dict | None = None,
             overrides: dict | None = None, fault: str | None = None) -> tuple[dict, list[str]]:
    """One run; returns the result object and the check lines. ``overrides`` ({"config": ...,
    "traffic": ...}) shrink a cell for a rehearsal off the card; ``fault`` plants one."""
    import torch

    bench = bench or load_benchmark()
    cell = cell_spec(bench, workload)
    overrides = overrides or {}
    config = _merge(load_json(HERE / "configs" / f"{cell['config']}.json"), overrides.get("config"))
    traffic = _merge(load_json(HERE / "traffic" / f"{cell['traffic']}.json"), overrides.get("traffic"))
    limits = load_json(HERE / "limits" / f"{workload}.json")
    ctx = Context(workload, config, traffic, seed, torch.device(device), trace, fault)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")

    state = driver.setup(ctx)
    _sync(device)
    setup_s = time.perf_counter() - t0 - sum(ctx.spans.get("setup.reference", []))
    values, attempted, failed = driver.window(state, ctx, seconds)
    values["setup_s"] = setup_s

    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {}}
    dev_info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
                "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
                "count": cell["chips"]}
    if trace:
        tr, detail = driver.traced(state, ctx)
        readings = Readings(tr, detail, ctx.counts, ctx.spans, config, traffic)
        for m in cell["per_layer"]:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"benchmark_metric_{m['name'].replace('.', '_')}")
            value = reader.read(readings)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": detail.top_idle_gaps()}
    else:
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda" else 0
    result["device"] = dev_info

    numbers = driver.check(state, ctx)
    del state
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    result["correct"] = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks  # last key: each compared number beside its limit
    setup = {k: round(sum(v), 3) for k, v in ctx.spans.items() if k.startswith("setup.")}
    lines = [f"set-up spans (s): {json.dumps(setup)}"] if setup else []
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def main(argv: list[str], t0: float) -> int:
    parser = argparse.ArgumentParser("benchmark")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    bench = load_benchmark()
    chips = cell_spec(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}, which it may not; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0
