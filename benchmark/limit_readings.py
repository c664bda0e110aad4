"""Readings that the limits of ``limits/<workload>.json`` are set from, at the cell's own size on
the card, many seeds in one process:

* ``program``: the numbers of sound runs of the program (the lower reading);
* ``control``: the same numbers with the plain reference, computed in the next precision below
  the configuration's, put in the program's place (``--control fp8`` or ``tf32``);
* ``fault:<name>``: with a fault planted in the program's timed path.

    python3 benchmark/limit_readings.py --workload vtt-ppo-train --seeds 101 102 103 \\
        --control fp8 --faults state_unchanged half_batch

Each reading is one JSON line on standard output and in ``--out`` (default
``chiprun_out/limit_readings.jsonl``). The benchmark's own runs never run this.
"""
import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser("limit_readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0,
                   help="window of each run; 0 skips it (a training check needs only set-up's steps, serving needs answers)")
    p.add_argument("--control", default=None, help="fp8 or tf32")
    p.add_argument("--control-seeds", type=int, default=3, help="how many of the seeds also read the control and the faults")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "limit_readings.jsonl"))
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    device = torch.device("cuda")
    bench = harness.load_benchmark(prepared=True)  # a prepared cell's limits are read before it joins the benchmark
    cell = harness.cell_spec(bench, args.workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    def emit(kind, seed, numbers, t0, ctx):
        line = {"workload": args.workload, "kind": kind, "seed": seed, "numbers": numbers, "s": time.perf_counter() - t0,
                "worst_leaves": ctx.counts.get("worst_leaves"), "device": torch.cuda.get_device_name(device)}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")

    for i, seed in enumerate(args.seeds):
        runs = [None]
        if i < args.control_seeds:
            runs += [f"fault:{f}" for f in args.faults]
        for run in runs:
            t0 = time.perf_counter()
            ctx = harness.Context(args.workload, config, traffic, seed, device, False, None if run is None else run.split(":", 1)[1])
            state = driver.setup(ctx)
            if args.seconds > 0:
                driver.window(state, ctx, args.seconds)
            emit(run or "program", seed, driver.check(state, ctx), t0, ctx)
            del state
            torch.cuda.empty_cache()
        if args.control and i < args.control_seeds:
            t0 = time.perf_counter()
            ctx = harness.Context(args.workload, config, traffic, seed, device, False)
            state = driver.setup(ctx)
            if args.seconds > 0:
                driver.window(state, ctx, args.seconds)
            state_numbers = driver.control(state, ctx, args.control)
            emit(f"control:{args.control}", seed, state_numbers, t0, ctx)
            del state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
