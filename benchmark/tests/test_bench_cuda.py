"""Card-only checks of the benchmark, run on the card with ``python -m pytest benchmark/tests -m cuda``;
they skip where there is no card (decided inside each test)."""
import importlib
import subprocess
import sys
import json
from pathlib import Path

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[2]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def float32_cells() -> list[str]:
    """The cells (prepared ones too) whose configuration computes in float32."""
    bench = harness.load_benchmark(prepared=True)
    return sorted(w["name"] for w in bench["workloads"]
                  if harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")["compute_dtype"] == "float32")


@pytest.mark.parametrize("workload", float32_cells())
def test_tf32_control_fails_the_limits(workload):
    """The float32 cells' control (TF32 on) at a small size on the card (the ``card_control`` sizes
    of the cell's ``rehearsal/<workload>.json``) is not correct."""
    need_card()
    cell = harness.cell_spec(harness.load_benchmark(prepared=True), workload)
    small = harness.load_json(harness.HERE / "rehearsal" / f"{workload}.json")["card_control"]
    config = {**harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json"), **small["config"]}
    traffic = {**harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"), **small["traffic"]}
    limits = harness.load_json(harness.HERE / "limits" / f"{workload}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    ctx = harness.Context(workload, config, traffic, 2**31 + 7, torch.device("cuda"), False)
    state = driver.setup(ctx)
    driver.window(state, ctx, 0.5)
    numbers = driver.control(state, ctx, "tf32")
    assert any(numbers[k] > limits[k] for k in numbers), numbers


def test_command_runs_a_cell_and_prints_its_result():
    need_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vtt-serve-b8", "--seed", str(2**31 + 3), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
