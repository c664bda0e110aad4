"""A rehearsal of every cell off the card: the harness's run (``harness.run_cell``) at tiny widths
on the CPU, where the port's operators run their plain versions. It checks that each cell's
driver, readers and check run end to end; that the plain reference follows the program (a
float32 program agrees with it to rounding); that each fault a cell can have, planted in the
timed path, turns ``correct`` false under the cell's limits, on a number that the sound run of the
same seed passes; and that the control (the reference
in the next precision below) fails them too. The command itself refuses to run without a card."""
import time

import pytest
import torch

from benchmark import harness

VTT = {"dim_embedding": 64, "mlp_dim": 128, "rollout_length": 64, "n_envs": 2, "batch_size": 16, "ppo_epochs": 2}
VIT = {"img_size": 32, "patch_size": 8, "depth": 2, "dino_out_dim": 512, "dino_hidden_dim": 64, "batch_size": 4}
TRAFFIC = {"trace_from_update": 1, "trace_updates": 2, "reference_block": 16, "pool": 6, "warmup_requests": 2, "trace_requests": 3, "check_block": 4,
           "epoch_batches": 3, "trace_steps": 2}
TINY = {"vtt-ppo-train": VTT, "vtt-serve-b8": VTT, "vits-dino-pretrain": VIT, "vits-force-probe": VIT}
FAULTS = {"vtt-ppo-train": ["state_unchanged", "half_batch"], "vtt-serve-b8": ["answer_altered"],
          "vits-dino-pretrain": ["state_unchanged", "half_batch", "teacher_unchanged"], "vits-force-probe": ["state_unchanged", "half_batch"]}
SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, trace=False, fault=None, **config):
    over = {"config": {**TINY[workload], **config}, "traffic": TRAFFIC}
    return harness.run_cell(workload, SEED, 0.2, trace, "cpu", time.perf_counter(), bench=harness.load_benchmark(prepared=True), overrides=over,
                            fault=fault)


def test_cells_are_the_benchmarks():  # and the prepared cells
    assert sorted(TINY) == sorted(w["name"] for w in harness.load_benchmark(prepared=True)["workloads"])


def test_prepared_cells_are_not_run_by_the_command():
    assert "vits-force-probe" not in [w["name"] for w in harness.load_benchmark()["workloads"]]
    with pytest.raises(SystemExit):
        harness.cell_spec(harness.load_benchmark(), "vits-force-probe")


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_runs_end_to_end(workload):
    result, lines = run(workload, trace=True)
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert [ln for ln in lines if ln.startswith("check ")] == lines[-len(result["checks"]):]
    assert len(result["checks"]) >= 1
    for m in result["metrics"].values():  # off the card the readers of device time find nothing
        assert m["value"] > 0


@pytest.mark.parametrize("workload", sorted(TINY))
def test_float32_program_follows_the_reference(workload):
    extra = {"compute_dtype": "float32"} if workload.startswith("vtt") else {}
    result, _ = run(workload, **extra)
    # serving's gaps are in units of the bfloat16 gauge's; the rest are shares of the reference
    tolerance = {"update_gap": 2e-3, "action_gap": 1e-2, "action_rms_gap": 1e-2}
    for name, c in result["checks"].items():
        assert c["value"] < tolerance.get(name, 1e-5), (name, c)


@pytest.mark.parametrize("workload,fault", [(w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_planted_fault_is_not_correct(workload, fault):
    sound, _ = run(workload)
    result, _ = run(workload, fault=fault)
    assert result["correct"] is False, result["checks"]
    # the fault fails a number that the sound run of the same seed passes
    assert any(c["value"] > c["limit"] >= sound["checks"][k]["value"] for k, c in result["checks"].items()), (sound["checks"], result["checks"])


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(workload):
    bench = harness.load_benchmark(prepared=True)
    cell = harness.cell_spec(bench, workload)
    config = {**harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json"), **TINY[workload]}
    traffic = {**harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"), **TRAFFIC}
    limits = harness.load_json(harness.HERE / "limits" / f"{workload}.json")
    kind = "fp8" if config["compute_dtype"] == "bfloat16" else "tf32"
    import importlib

    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    ctx = harness.Context(workload, config, traffic, SEED, torch.device("cpu"), False)
    state = driver.setup(ctx)
    driver.window(state, ctx, 0.2)
    numbers = driver.control(state, ctx, kind)
    if kind == "tf32":  # the CPU has no TF32: its control reads as the reference itself
        pytest.skip("TF32 exists only on the card; the control of a float32 cell runs in test_bench_cuda.py")
    assert any(numbers[k] > limits[k] for k in numbers), numbers
