"""A rehearsal of every cell off the card: the harness's run (``harness.run_cell``) at tiny widths
on the CPU, where the port's operators run their plain versions. It checks that each cell's
driver, readers and check run end to end; that the plain reference follows the program (a
float32 program agrees with it to rounding); that each fault a cell can have, planted in the
timed path, turns ``correct`` false under the cell's limits, on a number that the sound run of the
same seed passes; and that the control (the reference
in the next precision below) fails them too. The command itself refuses to run without a card.

Each cell's rehearsal is found by the cell's name, as its limits are: ``rehearsal/<workload>.json``
holds its tiny ``config`` overrides, the ``traffic`` overrides its driver reads, the ``faults``
planted in it, the ``tolerance`` of each number whose rounding in the float32 rehearsal exceeds
``DEFAULT_TOLERANCE``, and for a float32 cell the sizes of its TF32 control on the card
(``card_control``). So a cell is added as files alone (README)."""
import importlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

SEED = 2**31 + 12345  # past 32 signed bits, as the driver's seeds are
DEFAULT_TOLERANCE = 1e-5  # a float32 program's gap to the reference, as a share of the reference
REHEARSAL_KEYS = {"config", "traffic", "faults", "tolerance"}
DRIVER_FUNCTIONS = ("setup", "window", "traced", "check", "control")
CELLS = sorted(w["name"] for w in harness.load_benchmark(prepared=True)["workloads"])
HERE, ROOT = harness.HERE, harness.ROOT  # the checkout's, where a test points the harness at a copy


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rehearsal(workload: str) -> dict:
    """The cell's ``rehearsal/<workload>.json``."""
    return harness.load_json(harness.HERE / "rehearsal" / f"{workload}.json")


def overrides(workload: str, **config) -> dict:
    """The cell shrunk to its rehearsal's sizes, with ``config`` on top."""
    r = rehearsal(workload)
    return {"config": {**r["config"], **config}, "traffic": r["traffic"]}


def run(workload, trace=False, fault=None, **config):
    return harness.run_cell(workload, SEED, 0.2, trace, "cpu", time.perf_counter(), bench=harness.load_benchmark(prepared=True),
                            overrides=overrides(workload, **config), fault=fault)


def problems(workload: str) -> list[str]:
    """What the cell lacks of the files and entries that the harness and these tests find by name."""
    here = harness.HERE
    cell = harness.cell_spec(harness.load_benchmark(prepared=True), workload)
    files = {"config": here / "configs" / f"{cell['config']}.json", "traffic": here / "traffic" / f"{cell['traffic']}.json",
             "limits": here / "limits" / f"{workload}.json", "rehearsal": here / "rehearsal" / f"{workload}.json"}
    out = [f"no {path}" for path in files.values() if not path.is_file()]
    if out:
        return out
    config, traffic, limits, r = (harness.load_json(path) for path in files.values())
    if not (here / "drivers" / f"{traffic['driver']}.py").is_file():
        return [f"no driver {traffic['driver']}"]
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    out += [f"driver {traffic['driver']} has no {f}" for f in DRIVER_FUNCTIONS if not callable(getattr(driver, f, None))]
    out += [f"no reader of {m['name']}" for m in cell["per_layer"] if not (here / "metrics" / f"{m['name']}.py").is_file()]
    e2e = [m["name"] for m in cell["end_to_end"] if m["name"] != "setup_s"]
    if len(e2e) != 1:
        out.append(f"end-to-end metrics besides setup_s: {e2e}, not one")
    want = REHEARSAL_KEYS | ({"card_control"} if config["compute_dtype"] == "float32" else set())
    if set(r) != want:
        out.append(f"rehearsal keys {sorted(r)}, not {sorted(want)}")
    for key, base in (("config", config), ("traffic", traffic)):  # an override of a key the cell lacks is read by nothing
        out += [f"rehearsal {key} key {k}, which {files[key].name} lacks" for k in r.get(key, {}) if k not in base]
    out += [f"tolerance of {k}, which is not compared" for k in r.get("tolerance", {}) if k not in limits]
    return out


def test_cells_are_the_benchmarks():  # and the prepared cells: no limits or rehearsal file for another name
    assert sorted(p.name for folder in ("limits", "rehearsal") for p in (HERE / folder).iterdir() if p.stem not in CELLS) == []


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_complete(workload):
    assert problems(workload) == []


def test_prepared_cells_are_not_run_by_the_command():
    prepared = sorted(p.stem for p in (harness.HERE / "prepared").glob("*.json"))
    assert prepared
    for workload in prepared:
        assert harness.load_json(harness.HERE / "prepared" / f"{workload}.json")["workload"]["name"] == workload
        assert workload not in [w["name"] for w in harness.load_benchmark()["workloads"]]
        with pytest.raises(SystemExit):
            harness.cell_spec(harness.load_benchmark(), workload)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_end_to_end(workload):
    result, lines = run(workload, trace=True)
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert [ln for ln in lines if ln.startswith("check ")] == lines[-len(result["checks"]):]
    assert len(result["checks"]) >= 1
    # the check returns a number for each limit of the cell, and no other
    assert sorted(result["checks"]) == sorted(harness.load_json(harness.HERE / "limits" / f"{workload}.json"))
    for m in result["metrics"].values():  # off the card the readers of device time find nothing
        assert m["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_float32_program_follows_the_reference(workload):
    result, _ = run(workload, compute_dtype="float32")  # the ViT cells already compute in float32
    # serving's gaps are in units of the bfloat16 gauge's; the rest are shares of the reference
    for name, c in result["checks"].items():
        assert c["value"] < rehearsal(workload)["tolerance"].get(name, DEFAULT_TOLERANCE), (name, c)


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS for f in rehearsal(w)["faults"]])
def test_planted_fault_is_not_correct(workload, fault):
    sound, _ = run(workload)
    result, _ = run(workload, fault=fault)
    assert result["correct"] is False, result["checks"]
    # the fault fails a number that the sound run of the same seed passes
    assert any(c["value"] > c["limit"] >= sound["checks"][k]["value"] for k, c in result["checks"].items()), (sound["checks"], result["checks"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    bench = harness.load_benchmark(prepared=True)
    cell = harness.cell_spec(bench, workload)
    over = overrides(workload)
    config = {**harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json"), **over["config"]}
    traffic = {**harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"), **over["traffic"]}
    limits = harness.load_json(harness.HERE / "limits" / f"{workload}.json")
    kind = "fp8" if config["compute_dtype"] == "bfloat16" else "tf32"

    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    ctx = harness.Context(workload, config, traffic, SEED, torch.device("cpu"), False)
    state = driver.setup(ctx)
    driver.window(state, ctx, 0.2)
    numbers = driver.control(state, ctx, kind)
    if kind == "tf32":  # the CPU has no TF32: its control reads as the reference itself
        pytest.skip("TF32 exists only on the card; the control of a float32 cell runs in test_bench_cuda.py")
    assert any(numbers[k] > limits[k] for k in numbers), numbers


SOURCE, TWIN = "vits-dino-pretrain", "vits-dino-pretrain-twin"


def add_twin(root: Path, monkeypatch, source: str = SOURCE, files=("limits", "rehearsal")) -> str:
    """A copy of the benchmark under ``root`` with a twin of ``source`` added as a cell is added:
    its ``files`` copied from the source's, its ``workloads`` entry, and its name in the
    ``workloads`` lists of the metrics the source reports. Points the harness at the copy and
    returns the twin's name."""
    twin = f"{source}-twin"
    here = root / HERE.name
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for folder in files:
        shutil.copyfile(here / folder / f"{source}.json", here / folder / f"{twin}.json")
    entry = next(w for w in bench["workloads"] if w["name"] == source)
    bench["workloads"].append({**entry, "name": twin})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if source in m.get("workloads", []):
            m["workloads"].append(twin)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2) + "\n")
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "HERE", here)
    return twin


def test_a_cell_is_added_as_files_alone(tmp_path, monkeypatch):
    """A twin of ``vits-dino-pretrain`` added to a copy of the benchmark as new files (its limits
    and rehearsal) and entries; no other file changes. It is complete, its rehearsal runs, follows
    the reference to the rehearsal's tolerance and reads, number for number, as its source's on the
    same seed."""
    source = harness.cell_spec(harness.load_benchmark(), SOURCE)
    assert add_twin(tmp_path, monkeypatch) == TWIN

    # every file of the benchmark is as it was; the twin's two files are the only new ones
    def files(root):
        return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}

    before, after = files(HERE), files(harness.HERE)
    assert {p: b for p, b in after.items() if p in before} == before
    assert sorted(map(str, set(after) - set(before))) == [f"limits/{TWIN}.json", f"rehearsal/{TWIN}.json"]

    assert problems(TWIN) == []
    twin = harness.cell_spec(harness.load_benchmark(), TWIN)
    for key in ("end_to_end", "per_layer"):
        assert [m["name"] for m in twin[key]] == [m["name"] for m in source[key]]

    result, _ = run(TWIN, trace=True)
    want, _ = run(SOURCE, trace=True)
    assert sorted(result["checks"]) == sorted(harness.load_json(harness.HERE / "limits" / f"{TWIN}.json"))
    # the card's limits at the rehearsal's tiny sizes: the twin is correct exactly where its source is
    assert (result["correct"], result["checks"]) == (want["correct"], want["checks"])
    assert sorted(result["metrics"]) == sorted(want["metrics"]) and {"loader_ms.pretrain", "mfu.pretrain"} <= set(result["metrics"])
    tolerance = rehearsal(TWIN)["tolerance"]
    assert all(c["value"] < tolerance.get(k, DEFAULT_TOLERANCE) for k, c in result["checks"].items()), result["checks"]
    result, _ = run(TWIN)
    assert sorted(result["metrics"]) == ["pretrain_images_per_s", "setup_s"]


def test_an_added_cell_is_correct(tmp_path, monkeypatch):
    """A twin of ``vtt-serve-b8``, whose tiny rehearsal passes the card's limits, added as files
    alone, is complete and comes out ``correct``."""
    twin = add_twin(tmp_path, monkeypatch, "vtt-serve-b8")
    assert problems(twin) == []
    result, _ = run(twin)
    assert result["correct"] is True, result["checks"]
    assert sorted(result["checks"]) == sorted(harness.load_json(harness.HERE / "limits" / f"{twin}.json"))


def test_an_incomplete_cell_is_found(tmp_path, monkeypatch):
    add_twin(tmp_path, monkeypatch, files=("limits",))
    here = harness.HERE
    assert problems(TWIN) == [f"no {here / 'rehearsal' / f'{TWIN}.json'}"]
    shutil.copyfile(here / "rehearsal" / f"{SOURCE}.json", here / "rehearsal" / f"{TWIN}.json")
    (here / "metrics" / "mfu.pretrain.py").unlink()
    bench = harness.load_json(tmp_path / "BENCHMARK.json")
    next(m for m in bench["end_to_end"] if m["name"] == "serve_p95_ms")["workloads"].append(TWIN)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert problems(TWIN) == ["no reader of mfu.pretrain", "end-to-end metrics besides setup_s: "
                              "['serve_p95_ms', 'pretrain_images_per_s'], not one"]
    r = harness.load_json(here / "rehearsal" / f"{TWIN}.json")
    (here / "rehearsal" / f"{TWIN}.json").write_text(json.dumps({**r, "traffic": {**r["traffic"], "pool": 6}}))
    assert problems(TWIN)[-1] == "rehearsal traffic key pool, which ssl-digit-b64.json lacks"
