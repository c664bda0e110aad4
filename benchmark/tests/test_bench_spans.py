"""``benchmark/spans.py``: the arithmetic of the program's spans against a hand-made device
timeline, and each cell run off the card at tiny widths with its traced windows recording the
program's spans."""
import threading
import time

import pytest
import torch

from benchmark import devtrace, spans
from benchmark.tests.test_bench_rehearsal import SEED, overrides, rehearsal
from m3l_tpu_torch.utils.trace import Span

MAIN = threading.main_thread().ident
S = 1_000_000_000  # ns a second


def timeline(ops, program, window=(0.0, 10.0)):
    """A trace of device operations [(name, start s, end s)] and program spans [(name, start s,
    end s, parent, thread)] in a window of seconds."""
    tr = devtrace.Trace([devtrace.DeviceOp(n, a, b, 0) for n, a, b in ops], [], window[1] - window[0])
    tr.program_spans = [Span(n, int(a * S), int(b * S), p, None, t) for n, a, b, p, t in program]
    tr.window_ns = (int(window[0] * S), int(window[1] * S))
    tr.runtime_calls = []
    return tr


# parent 1-6 s with its child 2-3 s; busy 0-1, 2.5-4, 5-5.5, 9-10; gaps 1-2.5 (middle 1.75: the
# parent), 4-5 (4.5: the parent), 5.5-9 (7.25: outside)
OPS = [("k", 0.0, 1.0), ("k", 2.5, 4.0), ("Memcpy DtoH (Device -> Pageable)", 5.0, 5.5), ("k", 9.0, 10.0)]
PROGRAM = [("parent", 1.0, 6.0, -1, MAIN), ("child", 2.0, 3.0, 0, MAIN), ("other thread", 0.0, 10.0, -1, MAIN + 1)]


def test_idle_is_grouped_by_the_innermost_span_at_each_gaps_middle():
    # a gap inside the child (2.2-2.8), one inside the parent alone (4-5), one outside both (5.5-9)
    tr = timeline([("k", 0.0, 2.2), ("k", 2.8, 4.0), ("k", 5.0, 5.5), ("k", 9.0, 10.0)], PROGRAM)
    assert dict(spans.idle_by_span(tr)[0]) == pytest.approx({"child": 0.6, "parent": 1.0, "outside": 3.5})
    tr = timeline(OPS, PROGRAM)
    groups, idle = spans.idle_by_span(tr)
    assert dict(groups) == pytest.approx({"parent": 1.5 + 1.0, "outside": 3.5}) and idle == pytest.approx(6.0)
    assert idle == pytest.approx(tr.window_s - tr.busy_s())


def test_without_device_operations_there_is_no_grouping():
    assert spans.idle_by_span(timeline([], PROGRAM)) == ([], 0.0)
    assert spans.idle_share_inside(timeline([], PROGRAM), "parent") is None


def test_idle_share_inside_a_span_and_mean_span_ms():
    tr = timeline(OPS, PROGRAM)
    # idle while inside parent (1-6): 1-2.5, 4-5 and 5.5-6
    assert spans.idle_share_inside(tr, "parent") == pytest.approx(100.0 * 3.0 / 10.0)
    assert spans.idle_share_inside(tr, "child") == pytest.approx(100.0 * 0.5 / 10.0)
    assert spans.idle_share_inside(tr, "other thread") is None  # the main thread's spans only
    assert spans.span_ms(tr, "child") == pytest.approx(1000.0) and spans.span_ms(tr, "missing") is None


def test_copies_back_are_held_to_the_readback_spans():
    tr = timeline(OPS, PROGRAM + [("serve.readback", 5.2, 5.6, -1, MAIN)])
    assert spans.dtoh_outside(tr) == (0.0, 1)
    tr = timeline(OPS, PROGRAM + [("serve.readback", 5.0, 5.49, -1, MAIN)])
    worst, n = spans.dtoh_outside(tr)
    assert worst == pytest.approx(1e4) and n == 1
    assert spans.dtoh_outside(timeline(OPS[:1], PROGRAM)) is None


def test_long_runtime_calls_are_grouped_by_span():
    tr = timeline(OPS, PROGRAM)
    tr.runtime_calls = [("cudaLaunchKernel", 2.1, 2.100004), ("cudaMemcpyAsync", 2.2, 2.7), ("cudaMemcpyAsync", 4.0, 4.5),
                        ("cudaStreamSynchronize", 6.5, 7.0)]
    assert spans.host_waits(tr) == [["child", "cudaMemcpyAsync", pytest.approx(0.5), 1], ["parent", "cudaMemcpyAsync", pytest.approx(0.5), 1],
                                    ["outside", "cudaStreamSynchronize", pytest.approx(0.5), 1]]


def test_summary_names_the_metrics_the_window_holds():
    tr = timeline(OPS, PROGRAM + [("data.batch", 1.0, 2.0, 0, MAIN), ("trainer.step", 2.0, 4.0, 0, MAIN)])
    out = spans.summary(tr)
    assert set(out["metrics"]) == {"loader_span_ms.pretrain", "step_host_ms.pretrain", "loader_idle_share.pretrain"}
    assert out["mean_ms"]["trainer.step"] == [pytest.approx(2000.0), 1]


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


WANT = {"vtt-ppo-train": {"update_host_ms.update"}, "vtt-serve-b8": {"dispatch_ms.serve", "readback_ms.serve"},
        "vits-dino-pretrain": {"loader_span_ms.pretrain", "step_host_ms.pretrain"}}


@pytest.mark.parametrize("workload", sorted(WANT))
def test_cell_records_the_programs_spans(workload, few_threads):
    # three traced updates: the first's span opens before the window, the last's closes after it
    tiny = rehearsal(workload)
    over = {"config": tiny["config"], "traffic": {**tiny["traffic"], "trace_updates": 3}}
    result = spans.run(workload, SEED, 0.2, False, "cpu", time.perf_counter(), overrides=over)
    got = result["program_spans"]
    assert set(got["metrics"]) == WANT[workload]  # off the card no device time: no idle share
    assert all(v > 0 for v in got["metrics"].values()) and got["idle_spans"] == []
    assert devtrace.Recorder is not spans.SpanRecorder  # put back


def test_window_spans_run_reports_the_end_to_end_metric(few_threads):
    result = spans.run("vtt-serve-b8", SEED, 0.2, True, "cpu", time.perf_counter(), overrides=overrides("vtt-serve-b8"))
    assert "serve_p95_ms" in result["metrics"] and "program_spans" not in result and result["correct"]
