"""``benchmark.window_spans``: the spans of a cell's measured window, untraced, at tiny widths on
the CPU."""
import time

import pytest
import torch

from benchmark import window_spans
from benchmark.drivers import serve_closed_loop
from benchmark.tests.test_bench_rehearsal import SEED, overrides


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_serving_windows_spans_and_counters(few_threads):
    window = serve_closed_loop.window
    result = window_spans.run("vtt-serve-b8", SEED, 0.2, "cpu", time.perf_counter(), overrides=overrides("vtt-serve-b8"))
    assert serve_closed_loop.window is window  # put back
    n = result["attempted"]
    spans = result["window_spans"]
    assert {k: v["n"] for k, v in spans.items()} == {"serve.request": n, "serve.h2d": n, "serve.forward": n, "serve.readback": n}
    assert all(v["mean_ms"] > 0 for v in spans.values())
    assert "serve_p95_ms" in result["metrics"] and result["correct"]
    # off the card every request is eager
    assert result["server"] == {"requests": n, "eager_requests": n, "graph_captures": 0, "graph_replays": 0, "capture_failures": 0}


def test_a_cell_without_a_server_has_no_counters(few_threads):
    result = window_spans.run("vtt-ppo-train", SEED, 0.2, "cpu", time.perf_counter(), overrides=overrides("vtt-ppo-train"))
    assert "server" not in result and result["window_spans"]["ppo.update"]["n"] == result["attempted"]
