"""The arithmetic of the benchmark's metrics on hand-made numbers and hand counts."""
import pytest

from benchmark import counting, stats
from benchmark.devtrace import DeviceOp, HostOp, Trace, idle_gaps, union_length


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_rate_and_idle_share():
    assert stats.rate(81920, 9.0) == pytest.approx(9102.222, rel=1e-6)
    assert stats.idle_share(0.75, 1.0) == pytest.approx(0.25)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_counts_overlaps_once():
    assert union_length([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert union_length([(0, 4), (1, 2)]) == pytest.approx(4.0)
    assert union_length([]) == 0.0
    assert idle_gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4), (5, 6)]


def _trace():
    host = [HostOp("m3l::flash_attention_qkv", 0.0, 1.0, 1, 1, [[512, 192, 768], [], [], []], ["c10::BFloat16"]),
            HostOp("aten::zeros", 0.1, 0.2, 2, 1), HostOp("aten::mm", 2.0, 3.0, 3, 1)]
    dev = [DeviceOp("fwd_kernel", 0.5, 1.5, 1), DeviceOp("memset", 0.3, 0.4, 2), DeviceOp("gemm", 2.5, 3.5, 3),
           DeviceOp("Memcpy HtoD (Pageable -> Device)", 4.0, 4.5, 0)]
    return Trace(dev, host, window_s=5.0)


def test_trace_attributes_device_time_to_the_operator_and_its_children():
    tr = _trace()
    (op, devs), = tr.under(("m3l::flash_attention_qkv",))
    assert op.name == "m3l::flash_attention_qkv"
    assert sorted(d.name for d in devs) == ["fwd_kernel", "memset"]
    assert tr.busy_s() == pytest.approx(1.0 + 0.1 + 1.0 + 0.5)
    assert tr.top_device_ops(2)[0][0] in ("fwd_kernel", "gemm")
    gaps = dict(tr.top_idle_gaps())
    assert sum(gaps.values()) == pytest.approx(4.5 - 2.6)


def test_attention_roofline_hand_counts():
    # (512, 192, 4 heads x 64) bf16 forward: bytes bound = 512*192*(3*256 + 256)*2 / 3.35e12
    nbytes = 512 * 192 * (3 * 256 + 256) * 2
    assert counting.attention_fwd_bytes(512, 192, 256, 2, False) == nbytes
    assert counting.attention_fwd_flops(512, 192, 192, 256) == 4 * 512 * 192 * 192 * 256
    assert 1e3 * counting.attention_roofline_s(512, 192, 256, 2, None, False) == pytest.approx(0.0601, abs=5e-5)
    bwd_flops = 2.5 * 4 * 512 * 192 * 192 * 256
    bwd_bytes = 512 * 192 * (3 * 256 + 256 + 3 * 256) * 2
    assert counting.attention_roofline_s(512, 192, 256, 2, None, True) == pytest.approx(max(bwd_flops / 989e12, bwd_bytes / 3.35e12))
    # a key mask keeping 50 of 197 keys: the operations over kept keys only, plus the f32 bias read
    assert counting.attention_roofline_s(64, 197, 384, 4, 50.0, False) == pytest.approx(
        max(4 * 64 * 197 * 50 * 384 / 989e12, 64 * 197 * (4 * 384 * 4 + 4) / 3.35e12))


def test_model_flops_hand_counts():
    assert counting.linear_flops(10, 3, 4) == 240
    assert counting.conv_flops(64, 12, 32, 4) == 2 * 64 * 12 * 32 * 16
    # one block over 192 tokens, width 256, inner 256, mlp 512
    t, d, m = 192, 256, 512
    expected = 2 * t * d * 3 * d + 4 * t * t * d + 2 * t * d * d + 2 * t * d * m * 2
    assert counting.block_flops(t, d, d, m) == expected
