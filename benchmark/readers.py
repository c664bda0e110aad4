"""Arithmetic shared by the per-layer readers in ``metrics/``. A reader returns None where the
traced window holds nothing it reads, never 0 for a share."""
from __future__ import annotations

from . import stats
from .counting import DTYPE_BYTES, PEAK_FLOPS, attention_roofline_s

ATTENTION_OPS = ("m3l::flash_attention_qkv", "m3l::flash_attention_qkv_bwd")


def device_ops_per(readings, count_key: str) -> float | None:
    """Device operations (kernels, copies, fills) of the traced window per unit of work."""
    n = readings.counts.get(count_key)
    if not n or not readings.trace.device_ops:
        return None
    return len(readings.trace.device_ops) / n


def idle_share(readings) -> float | None:
    """% of the traced window in which no device operation ran."""
    tr = readings.trace
    if not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * stats.idle_share(tr.busy_s(), tr.window_s)


def attention_roofline(readings) -> float | None:
    """% : the roofline time of every call of the packed attention operators over the device time
    spent under them, in the detailed trace. A call with a key mask counts the kept keys ``counts["kept_keys"]`` gives
    for its (rows, length); without that count for it, no reading."""
    kept = readings.counts.get("kept_keys", {})
    bound = spent = 0.0
    for op, devs in readings.detail.under(ATTENTION_OPS):
        if not devs:
            continue
        rows, n, width = op.shapes[0]
        masked = len(op.shapes[1]) == 2
        keys = kept.get((rows, n)) if masked else None
        if masked and keys is None:
            return None
        bound += attention_roofline_s(rows, n, width // 3, DTYPE_BYTES[op.dtypes[0]], keys, op.name.endswith("_bwd"))
        spent += sum(d.end - d.start for d in devs)
    return 100.0 * bound / spent if spent > 0 else None


def model_flops_utilization(readings) -> float | None:
    """% of the card's dense peak that the window's model operations would take at its length."""
    flops, window = readings.counts.get("model_flops"), readings.counts.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / (window * PEAK_FLOPS)


def h2d_ms_per(readings, count_key: str) -> float | None:
    """Device ms of host-to-device copies per unit of work."""
    n = readings.counts.get(count_key)
    copies = [d for d in readings.trace.device_ops if d.name.startswith("Memcpy HtoD")]
    if not n or not copies:
        return None
    return 1e3 * sum(d.end - d.start for d in copies) / n


def span_ms(readings, name: str) -> float | None:
    """Mean host ms of the benchmark's span ``name`` over the window."""
    xs = readings.spans.get(name)
    return 1e3 * sum(xs) / len(xs) if xs else None
