"""The readers of the renderer's own spans and counters
(``stats["trace"]``, ``cudabrot_tpu_torch/utils/trace.py``): their
arithmetic on a synthetic snapshot, nothing without one, and a traced run
of the harness on the CPU, where the spans have no device events."""

import types

import pytest
from conftest import tiny_cell

import run
from hb import cells

SPAN_METRICS = ("pass.issue_ms", "sync.idle_share", "classify.span_ms",
                "compact.span_ms", "counters.span_ms", "deposit.span_ms")


def snapshot():
    """1000 passes in a 10 s window: 4 ms of host time a pass enqueued,
    device ms a pass 6 (classify), 2.5 (compact), 0.4 (counters), 3
    (deposit), and 124 sync bubbles of 0.5 ms."""
    def span(host_ms, device_ms=None):
        s = {"count": 1000, "host_ms": host_ms, "self_host_ms": host_ms / 2}
        if device_ms is not None:
            s.update(device_ms=device_ms, device_ms_p50=device_ms / 1000,
                     device_ms_p90=device_ms / 900)
        return s

    return {"spans": {"cb.pass": span(4000.0, 9000.0),
                      "cb.classify": span(900.0, 6000.0),
                      "cb.compact": span(1500.0, 2500.0),
                      "cb.counters": span(700.0, 400.0),
                      "cb.deposit": span(300.0, 3000.0),
                      "cb.sync": {"count": 125, "host_ms": 600.0,
                                  "self_host_ms": 600.0}},
            "sync_bubble_ms": 62.0, "sync_bubbles": 124,
            "buffers": {"hist": 1 << 40, "memory_reserved": 1 << 30}}


def measurement(stats):
    return types.SimpleNamespace(elapsed_s=10.0, passes=1000,
                                 hist_sum=10 ** 9, setup_s=5.0, stats=stats,
                                 trace=None, replicas=1, costs={},
                                 geometry={})


def test_span_readers_on_a_synthetic_snapshot():
    m = measurement({"in_band": 1, "trace": snapshot()})
    read = {name: cells.reader(name)(m) for name in SPAN_METRICS}
    assert read == {
        "pass.issue_ms": pytest.approx(4.0),
        "sync.idle_share": pytest.approx(0.0062),
        "classify.span_ms": pytest.approx(6.0),
        "compact.span_ms": pytest.approx(2.5),
        "counters.span_ms": pytest.approx(0.4),
        "deposit.span_ms": pytest.approx(3.0),
    }


def test_span_readers_find_nothing_without_the_record():
    # The parent program, and any untraced run: no "trace" in the stats.
    m = measurement({"in_band": 1})
    for name in SPAN_METRICS:
        assert cells.reader(name)(m) is None, name
    # Traced on the CPU: spans without device events, no bubble timed.
    t = snapshot()
    for s in t["spans"].values():
        for k in ("device_ms", "device_ms_p50", "device_ms_p90"):
            s.pop(k, None)
    t["sync_bubbles"], t["sync_bubble_ms"] = 0, 0.0
    m = measurement({"in_band": 1, "trace": t})
    assert cells.reader("pass.issue_ms")(m) == pytest.approx(4.0)
    for name in SPAN_METRICS[1:]:
        assert cells.reader(name)(m) is None, name


def test_traced_run_on_the_cpu_reports_the_host_span():
    out = run.run_cell(tiny_cell(), 2 ** 31 + 77, 0.5, True, device="cpu",
                       log=lambda msg: None)
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    assert metrics["pass.issue_ms"]["value"] > 0
    assert metrics["pass.issue_ms"]["unit"] == "ms"
    for name in SPAN_METRICS[1:]:
        assert name not in metrics


def test_span_readers_read_a_card_over_several_replicas():
    """Four replicas: every device span is summed over the cards, and
    ``cb.replica`` counts one span a card and pass."""
    t = snapshot()
    for s in t["spans"].values():
        for k in ("device_ms", "host_ms"):
            if k in s:
                s[k] *= 4
    t["spans"]["cb.replica"] = {"count": 4000, "host_ms": 11000.0,
                                "self_host_ms": 9000.0,
                                "device_ms": 20000.0}
    m = measurement({"in_band": 1, "trace": t})
    m.replicas = 4
    assert cells.reader("classify.span_ms")(m) == pytest.approx(6.0)
    assert cells.reader("deposit.span_ms")(m) == pytest.approx(3.0)
    assert cells.reader("replica.issue_ms")(m) == pytest.approx(11.0)
    one = measurement({"in_band": 1, "trace": snapshot()})
    assert cells.reader("replica.issue_ms")(one) is None
