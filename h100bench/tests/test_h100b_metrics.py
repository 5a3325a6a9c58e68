"""The reduction of a trace and the readers' arithmetic, on a synthetic
profile and synthetic counters."""

import json
import types

import pytest
from conftest import BENCH_DIR

from hb import cells
from hb import trace as tr

LAYERS = tr.load_layers()
MS = 1_000_000  # ns


def test_union_of_intervals():
    assert tr.union_ns([]) == 0
    assert tr.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert tr.union_ns([(30, 40), (0, 10), (10, 12)]) == 22
    assert tr.union_ns([(0, 100), (10, 20)]) == 100


def test_layer_table_order_and_default():
    assert tr.layer_of("void classify_kernel<2>(cb::ClassifyArgs)",
                       LAYERS) == "classify"
    assert tr.layer_of("replay_deposit_ext_kernel", LAYERS) == "deposit"
    assert tr.layer_of("cb_threefry_bits_kernel", LAYERS) == "compaction"
    assert tr.layer_of("void at::native::radixSortKVInPlace<...>",
                       LAYERS) == "compaction"
    assert tr.layer_of("Memset (Device)", LAYERS) == "compaction"


def test_short_name_drops_template_and_parameters():
    assert tr.short_name(
        "void classify_kernel<2, true>(cb::ClassifyArgs)") == "classify_kernel"
    assert tr.short_name("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)".split("(")[0].strip()


def synthetic():
    """A 10 ms window from t=100 ms on card 0: classify 0-4 ms, a sort 4-5
    ms, two replays on two streams 3-6 and 5-8 ms, an idle gap 8-10 ms
    while the host synchronizes, and activity outside the window."""
    w0 = 100 * MS
    device = [
        ("void classify_kernel<2>(cb::ClassifyArgs)", w0, w0 + 4 * MS),
        ("void at::native::radixSortKV<int>(long)", w0 + 4 * MS,
         w0 + 5 * MS),
        ("void replay_deposit_kernel<0>(int)", w0 + 3 * MS, w0 + 6 * MS),
        ("void replay_deposit_kernel<0>(int)", w0 + 5 * MS, w0 + 8 * MS),
        ("Memset (Device)", w0 - 5 * MS, w0 - 1 * MS),
        ("void classify_kernel<2>(cb::ClassifyArgs)", w0 + 9 * MS,
         w0 + 12 * MS),
    ]
    device = [ev + (0,) for ev in device]
    host = [(tr.WINDOW_MARK, w0, w0),
            ("aten::sort", w0 + 4 * MS, w0 + 4 * MS + 10),
            ("cudaDeviceSynchronize", w0 + 7 * MS, w0 + 9 * MS + 500_000)]
    return device, host, w0


def test_reduce_clips_to_the_window_and_unions_each_layer():
    device, host, w0 = synthetic()
    r = tr.reduce_events(device, host, w0, 10 * MS, LAYERS)
    assert r.window_s == pytest.approx(0.010)
    # busy: 0-8 ms and 9-10 ms
    assert r.busy_s == pytest.approx(0.009)
    assert r.layer_s["classify"] == pytest.approx(0.005)
    assert r.layer_s["deposit"] == pytest.approx(0.005)
    assert r.layer_s["compaction"] == pytest.approx(0.001)
    assert r.op_s["replay_deposit_kernel"] == pytest.approx(0.006)
    assert r.idle_by_host == {"cudaDeviceSynchronize": pytest.approx(0.001)}
    b = r.breakdown()
    assert b["device_ops"][0][0] == "replay_deposit_kernel"
    assert b["idle_gaps"] == [["cudaDeviceSynchronize", pytest.approx(0.001)]]


def test_idle_gap_without_a_host_range_is_python():
    r = tr.reduce_events([("classify_kernel", 0, 5 * MS, 0)], [], 0,
                         10 * MS, LAYERS)
    assert r.idle_by_host == {"python": pytest.approx(0.005)}


def measurement(trace):
    stats = {"classify_iters": 10 ** 12, "samples": 2 * 10 ** 11,
             "orbit_points": 5 * 10 ** 11, "on_canvas_points": 4 * 10 ** 11,
             "emitted": 10 ** 9, "in_band": 10 ** 9, "replay_dropped": 0}
    return types.SimpleNamespace(
        elapsed_s=trace.window_s, passes=1000, hist_sum=4 * 10 ** 11,
        setup_s=5.0, stats=stats, trace=trace, replicas=1,
        costs=json.loads((BENCH_DIR / "costs.json").read_text()),
        geometry={"lanes": 262144, "pixels": 10 ** 6,
                  "emission_slots": 8 * 10 ** 6})


def test_readers_on_a_synthetic_window():
    t = tr.Reduced(window_s=10.0, busy_s=9.5,
                   layer_s={"classify": 6.0, "deposit": 2.0,
                            "compaction": 3.0},
                   op_s={}, idle_by_host={})
    m = measurement(t)
    c = m.costs
    read = {name: cells.reader(name)(m) for name in (
        "points_per_s", "setup_s", "device.idle_share", "engine.pass_ms",
        "compact.ms_per_pass", "classify_roofline",
        "replay_deposit_roofline")}
    assert read["points_per_s"] == pytest.approx(4e10)
    assert read["setup_s"] == 5.0
    assert read["device.idle_share"] == pytest.approx(0.05)
    assert read["engine.pass_ms"] == pytest.approx(10.0)
    assert read["compact.ms_per_pass"] == pytest.approx(3.0)
    ops = 10 ** 12 * c["escape_step"]["ops"] + 2e11 * c["sample_draw"]["ops"]
    assert read["classify_roofline"] == pytest.approx(
        100 * ops / 67e12 / 6.0)
    # On-canvas points exceed a canvas a pass: the bins are capped.
    nbytes = 1e9 * 12 + 1000 * 10 ** 6 * 8
    least = max(5e11 * c["replay_point"]["ops"] / 67e12, nbytes / 3.35e12)
    assert read["replay_deposit_roofline"] == pytest.approx(
        100 * least / 2.0)


def test_readers_find_nothing_without_a_trace_or_a_layer():
    t = tr.Reduced(window_s=10.0, busy_s=0.0, layer_s={}, op_s={},
                   idle_by_host={})
    m = measurement(t)
    for name in ("device.idle_share", "compact.ms_per_pass",
                 "classify_roofline", "replay_deposit_roofline"):
        assert cells.reader(name)(m) is None
    m.trace = None
    assert cells.reader("engine.pass_ms")(m) is None


def test_two_cards_reduce_each_on_its_own_timeline():
    """Card 0 runs the one-card window above; card 1 runs classify 2-6 ms
    only. A layer's seconds add over the cards, the busy time is their
    mean, and each card's idle gaps count half."""
    device, host, w0 = synthetic()
    device = device + [("void classify_kernel<2>(cb::ClassifyArgs)",
                        w0 + 2 * MS, w0 + 6 * MS, 1)]
    one = tr.reduce_events(device[:-1], host, w0, 10 * MS, LAYERS)
    two = tr.reduce_events(device, host, w0, 10 * MS, LAYERS, cards=2)
    assert two.busy_s == pytest.approx((0.009 + 0.004) / 2)
    assert two.layer_s["classify"] == pytest.approx(0.005 + 0.004)
    assert two.layer_s["deposit"] == one.layer_s["deposit"]
    assert sum(two.idle_by_host.values()) == pytest.approx(
        two.window_s - two.busy_s)
    m = measurement(two)
    m.replicas = 2
    assert cells.reader("device.idle_share")(m) == pytest.approx(
        1 - 0.0065 / 0.010)
    assert cells.reader("compact.ms_per_pass")(m) == pytest.approx(
        1e3 * 0.001 / 2000)


def test_a_card_with_no_operation_counts_as_idle():
    r = tr.reduce_events([("classify_kernel", 0, 5 * MS, 0)], [], 0,
                         10 * MS, LAYERS, cards=4)
    assert r.busy_s == pytest.approx(0.005 / 4)
    assert r.idle_by_host == {"python": pytest.approx(0.010 - 0.005 / 4)}


def test_rooflines_of_four_replicas_read_as_one_card():
    """Four cards each doing one card's work in one card's time: the four
    cards' counters and card-seconds give the one card's shares."""
    t1 = tr.Reduced(window_s=10.0, busy_s=9.5,
                    layer_s={"classify": 6.0, "deposit": 2.0,
                             "compaction": 3.0},
                    op_s={}, idle_by_host={})
    t4 = tr.Reduced(window_s=10.0, busy_s=9.5,
                    layer_s={k: 4 * v for k, v in t1.layer_s.items()},
                    op_s={}, idle_by_host={})
    m1, m4 = measurement(t1), measurement(t4)
    m4.replicas = 4
    m4.stats = {k: 4 * v for k, v in m1.stats.items()}
    m4.stats["on_canvas_points"] = 4 * 10 ** 8  # under a canvas a pass
    m1.stats["on_canvas_points"] = 10 ** 8
    for name in ("classify_roofline", "replay_deposit_roofline",
                 "compact.ms_per_pass", "device.idle_share"):
        assert cells.reader(name)(m4) == pytest.approx(
            cells.reader(name)(m1)), name
