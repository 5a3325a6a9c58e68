"""The render's spans (``cudabrot_tpu_torch/utils/trace.py``) on the CPU:
off without a profiler, one span of each layer a pass under one, on the
profiler's clock, and never a change to what the render computes."""

import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudabrot_tpu_torch import driver, engines
from cudabrot_tpu_torch.config import (
    Canvas,
    EngineOptions,
    IterationBand,
    RenderConfig,
)
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.ops import launches
from cudabrot_tpu_torch.utils import trace

PASSES = 4
#: A pass's layers, one span each on a uniform single-device pass.
LAYERS = ("cb.pass", "cb.classify", "cb.compact", "cb.counters",
          "cb.deposit")
#: The stats of an untraced uniform render on the device replay.
UNTRACED_KEYS = {"classify_iters", "culled", "cycles_detected", "emitted",
                 "in_band", "on_canvas_points", "orbit_points", "replay",
                 "replay_dropped", "samples", "wasted_steps"}


def _cfg(passes=PASSES, **options):
    opts = dict(lane_rows=2, steps_per_pass=64, steps_per_flush=16,
                replay_capacity=4096, pipeline_depth=2)
    opts.update(options)
    return RenderConfig(
        canvas=Canvas(width=32, height=32),
        band=IterationBand(max_escape_iterations=50,
                           min_escape_iterations=5),
        seconds_to_run=-1.0, max_passes=passes,
        options=EngineOptions(**opts))


def _render(cfg, engine=None):
    return driver.run_render(cfg, engine=engine, log=lambda s: None,
                             device="cpu")


def _profiled(cfg, engine=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = _render(cfg, engine)
    return result, prof


def test_off_span_is_the_shared_noop_and_stats_are_untouched():
    assert not trace.profiler_recording()
    a = trace.span("cb.pass", device=torch.device("cpu"), pass_index=0)
    b = trace.span("cb.deposit")
    assert a is b is trace._NOOP
    result = _render(_cfg())
    assert set(result.stats) == UNTRACED_KEYS


def test_traced_render_records_each_layer_once_a_pass():
    result, prof = _profiled(_cfg())
    spans = result.stats["trace"]["spans"]
    for name in LAYERS:
        assert spans[name]["count"] == PASSES, name
    # Two groups of two passes, then the final synchronize.
    assert spans["cb.sync"]["count"] == PASSES // 2 + 1
    for s in spans.values():
        assert 0 <= s["self_host_ms"] <= s["host_ms"]
        assert "device_ms" not in s  # no device events on the CPU
    children = sum(spans[n]["host_ms"] for n in LAYERS[1:])
    assert children <= spans["cb.pass"]["host_ms"]
    assert spans["cb.pass"]["self_host_ms"] == pytest.approx(
        spans["cb.pass"]["host_ms"] - children)
    # The profiler saw every range, and the tracer's clock is its clock.
    names = {e.name for e in prof.events()}
    assert set(spans) <= names
    tr = trace.last()
    ranges = sorted(ev.start_ns() for ev in prof.profiler.kineto_results
                    .events() if ev.name() == "cb.pass")
    starts = sorted(r.start_ns + tr.profiler_offset_ns for r in tr.records
                    if r.name == "cb.pass")
    assert len(ranges) == len(starts) == PASSES
    for ours, theirs in zip(starts, ranges):
        assert abs(ours - theirs) < 1_000_000
    assert [r.pass_index for r in tr.records if r.name == "cb.classify"] \
        == list(range(PASSES))
    assert {r.parent for r in tr.records if r.name in LAYERS[1:]} == {
        "cb.pass"}
    buffers = result.stats["trace"]["buffers"]
    assert buffers["memory_reserved"] == 0
    assert {"hist", "lanes.cr", "lanes.it"} <= set(buffers)
    assert not trace.profiler_recording() and trace._tracer is None


@pytest.mark.parametrize("options, layers, once", [
    ({}, LAYERS, ()),
    ({"scatter": "bigtiles"}, LAYERS, ()),
    # MH deposits its emissions as they are: no compaction; the readback
    # deposits the chains' unfinished tenures once.
    ({"sampler": "mh", "lane_rows": 4, "steps_per_pass": 256,
      "steps_per_flush": 64, "mh_burnin_passes": 0},
     tuple(n for n in LAYERS if n != "cb.compact"), ("cb.mh_tail",)),
], ids=["fused", "bigtiles", "mh"])
def test_tracing_leaves_histogram_and_counters_bitwise(options, layers,
                                                       once):
    cfg = _cfg(**options)
    off = _render(cfg)
    on, _ = _profiled(cfg)
    np.testing.assert_array_equal(off.histogram, on.histogram)
    traced = dict(on.stats)
    spans = traced.pop("trace")["spans"]
    assert traced == off.stats
    assert set(spans) == {*layers, *once, "cb.sync"}
    for name in layers:
        assert spans[name]["count"] == PASSES, name
    for name in once:
        assert spans[name]["count"] == 1, name


_MH = {"sampler": "mh", "lane_rows": 4, "steps_per_pass": 256,
       "steps_per_flush": 64}


@pytest.mark.parametrize("options, burnin", [
    ({}, None),
    ({**_MH, "mh_burnin_passes": 0}, 0),
    ({**_MH, "mh_burnin_passes": 3}, 3),
    ({**_MH, "mh_burnin_passes": 1, "replay": "host"}, 1),
    ({**_MH, "mh_burnin_passes": 1, "precision": "extended"}, 1),
], ids=["uniform", "mh", "mh-burnin", "mh-host", "mh-df32"])
def test_mh_passes_and_the_tail_flush_are_traced(options, burnin):
    """An MH pass's cb.classify span says so (``sampler``, ``burnin`` on a
    burn-in pass, and the orbit's ``precision``), the snapshot counts them
    (``mh_f32_passes``: those of the float32 orbit), and the readback's
    tail flush has its span (device or host mode); a uniform render
    traces as before, with none of them."""
    result, _ = _profiled(_cfg(**options))
    tr = result.stats["trace"]
    recs = [r for r in trace.last().records if r.name == "cb.classify"]
    if burnin is None:
        assert not {"mh_passes", "mh_burnin_passes", "mh_f32_passes"} & set(tr)
        assert "cb.mh_tail" not in tr["spans"]
        assert all(r.attrs == {} for r in recs)
        return
    precision = options.get("precision", "float32")
    assert (tr["mh_passes"], tr["mh_burnin_passes"]) == (PASSES, burnin)
    assert tr["mh_f32_passes"] == (PASSES if precision == "float32" else 0)
    assert [r.attrs for r in recs] == (
        [{"sampler": "mh", "burnin": True, "precision": precision}] * burnin
        + [{"sampler": "mh", "burnin": False, "precision": precision}]
        * (PASSES - burnin))
    assert tr["spans"]["cb.mh_tail"]["count"] == 1
    tail = [r for r in trace.last().records if r.name == "cb.mh_tail"]
    assert tail[0].parent is None and tail[0].pass_index == PASSES - 1
    assert result.stats["on_canvas_points"] == int(result.histogram.sum())


@pytest.mark.parametrize("capacity, route", [(4096, "length"),
                                             (1024, "length"),
                                             (512, "select")])
def test_compaction_route_is_counted_and_on_the_span(capacity, route):
    """A plan whose capacity holds its 1,024 emission slots compacts by
    the length sort, one below them by the selection: the span's
    ``route`` attribute and the count a route say which, every pass."""
    cfg = _cfg(replay_capacity=capacity)
    engine = engines.make_engine(cfg, device="cpu")
    assert engine.tuning.emission_slots == 1024
    assert engine.compact_route == route
    launches.reset()
    result, _ = _profiled(cfg, engine)
    assert result.stats["trace"]["compact_routes"] == {route: PASSES}
    assert {r.attrs["route"] for r in trace.last().records
            if r.name == "cb.compact"} == {route}
    ran = {"length": "length_sort_plain", "select": "threefry_bits_plain"}
    assert launches.COUNTS[ran[route]] == PASSES
    assert all(launches.COUNTS[k] == 0 for k in ran.values()
               if k != ran[route])


@pytest.mark.parametrize("options", [
    dict(),
    dict(replay="host", replay_device_share=0.5),
], ids=["device", "hybrid"])
def test_counters_span_every_pass_and_equal_the_old_expression(
        options, monkeypatch):
    """The counters run once a pass under their span, through the plain
    version, and reading only the kept prefix they total what the
    expression the engine ran before them totals over the whole batch: on
    the device replay's batch and on the hybrid split's, whose holes lie
    inside the prefix."""
    from cudabrot_tpu_torch.ops import pass_counters as pc
    from tests.test_torch_pass_counters import _old_expression

    if options and shutil.which("g++") is None:
        pytest.skip("needs g++ to build the host replay library")
    launches.reset()
    result, _ = _profiled(_cfg(**options))
    assert result.stats["trace"]["spans"]["cb.counters"]["count"] == PASSES
    assert launches.COUNTS["pass_counters_plain"] == PASSES
    assert launches.COUNTS["pass_counters"] == 0

    def old(stats, n_valid, iters, totals, *, steps_per_pass, capacity):
        _old_expression(totals, stats, n_valid, iters, steps_per_pass,
                        capacity)

    monkeypatch.setattr(pc, "pass_counters", old)
    want = _render(_cfg(**options))
    keys = UNTRACED_KEYS - {"replay"}
    assert {k: result.stats[k] for k in keys} == \
        {k: want.stats[k] for k in keys}
    assert want.stats["orbit_points"] > 0


def test_data_parallel_records_each_replica():
    cfg = _cfg(num_devices=2)
    engine = engines.make_engine(cfg, device="cpu")
    assert engine.name == "dp(cuda)"
    result, _ = _profiled(cfg, engine)
    recs = [r for r in trace.last().records if r.name == "cb.replica"]
    assert len(recs) == 2 * PASSES
    assert sorted({r.attrs["ordinal"] for r in recs}) == [0, 1]
    assert {r.parent for r in recs} == {"cb.pass"}
    spans = result.stats["trace"]["spans"]
    assert spans["cb.classify"]["count"] == 2 * PASSES
    assert {"0.hist", "1.hist"} <= set(result.stats["trace"]["buffers"])


class _Stream:
    device_index = 0


class _Side(_Stream):
    """A side stream whose work completes only at a full synchronize."""

    def __init__(self):
        self.done = True

    def query(self):
        return self.done


class _Event:
    """A timing event on a fake device clock that advances 1 ms a
    record; complete once its stream's work is (``query``), and read only
    then."""

    clock = [0.0]
    made = [0]

    def __init__(self, enable_timing=False):
        _Event.made[0] += 1
        self.t = None

    def record(self, stream):
        _Event.clock[0] += 1.0
        self.t = _Event.clock[0]
        self.stream = stream

    def query(self):
        return getattr(self.stream, "done", True)

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before it completed"
        return end.t - self.t


def test_device_events_are_pooled_and_bubbles_pair_drain_and_refill(
        monkeypatch):
    """The CUDA path's bookkeeping on fake streams and events: every
    span's pair read once a synchronize has completed it, the events
    reused from the pool, and one bubble a group boundary."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(trace, "_stream_of",
                        lambda device: None if device is False else _Stream)
    _Event.clock[0], _Event.made[0] = 0.0, 0
    result, _ = _profiled(_cfg(passes=6))
    t = result.stats["trace"]
    per_pass = trace.last().device_ms
    for name in LAYERS:
        s = t["spans"][name]
        assert sorted(per_pass[name]) == list(range(6))
        assert s["device_ms"] == pytest.approx(sum(per_pass[name].values()))
        assert 0 < s["device_ms_p50"] <= s["device_ms_p90"]
    # Groups end at passes 2, 4 and 6; the last is not refilled.
    assert t["sync_bubbles"] == 2 and t["sync_bubble_ms"] > 0
    # A group's events are read at the next group's end: the third group
    # takes the first's from the pool.
    per_group = 2 * 2 * len(LAYERS) + 2
    assert _Event.made[0] == 2 * per_group
    assert not trace.last()._pending and not trace.last()._bubbles
    # The CPU engine's group waits are full synchronizes: no tail.
    assert t["sync_groups"] == 3 and t["replay_tails"] == 0
    assert t["replay_tail_ms"] == 0


def test_side_stream_spans_are_read_once_a_wait_completes_them(
        monkeypatch):
    """A group's wait that drains the main stream only: the deposit spans
    on the side stream, still running after it, are read at the final
    synchronize and never earlier; every group end counts, each with a
    replay tail past the drain."""
    main, side = _Stream(), _Side()
    current = [main]
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(trace, "_stream_of",
                        lambda device: None if device is False else
                        current[0])
    read_at_group_ends = []

    class Engine:
        name = "fake"
        device = torch.device("cpu")
        steps_per_pass = 1
        replay_streams = [side]

        def memory_estimate(self):
            return 0, 0

        def init_state(self, hist0):
            return {"hist": torch.zeros(1)}

        def warmup(self, state):
            pass

        def run_pass(self, state, pass_index):
            with trace.span("cb.classify", device=self.device):
                pass
            current[0], side.done = side, False
            with trace.span("cb.deposit", device=self.device):
                pass
            current[0] = main
            return state

        def sync_group(self):
            read_at_group_ends.append(
                dict(trace._tracer.device_ms.get("cb.deposit", {})))

        def synchronize(self):
            side.done = True

        def histogram(self, state):
            return np.zeros((32, 32), np.uint32)

        def stats(self, state):
            return {}

    result, _ = _profiled(_cfg(passes=6), Engine())
    t = result.stats["trace"]
    tr = trace.last()
    assert read_at_group_ends == [{}, {}, {}]
    assert sorted(tr.device_ms["cb.deposit"]) == list(range(6))
    assert sorted(tr.device_ms["cb.classify"]) == list(range(6))
    assert not tr._pending and not tr._bubbles and not tr._tails
    assert t["sync_groups"] == 3 and t["replay_tails"] == 3
    assert t["replay_tail_ms"] > 0
    assert t["sync_bubbles"] == 2 and t["sync_bubble_ms"] > 0


def test_device_counts_are_made_and_read_only_under_tracing(monkeypatch):
    """A kernel's device counts (``trace.device_counts``, as the f32
    classify kernel's late warps and their items): without a profiler none
    are made and the stats have none; under one, the plain version reports
    none (it has no warps), and a kernel that adds to them each pass has
    its words made once a device, read when tracing stops and reported
    under their fields."""
    real, asked = cls.classify_pass_plain, []

    def counting(state, *args, **kw):
        words = trace.device_counts("classify_late", state.cr.device,
                                    cls.LATE_FIELDS)
        asked.append(words)
        if words is not None:
            words += torch.tensor([1, 3])
        return real(state, *args, **kw)

    result, _ = _profiled(_cfg())
    assert not set(cls.LATE_FIELDS) & set(result.stats["trace"])
    monkeypatch.setattr(cls, "classify_pass_plain", counting)
    result = _render(_cfg())
    assert asked == [None] * PASSES
    assert set(result.stats) == UNTRACED_KEYS
    asked.clear()
    result, _ = _profiled(_cfg())
    t = result.stats["trace"]
    assert len(asked) == PASSES and all(w is asked[0] for w in asked)
    assert t["classify_late_warps"] == PASSES
    assert t["classify_late_items"] == 3 * PASSES
    assert trace.device_counts("classify_late", torch.device("cpu"),
                               cls.LATE_FIELDS) is None


def test_tracer_turns_off_when_the_render_fails():
    class Boom(RuntimeError):
        pass

    engine = engines.make_engine(_cfg(), device="cpu")

    def run_pass(state, pass_index):
        raise Boom

    engine.run_pass = run_pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(Boom):
            _render(_cfg(), engine)
    assert trace._tracer is None
    assert trace.span("cb.pass") is trace._NOOP


def test_snapshot_percentiles_per_pass():
    tr = trace.Tracer()
    tr.records = [trace.Record("cb.deposit", 0, 10, 10, "cb.pass", p, 0, {})
                  for p in range(3)]
    # Two launches in pass 2 count as that pass's time.
    tr.device_ms = {"cb.deposit": {0: 1.0, 1: 2.0, 2: 3.0 + 4.0}}
    s = tr.snapshot()["spans"]["cb.deposit"]
    assert s["count"] == 3 and s["host_ms"] == pytest.approx(3e-5)
    assert s["device_ms"] == pytest.approx(10.0)
    assert s["device_ms_p50"] == pytest.approx(2.0)
    assert s["device_ms_p90"] == pytest.approx(6.0)
