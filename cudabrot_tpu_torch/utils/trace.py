"""Spans at the layer boundaries of a render's pass, recorded only while a
``torch.profiler`` records.

``driver.run_render`` turns the tracer on for one render if and only if a
profiler is recording as its pass loop begins (``profiler_recording``):
the benchmark's traced run, or ``--profile-dir``. Every other render
takes the off path, where ``span`` returns one shared no-op context after
a single read of a module variable.

An open span (``span(name, device=..., **attrs)``):

* opens a host range of its name in the profiler (``_RecordFunctionFast``:
  ``torch.profiler.record_function``'s range without its user scope, for
  which the profiler also emits a device-side annotation that a reader of
  device activity would count as device work), on the profiler's host
  clock, so the profiler's trace shows it and an idle gap of the device
  can be put down to it;
* records its start and end (``time.monotonic_ns``), its parent span, the
  pass it belongs to, its device and its attributes, in memory;
* given a CUDA device, records a pair of timing events on that device's
  current stream at entry and exit, taken from a pool.

Device times are read only from events a wait the render makes anyway
has completed (``after_sync`` marks them); the tracer adds none. The wait
at a group's end drains the main stream, and may leave the side streams'
last replays running (``CudaEngine.sync_group``): after it the events on
the main stream are complete, and an event pair on another stream is read
once its end event reports complete (``query``), at the latest after the
render's final synchronize, which completes every event. Before each
group's wait ``mark_drain`` reads the events completed so far (the device
then works through the group just issued, so the reads cost it nothing)
and records an event on the main stream; the next pass records another
as it starts, and the time between the two is a sync bubble: the main
stream's idle time between groups, which the drain and refill cost.
Right after a group's wait, a side stream still running (``query``) is a
replay tail: an event recorded there times how long it ran past the
drain.

``stop`` turns the tracer off and returns its snapshot: for each span
name the count, host ms in total and self (less its child spans), and,
where it had device events, device ms in total and per pass at p50 and
p90; the sync bubbles; the compactions by their ``route`` attribute
(``compact_routes``: "length" or "select", one a pass and device); the
Metropolis-Hastings passes, where there were any, by the ``cb.classify``
spans of attribute ``sampler="mh"`` (``mh_passes``, one a pass and
device), those of them with ``burnin`` (``mh_burnin_passes``) and those
of ``precision="float32"`` (``mh_f32_passes``; "extended" is the df32
orbit); the
group ends (``sync_groups``), those with a replay tail
(``replay_tails``) and the tails' device ms past the drain
(``replay_tail_ms``); the device counts that kernels add to while tracing
is on (``device_counts``: the f32 classify kernel's late warps and their
items), read once, after the render's last wait; and the buffer record
(the addresses of the histogram and of the lane state, and the allocator's
reserved bytes), taken once, after the first synchronize.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

_NOOP = contextlib.nullcontext()
#: The tracer of the render being traced; None when tracing is off.
_tracer: Tracer | None = None
#: The tracer of the last traced render, with its records.
_last: Tracer | None = None


def profiler_recording() -> bool:
    """Whether a ``torch.profiler`` is recording on this thread."""
    from torch.autograd import profiler

    return bool(getattr(profiler, "_is_profiler_enabled", False)
                or torch.autograd._profiler_enabled())


class Record(NamedTuple):
    name: str
    start_ns: int  # time.monotonic_ns()
    end_ns: int
    self_ns: int  # the duration less what its child spans cover
    parent: str | None
    pass_index: int  # -1 before the first pass
    device_index: int | None  # the CUDA device of its events
    attrs: dict


class Tracer:
    """The spans, device events and counters of one traced render."""

    def __init__(self):
        self.records: list[Record] = []
        self.stack: list[_Span] = []
        self.pass_index = -1
        #: Add to a span's monotonic time to place it on the profiler's
        #: clock (the Unix epoch, in nanoseconds).
        self.profiler_offset_ns = time.time_ns() - time.monotonic_ns()
        #: name -> {pass index: device ms}
        self.device_ms: dict[str, dict[int, float]] = {}
        self.bubble_ms = 0.0
        self.bubbles = 0
        self.sync_groups = 0
        self.replay_tails = 0
        self.replay_tail_ms = 0.0
        self.buffers: dict | None = None
        #: name -> (fields, {device: int64 words the kernels add to})
        self.counts: dict[str, tuple[tuple, dict]] = {}
        self._pool: dict[int, list] = {}
        self._pending: list = []  # (name, pass, device index, stream, e0, e1)
        #: (device index, drain event, refill, whether the drain event goes
        #: back to the pool: not where a tail also reads it)
        self._bubbles: list = []
        self._tails: list = []  # (device index, drain event, end events)
        #: How many of the span pairs and the bubbles were recorded before
        #: the last wait, and the stream it drained (None: every stream).
        self._done = (0, 0)
        self._drained = None
        #: (device index, event, pooled) awaiting the next pass
        self._drain = None

    def event(self, stream) -> torch.cuda.Event:
        pool = self._pool.setdefault(stream.device_index, [])
        ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def begin_pass(self, pass_index: int, stream) -> None:
        self.pass_index = pass_index
        if self._drain is not None and stream is not None:
            dev, drained, pooled = self._drain
            self._bubbles.append((dev, drained, self.event(stream), pooled))
            self._drain = None

    def synced(self, drained=None) -> None:
        """A wait has completed every event recorded so far on the stream
        ``drained`` (None: on every stream)."""
        self._done = (len(self._pending), len(self._bubbles))
        self._drained = drained

    def tail_check(self, streams) -> None:
        """Right after a group's wait: a side stream of ``streams`` still
        running is a replay tail, timed from the drain event to an event
        recorded there."""
        self.sync_groups += 1
        running = [s for s in streams if not s.query()]
        if not running or self._drain is None:
            return
        dev, drained, _ = self._drain
        self.replay_tails += 1
        self._tails.append((dev, drained, [self.event(s) for s in running]))
        self._drain = (dev, drained, False)

    def read_events(self) -> None:
        """Device times of the event pairs that have completed: those a
        wait drained, and those on another stream whose end event reports
        complete; their events go back to the pool."""
        spans, bubbles = self._done
        drained, keep = self._drained, []
        for entry in self._pending[:spans]:
            name, p, dev, stream, e0, e1 = entry
            if not (drained is None or stream == drained or e1.query()):
                keep.append(entry)
                continue
            per_pass = self.device_ms.setdefault(name, {})
            per_pass[p] = per_pass.get(p, 0.0) + e0.elapsed_time(e1)
            self._pool[dev] += (e0, e1)
        for dev, drained_ev, refill, pooled in self._bubbles[:bubbles]:
            self.bubble_ms += drained_ev.elapsed_time(refill)
            self.bubbles += 1
            self._pool[dev].append(refill)
            if pooled:
                self._pool[dev].append(drained_ev)
        tails = []
        for tail in self._tails:
            dev, drained_ev, ends = tail
            if drained is None or all(e.query() for e in ends):
                self.replay_tail_ms += max(drained_ev.elapsed_time(e)
                                           for e in ends)
                self._pool[dev] += ends
            else:
                tails.append(tail)
        self._pending[:spans] = keep
        del self._bubbles[:bubbles]
        self._tails = tails
        self._done = (len(keep), 0)

    def snapshot(self) -> dict:
        spans: dict[str, dict] = {}
        for r in self.records:
            s = spans.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                          "self_host_ms": 0.0})
            s["count"] += 1
            s["host_ms"] += (r.end_ns - r.start_ns) / 1e6
            s["self_host_ms"] += r.self_ns / 1e6
        for name, per_pass in self.device_ms.items():
            ms = list(per_pass.values())
            p50, p90 = np.percentile(ms, (50, 90))
            spans[name].update(device_ms=float(sum(ms)),
                               device_ms_p50=float(p50),
                               device_ms_p90=float(p90))
        routes = collections.Counter(r.attrs.get("route")
                                     for r in self.records
                                     if r.name == "cb.compact")
        out = {"spans": spans, "sync_bubble_ms": self.bubble_ms,
               "sync_bubbles": self.bubbles, "sync_groups": self.sync_groups,
               "compact_routes": dict(routes),
               "replay_tails": self.replay_tails,
               "replay_tail_ms": self.replay_tail_ms,
               "buffers": self.buffers or {}}
        for fields, words in self.counts.values():
            sums = [0] * len(fields)
            for t in words.values():
                sums = [a + b for a, b in zip(sums, t.tolist())]
            out.update(zip(fields, sums))
        mh = [r for r in self.records
              if r.name == "cb.classify" and r.attrs.get("sampler") == "mh"]
        if mh:
            out["mh_passes"] = len(mh)
            out["mh_burnin_passes"] = sum(r.attrs["burnin"] for r in mh)
            out["mh_f32_passes"] = sum(r.attrs["precision"] == "float32"
                                       for r in mh)
        return out


class _Span:
    __slots__ = ("tracer", "name", "stream", "attrs", "parent", "child_ns",
                 "t0", "ev0", "rf")

    def __init__(self, tracer: Tracer, name: str, stream, attrs: dict):
        self.tracer, self.name, self.stream, self.attrs = (
            tracer, name, stream, attrs)
        self.child_ns = 0

    def __enter__(self):
        # The span's times enclose its profiler range and its events.
        self.t0 = time.monotonic_ns()
        tr = self.tracer
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if "pass_index" in self.attrs:
            tr.begin_pass(self.attrs["pass_index"], self.stream)
        self.parent = tr.stack[-1] if tr.stack else None
        tr.stack.append(self)
        if self.stream is not None:
            self.ev0 = tr.event(self.stream)
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        dev = None
        if self.stream is not None:
            dev = self.stream.device_index
            tr._pending.append((self.name, tr.pass_index, dev, self.stream,
                                self.ev0, tr.event(self.stream)))
        tr.stack.pop()
        self.rf.__exit__(*exc)
        t1 = time.monotonic_ns()
        took = t1 - self.t0
        if self.parent is not None:
            self.parent.child_ns += took
        tr.records.append(Record(
            self.name, self.t0, t1, took - self.child_ns,
            self.parent.name if self.parent is not None else None,
            tr.pass_index, dev, self.attrs))
        return False


def _stream_of(device):
    """The current stream of ``device``, or None where no timing events
    apply (False, a CPU device)."""
    if device is False or device.type != "cuda":
        return None
    return torch.cuda.current_stream(device)


def span(name: str, *, device=False, **attrs):
    """A context around the work issued at one layer boundary: a no-op
    while tracing is off. ``device``: the device whose current stream
    takes the span's timing events (none on a CPU device, or False); a
    ``pass_index`` attribute opens that pass."""
    tr = _tracer
    if tr is None:
        return _NOOP
    return _Span(tr, name, _stream_of(device), attrs)


def device_counts(name: str, device, fields: tuple) -> torch.Tensor | None:
    """While tracing is on, the int64 words (one a field) on ``device`` that
    a kernel adds its counts ``name`` to, zeroed once a render; else None,
    and the kernel counts nothing. The words are read when tracing stops,
    after the render's last wait, into ``stats["trace"]`` under
    ``fields``, summed over devices."""
    tr = _tracer
    if tr is None:
        return None
    words = tr.counts.setdefault(name, (tuple(fields), {}))[1]
    t = words.get(device)
    if t is None:
        t = words[device] = torch.zeros(len(fields), dtype=torch.int64,
                                        device=device)
    return t


def start() -> Tracer:
    """Turn tracing on for a render. A zero-length ``cb.trace`` range
    marks the start in the profile, and pays the first range's set-up in
    the process (a millisecond or more) before the first pass's."""
    global _tracer
    with torch._C._profiler._RecordFunctionFast("cb.trace"):
        pass
    _tracer = Tracer()
    return _tracer


def stop() -> dict | None:
    """Turn tracing off; the snapshot of the render traced, or None if
    tracing was off."""
    global _tracer, _last
    tr, _tracer = _tracer, None
    if tr is None:
        return None
    tr.read_events()
    _last = tr
    return tr.snapshot()


def last() -> Tracer | None:
    """The tracer of the last traced render (its records)."""
    return _last


def mark_drain(engine) -> None:
    """Before a group's wait: read the events completed so far and record
    the event that marks the drained main stream (not queued behind the
    side streams' replays, which the wait may leave running)."""
    tr = _tracer
    if tr is None:
        return
    tr.read_events()
    stream = _stream_of(engine.device)
    if stream is not None:
        tr._drain = (stream.device_index, tr.event(stream), True)


def after_sync(state, engine, group: bool) -> None:
    """After a wait: mark the events it completed, those on the main
    stream after a group's wait (``group``, which counts it and checks the
    side streams for a replay tail), else every one; the first time,
    record the buffers of ``state`` (a state dict, or a list of them, one
    a device) on the engine's device."""
    tr = _tracer
    if tr is None:
        return
    if group:
        tr.synced(_stream_of(engine.device))
        tr.tail_check(getattr(engine, "replay_streams", ()))
    else:
        tr.synced()
    if tr.buffers is None:
        tr.buffers = _buffer_record(state, engine.device)


def _buffer_record(state, device) -> dict:
    """The addresses of the histogram and of each lane-state tensor of
    ``state``, and the allocator's bytes reserved on ``device``."""
    states = state if isinstance(state, list) else [state]
    out = {}
    for i, st in enumerate(states):
        pre = f"{i}." if len(states) > 1 else ""
        out[pre + "hist"] = st["hist"].data_ptr()
        lanes = st.get("lanes")
        if lanes is not None:
            for k, v in lanes._asdict().items():
                out[f"{pre}lanes.{k}"] = v.data_ptr()
    out["memory_reserved"] = (torch.cuda.memory_reserved(device)
                              if device.type == "cuda" else 0)
    return out
