"""The device trace of a run's window, reduced to what the readers need.

A traced run records the whole render with ``torch.profiler`` (CPU and
CUDA activity). The window is marked by a zero-length host range,
``h100bench.window``, recorded where the renderer's loop begins, and
lasts the render's own ``elapsed_seconds``; device activity is clipped
to it. Only the raw events are read (no chrome trace is written).

Each device operation belongs to a layer by the ordered name table of
``h100bench/layers.json`` (first matching substring; the table's
``default`` otherwise). A layer's time is the union of its operations'
intervals, so operations that overlap on two streams count once.

Each card is reduced on its own timeline: in a render over several cards
the busy time is the mean of the cards' (so the idle share is the mean of
each card's), a layer's time is the sum over the cards of its union on
each (card-seconds), and each card's idle gaps count a share of one over
the number of cards.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from pathlib import Path

WINDOW_MARK = "h100bench.window"
LAYERS_FILE = Path(__file__).resolve().parents[1] / "layers.json"
TOP = 10


def load_layers(path: Path = LAYERS_FILE) -> dict:
    table = json.loads(path.read_text())
    return {"rules": [tuple(r) for r in table["rules"]],
            "default": table["default"]}


def layer_of(name: str, layers: dict) -> str:
    for sub, layer in layers["rules"]:
        if sub in name:
            return layer
    return layers["default"]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name[:64]


def union_ns(spans) -> int:
    """Total length of the union of (start, end) intervals."""
    total, hi, lo = 0, None, None
    for s, e in sorted(spans):
        if hi is None or s > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    if hi is not None:
        total += hi - lo
    return total


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float  # the mean over the cards
    layer_s: dict  # layer -> seconds (each card's union, summed)
    op_s: dict  # short operation name -> seconds (sum of durations)
    idle_by_host: dict  # host activity in idle gaps -> seconds, mean a card

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def reduce_events(device, host, window_start_ns: int, window_ns: int,
                  layers: dict, cards: int = 1) -> Reduced:
    """``device``: (name, start_ns, end_ns, card); ``host``: (name,
    start_ns, end_ns). Device operations are clipped to the window; each
    card's idle gaps between them are put down to the innermost host range
    running at their start ("python" where none is). ``cards``: the cards
    the run uses, each counted whether or not it ran an operation in the
    window."""
    lo, hi = window_start_ns, window_start_ns + window_ns
    per_card: dict = {}  # card -> (spans, layer -> spans)
    op_s = {}
    for name, s, e, card in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        spans, by_layer = per_card.setdefault(card, ([], {}))
        spans.append((s, e))
        by_layer.setdefault(layer_of(name, layers), []).append((s, e))
        key = short_name(name)
        op_s[key] = op_s.get(key, 0.0) + (e - s) / 1e9
    timelines = list(per_card.values())
    timelines += [([], {})] * (cards - len(timelines))
    n = len(timelines)
    host = sorted((h for h in host if h[2] > lo and h[1] < hi
                   and h[0] != WINDOW_MARK), key=lambda h: h[1])
    starts = [h[1] for h in host]
    busy, layer_s, idle_by_host = 0.0, {}, {}
    for spans, by_layer in timelines:
        busy += union_ns(spans) / 1e9 / n
        for k, v in by_layer.items():
            layer_s[k] = layer_s.get(k, 0.0) + union_ns(v) / 1e9
        for a, b in _idle_gaps(sorted(spans), lo, hi):
            what = _host_at(host, starts, a)
            idle_by_host[what] = (idle_by_host.get(what, 0.0)
                                  + (b - a) / 1e9 / n)
    return Reduced(window_s=window_ns / 1e9, busy_s=busy, layer_s=layer_s,
                   op_s=op_s, idle_by_host=idle_by_host)


def _idle_gaps(spans, lo: int, hi: int):
    gaps, reach = [], lo
    for s, e in spans:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def _host_at(host, starts, t: int, look_back: int = 4096) -> str:
    """The host range with the latest start at or before ``t`` that is
    still running at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if host[j][2] > t:
            return host[j][0]
    return "python"


def events_of(prof):
    """(device, host, window mark's start) from a stopped
    ``torch.profiler.profile``'s raw events: device operations as (name,
    start_ns, end_ns, card index), host ranges as (name, start_ns,
    end_ns)."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    raw = results.events() if results is not None else []
    device, host, mark = [], [], None
    for ev in raw:
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, s, e, ev.device_index()))
        else:
            host.append((name, s, e))
            if name == WINDOW_MARK and mark is None:
                mark = s
    return device, host, mark
