"""The output check: passes of the timed window against the plain
reference.

A render's answer is its histogram and counters, the sum of its passes'.
The window runs thousands of passes, and the reference, plain PyTorch,
would take far longer than the window to redo them, so the check takes a
sample: pass 0 and one pass drawn from the seed in the window's first
half. ``PassCapture`` wraps the engine's ``run_pass`` for those two: it
keeps the lane state before and after, the counters before and after, and
the histogram's change over the pass, each once the pass's replays have
landed (a wait of the main stream on the replay streams, no host sync).

After the window the reference redoes each sampled pass and the check
counts what differs: bins of the pass's histogram change, counters, words
of the lane state after it. Pass 0 starts from the reference's own
initial lanes (and the program's are compared with them); the later pass
starts from the program's lanes, since nothing else can reach that point
in time. The window's histogram is checked for its accounting: its sum
against the points the replays counted on the canvas. Every limit is 0:
the renderer rounds each operation once, as the reference does.
"""

from __future__ import annotations

import random

import torch

#: The renderer's counter keys, as its state holds them.
COUNTERS = ("samples", "culled", "in_band", "cycles", "wasted", "iters",
            "emitted", "replay_dropped", "points", "dev_hits")
LIMIT = 0


def check_passes(seed: int, seconds: float, pass_s: float) -> list[int]:
    """Pass 0 and a pass drawn from the seed among those the window's
    first half surely reaches (from the warm-up's time a pass)."""
    reach = max(2, int(0.5 * seconds / max(pass_s, 1e-6)))
    mid = 1 + random.Random(int(seed) ^ 0x5EED).randrange(reach - 1)
    return [0, mid]


def plan_of(engine, ref):
    """The engine's execution plan as the reference module ``ref`` takes
    it; refuses an engine whose pass the uniform float32 reference does
    not model."""
    tn = engine.tuning
    o = engine.cfg.options
    if (engine.extended or engine.mh or not tn.thin_tracking
            or not o.cycle_detection or engine.cfg.fractal != "buddhabrot"
            or engine.visit_window is not None):
        raise ValueError("the uniform float32 reference models thin-"
                         "tracked Buddhabrot passes with cycle detection")
    return ref.Plan(lanes=engine.lanes, steps_per_pass=tn.steps_per_pass,
                    steps_per_flush=tn.steps_per_flush,
                    unroll=tn.inner_unroll, capacity=tn.replay_capacity)


def _lanes(lanes) -> dict:
    return {k: v.reshape(-1).clone() for k, v in lanes._asdict().items()}


class PassCapture:
    """Wraps ``engine.run_pass`` to keep what the sampled passes did."""

    def __init__(self, engine, passes):
        self.engine = engine
        self.passes = set(passes)
        self.taken: dict = {}
        self._run = engine.run_pass
        engine.run_pass = self.run_pass

    def run_pass(self, state, pass_index):
        if pass_index not in self.passes:
            return self._run(state, pass_index)
        eng = self.engine
        eng.wait_replay()
        before = _lanes(state["lanes"])
        ctr = {k: state[k].clone() for k in COUNTERS}
        hist = state["hist"].clone()
        state = self._run(state, pass_index)
        eng.wait_replay()
        hist.sub_(state["hist"]).neg_()
        self.taken[pass_index] = dict(
            before=before, after=_lanes(state["lanes"]),
            counters={k: state[k] - ctr[k] for k in COUNTERS}, hist=hist)
        return state

    def to_host(self) -> None:
        """Moves what was kept off the device (after the window)."""
        for t in self.taken.values():
            t["hist"] = t["hist"].cpu()
            t["counters"] = {k: int(v) for k, v in t["counters"].items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype.is_floating_point:
        return t.to(torch.float32).view(torch.int32)
    return t


def lanes_differ(a: dict, b: dict) -> int:
    """Words of two lane states that differ (floats by their bits)."""
    return int(sum(int((_bits(a[k].cpu()) != _bits(b[k].cpu())).sum())
                   for k in a))


def compare(answer, expected) -> dict:
    """Numbers that differ between the program's pass (``answer``:
    after-lanes, histogram change, counters) and the reference's."""
    a_lanes, a_hist, a_ctr = answer
    e_lanes, e_hist, e_ctr = expected
    bins = int((a_hist.reshape(-1) != e_hist.reshape(-1)).sum())
    return {"bins": bins,
            "counters": sum(int(a_ctr[k] != e_ctr[k]) for k in COUNTERS),
            "lanes": lanes_differ(a_lanes, e_lanes)}


def run_checks(ref, capture: PassCapture, seed: int, plan, scene,
               device) -> dict:
    """The compared numbers of the sampled passes (``start.*``: pass 0,
    ``mid.*``: the other), each {"value", "limit"}."""
    out = {}
    for p in sorted(capture.taken):
        t = capture.taken[p]
        tag = "start" if p == 0 else "mid"
        if p == 0:
            lanes_in = ref.init_lanes(plan.lanes, device)
            out["start.init"] = lanes_differ(t["before"], lanes_in)
        else:
            lanes_in = {k: v.to(device) for k, v in t["before"].items()}
        expected = ref.run_pass(lanes_in, seed, p, plan, scene)
        got = compare((t["after"], t["hist"], t["counters"]), expected)
        for k, v in got.items():
            out[f"{tag}.{k}"] = v
    return {k: {"value": v, "limit": LIMIT} for k, v in out.items()}


def totals_checks(hist_sum: int, stats: dict) -> dict:
    """The window's accounting: the histogram's sum against the points
    the replays counted on the canvas."""
    return {"total.hist": {
        "value": abs(hist_sum - int(stats["on_canvas_points"])),
        "limit": LIMIT}}


def control_checks(ref, seed: int, pass_index: int, plan, scene, device,
                   dtype=torch.bfloat16) -> dict:
    """The control: the reference at ``dtype`` in the program's place on
    one pass from the initial lanes, compared as ``run_checks`` compares
    the program."""
    lanes = ref.init_lanes(plan.lanes, device)
    expected = ref.run_pass(lanes, seed, pass_index, plan, scene)
    low = ref.run_pass(ref.init_lanes(plan.lanes, device, dtype), seed,
                       pass_index, plan, scene, dtype)
    return compare(low, expected)
