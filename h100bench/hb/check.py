"""The output check: passes of the timed window against the plain
reference.

A render's answer is its histogram and counters, the sum of its passes'.
The window runs thousands of passes, and the reference, plain PyTorch,
would take far longer than the window to redo them, so the check takes a
sample: pass 0 and one pass drawn from the seed in the window's first
half. ``PassCapture`` wraps the engine's ``run_pass`` for those two: of
every replica (one a device of a data-parallel render, else the one
engine) it keeps the lane state before and after, the counters' change
and the histogram's change over the pass, each once the pass's replays
have landed (a wait of the main stream on the replay streams, no host
sync).

After the window the reference redoes each sampled pass of each replica,
at the replica's RNG ordinal, and the check counts what differs: bins of
the pass's histogram change, counters, words of the lane state after it,
summed over the replicas. Pass 0 starts from the reference's own initial
lanes (and the program's are compared with them); the later pass starts
from the program's lanes, since nothing else can reach that point in
time. The window's histogram is checked for its accounting: its sum
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


def engines_of(engine) -> list:
    """The single-device engines of ``engine``, one a replica: the inner
    engines of a data-parallel render, else the engine itself."""
    return list(getattr(engine, "inners", [engine]))


def _lanes(lanes) -> dict:
    return {k: v.reshape(-1).clone() for k, v in lanes._asdict().items()}


class PassCapture:
    """Wraps ``engine.run_pass`` to keep what the sampled passes did, of
    every replica, keyed by (pass, RNG ordinal). Replica ``i`` of a render
    in one process draws from ordinal ``i`` (0 for one card): the check
    holds each replica to that stream, whatever the program's
    ``ordinals()`` says."""

    def __init__(self, engine, passes):
        self.engine = engine
        self.passes = set(passes)
        self.ordinals = range(len(engines_of(engine)))
        self.taken: dict = {}
        self._run = engine.run_pass
        engine.run_pass = self.run_pass

    @property
    def unchecked(self) -> int:
        """Sampled replica-passes the window did not reach."""
        return len(self.passes) * len(self.ordinals) - len(self.taken)

    def run_pass(self, state, pass_index):
        if pass_index not in self.passes:
            return self._run(state, pass_index)
        eng = self.engine
        eng.wait_replay()
        before = [dict(lanes=_lanes(st["lanes"]),
                       counters={k: st[k].clone() for k in COUNTERS},
                       hist=st["hist"].clone()) for st in _replicas(state)]
        state = self._run(state, pass_index)
        eng.wait_replay()
        for ordinal, st, b in zip(self.ordinals, _replicas(state), before):
            self.taken[(pass_index, ordinal)] = dict(
                before=b["lanes"], after=_lanes(st["lanes"]),
                counters={k: st[k] - b["counters"][k] for k in COUNTERS},
                hist=b["hist"].sub_(st["hist"]).neg_())
        return state

    def to_host(self) -> None:
        """Moves what was kept off the devices (after the window)."""
        for t in self.taken.values():
            t["hist"] = t["hist"].cpu()
            t["counters"] = {k: int(v) for k, v in t["counters"].items()}


def _replicas(state) -> list:
    """The per-device state dicts: a data-parallel state is a list."""
    return state if isinstance(state, list) else [state]


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
    ``mid.*``: the other), each summed over the replicas and given as
    {"value", "limit"}. The reference runs on ``device`` (the first
    card), each replica-pass at that replica's ordinal."""
    out: dict = {}

    def add(key, v):
        out[key] = out.get(key, 0) + v

    for p, ordinal in sorted(capture.taken):
        t = capture.taken[(p, ordinal)]
        tag = "start" if p == 0 else "mid"
        if p == 0:
            lanes_in = ref.init_lanes(plan.lanes, device)
            add("start.init", lanes_differ(t["before"], lanes_in))
        else:
            lanes_in = {k: v.to(device) for k, v in t["before"].items()}
        expected = ref.run_pass(lanes_in, seed, p, plan, scene,
                                ordinal=ordinal)
        got = compare((t["after"], t["hist"], t["counters"]), expected)
        for k, v in got.items():
            add(f"{tag}.{k}", v)
    return {k: {"value": v, "limit": LIMIT} for k, v in out.items()}


def totals_checks(hist_sum: int, stats: dict) -> dict:
    """The window's accounting: the histogram's sum against the points
    the replays counted on the canvas."""
    return {"total.hist": {
        "value": abs(hist_sum - int(stats["on_canvas_points"])),
        "limit": LIMIT}}


def control_checks(ref, seed: int, pass_index: int, plan, scene, device,
                   dtype=torch.bfloat16, ordinal: int = 0) -> dict:
    """The control: the reference at ``dtype`` in the program's place on
    one pass of the replica at ``ordinal`` from the initial lanes,
    compared as ``run_checks`` compares the program."""
    lanes = ref.init_lanes(plan.lanes, device)
    expected = ref.run_pass(lanes, seed, pass_index, plan, scene,
                            ordinal=ordinal)
    low = ref.run_pass(ref.init_lanes(plan.lanes, device, dtype), seed,
                       pass_index, plan, scene, dtype, ordinal=ordinal)
    return compare(low, expected)
