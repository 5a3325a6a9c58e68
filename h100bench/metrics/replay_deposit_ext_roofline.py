"""replay_deposit_ext_roofline: the least time the df32 replay and deposit
could take on the card over the deposit layer's device time (the union of
its kernels' intervals, which overlap on the replay streams), in a render
whose replay is ``replay_deposit_ext``, in percent. Operations: every
replayed df32 orbit point (orbit_points) at costs_ext.json's replay_point.
Bytes: every kept escape's record read once, and a read and a write of a
bin (costs.json's bin_bytes) per on-canvas point, at most once a pass for
each bin of each card's canvas. Peaks from costs.json. None where the
window ran no ``replay_deposit_ext``."""

import json
from pathlib import Path

COSTS = Path(__file__).resolve().parents[1] / "costs_ext.json"
KERNEL = "replay_deposit_ext"


def read(m):
    if m.trace is None or not any(KERNEL in k for k in m.trace.op_s):
        return None
    t = m.trace.layer_s.get("deposit", 0.0)
    if t <= 0:
        return None
    c = json.loads(COSTS.read_text())
    peaks, st, g = m.costs["peaks"], m.stats, m.geometry
    ops = st["orbit_points"] * c["replay_point"]["ops"]
    bins = min(st["on_canvas_points"], m.passes * m.replicas * g["pixels"])
    nbytes = (st["emitted"] * c["emission_bytes"]
              + bins * m.costs["bin_bytes"])
    least = max(ops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * least / t
