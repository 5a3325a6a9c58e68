"""classify_ext_roofline: the least time the df32 classify work could take
on the card over the df32 classify kernel's device time (the classify
layer's, in a render whose classify kernel is ``classify_ext_kernel``), in
percent. The work is what the window's inputs need: its useful df32
escape-time steps (classify_iters; wasted lane-steps do not count) at
costs_ext.json's escape_step operations, and its samples drawn at
sample_draw; its bytes, each lane's df32 state read and written once a
pass and each emission slot written once, on every card. Peaks from
costs.json. None where the window ran no ``classify_ext_kernel``."""

import json
from pathlib import Path

COSTS = Path(__file__).resolve().parents[1] / "costs_ext.json"
KERNEL = "classify_ext_kernel"


def read(m):
    if m.trace is None or not any(KERNEL in k for k in m.trace.op_s):
        return None
    t = m.trace.layer_s.get("classify", 0.0)
    if t <= 0:
        return None
    c = json.loads(COSTS.read_text())
    peaks, st, g = m.costs["peaks"], m.stats, m.geometry
    ops = (st["classify_iters"] * c["escape_step"]["ops"]
           + st["samples"] * c["sample_draw"]["ops"])
    nbytes = m.passes * m.replicas * (g["lanes"] * c["lane_bytes"]
                                      + g["emission_slots"] * c["slot_bytes"])
    least = max(ops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * least / t
