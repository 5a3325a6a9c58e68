"""classify_mh_roofline: the least time the float32 Metropolis-Hastings
chain work could take on the card over the classify layer's device time
(in a render whose classify kernel is ``classify_mh_kernel``), in
percent. The work is what the window's inputs need: its useful proposal
orbit steps (classify_iters; a dead proposal's window and an escaped
one's steps past its escape do not count) at costs_mh_f32.json's
chain_step operations, and its finished proposals (samples) at proposal;
its bytes, each lane's chain state and both sets of visit bins read and
written once a pass and each emission slot written once, on every card.
Peaks from costs.json. None where the window ran no
``classify_mh_kernel``, or where the render's trace counts no float32
MH pass (``mh_f32_passes``)."""

import json
from pathlib import Path

COSTS = Path(__file__).resolve().parents[1] / "costs_mh_f32.json"
KERNEL = "classify_mh_kernel"


def read(m):
    if m.trace is None or not any(KERNEL in k for k in m.trace.op_s):
        return None
    if not m.stats.get("trace", {}).get("mh_f32_passes"):
        return None
    t = m.trace.layer_s.get("classify", 0.0)
    if t <= 0:
        return None
    c = json.loads(COSTS.read_text())
    peaks, st, g = m.costs["peaks"], m.stats, m.geometry
    ops = (st["classify_iters"] * c["chain_step"]["ops"]
           + st["samples"] * c["proposal"]["ops"])
    nbytes = m.passes * m.replicas * (g["lanes"] * c["lane_bytes"]
                                      + g["emission_slots"] * c["slot_bytes"])
    least = max(ops / peaks["flops_per_s"], nbytes / peaks["bytes_per_s"])
    return 100.0 * least / t
