"""classify_roofline: the least time the classify work could take on the
card over the classify kernels' device time, in percent. The work is what
the window's inputs need: its useful escape-time steps (classify_iters;
wasted lane-steps do not count) at costs.json's escape_step operations,
and its samples drawn at sample_draw; its bytes, each lane's state read
and written once a pass and each emission slot written once, on every
card. Over several cards the time is the sum of the cards' times, so
the share is that of one card."""


def read(m):
    if m.trace is None:
        return None
    t = m.trace.layer_s.get("classify", 0.0)
    if t <= 0:
        return None
    c, st, g = m.costs, m.stats, m.geometry
    ops = (st["classify_iters"] * c["escape_step"]["ops"]
           + st["samples"] * c["sample_draw"]["ops"])
    nbytes = m.passes * m.replicas * (g["lanes"] * c["lane_bytes"]
                                      + g["emission_slots"] * c["slot_bytes"])
    least = max(ops / c["peaks"]["flops_per_s"],
                nbytes / c["peaks"]["bytes_per_s"])
    return 100.0 * least / t
