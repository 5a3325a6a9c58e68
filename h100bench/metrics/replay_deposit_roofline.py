"""replay_deposit_roofline: the least time the replay and deposit could
take on the card over the deposit kernels' device time (the union of their
intervals, which overlap on the replay streams), in percent. Operations:
every replayed orbit point (orbit_points) at costs.json's replay_point.
Bytes: every kept escape's record read once, and a read and a write of a
bin per on-canvas point, at most once a pass for each bin of each card's
canvas (never the whole histogram). Over several cards the time is the
sum of the cards' times, so the share is that of one card."""


def read(m):
    if m.trace is None:
        return None
    t = m.trace.layer_s.get("deposit", 0.0)
    if t <= 0:
        return None
    c, st, g = m.costs, m.stats, m.geometry
    ops = st["orbit_points"] * c["replay_point"]["ops"]
    bins = min(st["on_canvas_points"], m.passes * m.replicas * g["pixels"])
    nbytes = st["emitted"] * c["emission_bytes"] + bins * c["bin_bytes"]
    least = max(ops / c["peaks"]["flops_per_s"],
                nbytes / c["peaks"]["bytes_per_s"])
    return 100.0 * least / t
