"""compact.ms_per_pass: device milliseconds a pass and card of the
compaction layer (PyTorch's own kernels, the sorts, gathers, sums and
memsets, and the selection stream's threefry_bits), the union of their
intervals on each card in the traced window, summed over the cards."""


def read(m):
    if m.trace is None or m.passes <= 0:
        return None
    s = m.trace.layer_s.get("compaction", 0.0)
    return 1e3 * s / (m.passes * m.replicas) if s > 0 else None
