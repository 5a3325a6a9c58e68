"""compact.ms_per_pass: device milliseconds a pass of the compaction layer
(PyTorch's own kernels, the sorts, gathers, sums and memsets, and the
selection stream's threefry_bits), the union of their intervals in the
traced window."""


def read(m):
    if m.trace is None or m.passes <= 0:
        return None
    s = m.trace.layer_s.get("compaction", 0.0)
    return 1e3 * s / m.passes if s > 0 else None
