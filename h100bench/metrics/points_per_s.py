"""points_per_s: orbit points deposited on the canvas in the window (the
sum of the histogram the render returns) over the render's own elapsed
time, from its first pass to its final synchronize."""


def read(m):
    if m.elapsed_s <= 0:
        return None
    return m.hist_sum / m.elapsed_s
