"""device.idle_share: the share of the traced window in which no operation
ran on the device (1 - the union of device intervals / the window); over
several cards, the mean of each card's share."""


def read(m):
    if m.trace is None or m.trace.busy_s <= 0:
        return None
    return 1.0 - m.trace.busy_s / m.trace.window_s
