"""engine.pass_ms: the traced window's elapsed time over its passes, in
milliseconds (every pass and all the time between them)."""


def read(m):
    if m.trace is None or m.passes <= 0:
        return None
    return 1e3 * m.elapsed_s / m.passes
