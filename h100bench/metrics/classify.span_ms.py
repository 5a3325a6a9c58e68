"""classify.span_ms: device milliseconds a pass and card of the renderer's
``cb.classify`` span, the classify kernel on the main stream: the time
between the span's two events (``stats["trace"]``, in a traced run),
summed over the window and its cards, over its passes and cards."""


def read(m):
    tr = m.stats.get("trace")
    s = tr["spans"].get("cb.classify") if tr else None
    if not s or "device_ms" not in s or m.passes <= 0:
        return None
    return s["device_ms"] / (m.passes * m.replicas)
