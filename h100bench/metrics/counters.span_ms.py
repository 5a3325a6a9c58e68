"""counters.span_ms: device milliseconds a pass and card of the renderer's
``cb.counters`` span, the counters' bookkeeping on the main stream (the
sum of the classify stat rows, the counter adds): the time between the
span's two events (``stats["trace"]``, in a traced run), summed over the
window and its cards, over its passes and cards."""


def read(m):
    tr = m.stats.get("trace")
    s = tr["spans"].get("cb.counters") if tr else None
    if not s or "device_ms" not in s or m.passes <= 0:
        return None
    return s["device_ms"] / (m.passes * m.replicas)
