"""replica.issue_ms: host milliseconds a pass inside the renderer's
``cb.replica`` spans, one a card of a data-parallel render: the one
issuing thread's time to enqueue every card's pass (the program's span
record, ``stats["trace"]``, in a traced run). Where it nears
``engine.pass_ms``, the issuing thread sets the pace."""


def read(m):
    tr = m.stats.get("trace")
    s = tr["spans"].get("cb.replica") if tr else None
    if not s or s["count"] <= 0:
        return None
    return s["host_ms"] * m.replicas / s["count"]
