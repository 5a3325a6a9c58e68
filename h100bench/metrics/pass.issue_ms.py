"""pass.issue_ms: host milliseconds a pass inside the renderer's
``cb.pass`` span, the issuing thread's time to enqueue one pass (the
program's span record, ``stats["trace"]``, in a traced run)."""


def read(m):
    tr = m.stats.get("trace")
    s = tr["spans"].get("cb.pass") if tr else None
    if not s or s["count"] <= 0:
        return None
    return s["host_ms"] / s["count"]
