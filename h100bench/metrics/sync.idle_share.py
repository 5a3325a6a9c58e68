"""sync.idle_share: the renderer's sync bubbles over the window: device
idle from the drain before each group's synchronize to the next group's
first pass, timed by the program's events (``stats["trace"]``), over the
render's elapsed seconds. The drain is marked on the engine's device, so
over several cards this is the first card's share."""


def read(m):
    tr = m.stats.get("trace")
    if not tr or tr["sync_bubbles"] <= 0 or m.elapsed_s <= 0:
        return None
    return tr["sync_bubble_ms"] / 1e3 / m.elapsed_s
