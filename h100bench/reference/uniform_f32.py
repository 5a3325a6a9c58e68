"""Plain reference of one render pass: uniform sampling, float32 orbits.

What a pass of the Buddhabrot renderer has to produce, written from the
algorithm in plain PyTorch and NumPy, one elementwise operation per
arithmetic operation (so every product and sum is rounded once, as the
reference's CUDA code rounds it without fused multiply-adds):

1. Classify. Every lane holds a sample c and its orbit z <- z^2 + c. The
   lanes advance in windows of ``unroll`` steps; at each window's end a
   lane whose orbit escaped (|z|^2 > 4), met its Brent checkpoint (a
   cycle), reached the cap or was culled (main cardioid, period-2 bulb)
   draws its next sample from Threefry-2x32 keyed by the pass, at counter
   (lane, window). An escape whose index lies in the band [min, max) is
   recorded in the lane's slot of the current flush window (a later one
   in the same window replaces it).
2. Select. At most ``capacity`` of the pass's recorded escapes are kept:
   all of them when they fit, else those with the smallest (random key,
   slot) from the pass's selection stream.
3. Replay and deposit. Each kept escape's orbit z_1 .. z_{it+1} (z_0 = c)
   is replayed; every point on the canvas adds one to its bin (column and
   row truncated from (z - min) / pitch).

The counters of a pass are those of the renderer's statistics: samples
drawn, culled, in band, cycles, wasted lane-steps, useful lane-steps,
kept and dropped escapes, replayed orbit points and points on the canvas.

The execution plan (lanes, steps a pass, flush window, unroll, capacity)
is the renderer's choice, and a pass's answer depends on it as a Monte
Carlo run depends on how its draws are assigned, so the reference takes
it as given (``Plan``, read from the engine by ``plan_of``). Everything
else it works out from the cell's files, the seed and the device's RNG
ordinal. ``dtype`` is float32; the control runs the same reference in
bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from reference import threefry

#: First Brent checkpoint, doubled at every save; a never-matching point.
SAVE0 = 16
BIG = 1.0e30
#: Fold-in word of a pass's selection stream.
SELECT_FOLD = 0x7711
#: Draw windows whose Threefry words are computed in one go.
DRAW_BLOCK = 32
#: Kept batches up to this many escapes replay on the host (NumPy); larger
#: ones on the device. The two give the same bins.
HOST_REPLAY_MAX = 1 << 16

LANE_FIELDS = ("cr", "ci", "zr", "zi", "sr", "si", "it", "sv", "dead", "vis")


@dataclasses.dataclass(frozen=True)
class Plan:
    lanes: int
    steps_per_pass: int  # per lane
    steps_per_flush: int
    unroll: int
    capacity: int


@dataclasses.dataclass(frozen=True)
class Scene:
    """The cell's canvas, band and sample domain, from its files."""

    width: int
    height: int
    min_real: float
    max_real: float
    min_imag: float
    max_imag: float
    min_it: int
    max_it: int
    domain: tuple = (-2.0, 2.0, -2.0, 2.0)

    @classmethod
    def from_cell(cls, canvas: dict, band: dict) -> "Scene":
        return cls(width=int(canvas["width"]), height=int(canvas["height"]),
                   min_real=float(canvas["min_real"]),
                   max_real=float(canvas["max_real"]),
                   min_imag=float(canvas["min_imag"]),
                   max_imag=float(canvas["max_imag"]),
                   min_it=int(band["min_escape"]),
                   max_it=int(band["max_escape"]))

    @property
    def pixels(self) -> int:
        return self.width * self.height


#: Engines whose pass this module does not model: the host replay's
#: batches are replayed off the device, and the row shards split each
#: replica's histogram.
REFUSED_ENGINES = ("DataParallelHostReplayEngine", "ShardedHistogramEngine")


def plan_of(engine) -> Plan:
    """The execution plan of ``engine``: a single-device engine, or the
    first inner engine of a data-parallel one (its inners share the
    configuration and the plan). Refuses an engine whose pass this
    reference does not model."""
    name = type(engine).__name__
    if name in REFUSED_ENGINES:
        raise ValueError(f"the uniform float32 reference does not model "
                         f"the {name}'s passes")
    inner = getattr(engine, "inners", [engine])[0]
    tn = inner.tuning
    o = inner.cfg.options
    if (inner.extended or inner.mh or not tn.thin_tracking
            or not o.cycle_detection or inner.cfg.fractal != "buddhabrot"
            or inner.visit_window is not None):
        raise ValueError("the uniform float32 reference models thin-"
                         "tracked Buddhabrot passes with cycle detection")
    return Plan(lanes=inner.lanes, steps_per_pass=tn.steps_per_pass,
                steps_per_flush=tn.steps_per_flush, unroll=tn.inner_unroll,
                capacity=tn.replay_capacity)


def init_lanes(n: int, device, dtype=torch.float32) -> dict:
    """Every lane starts dead: its first window draws."""
    def f(v):
        return torch.full((n,), v, dtype=dtype, device=device)

    def i(v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    return dict(cr=f(0.0), ci=f(0.0), zr=f(0.0), zi=f(0.0), sr=f(BIG),
                si=f(BIG), it=i(0), sv=i(SAVE0), dead=i(1), vis=i(0))


def _const(v: float, dtype, device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


def _draws(k0, k1, lane_id, counters, c: dict):
    """Samples for (window, lane): the top 24 bits of each Threefry word
    times 2^-24, times the domain's span, plus its minimum; and whether
    each lies in the main cardioid or the period-2 bulb."""
    w_r, w_i = threefry.threefry2x32(k0, k1, lane_id[None, :],
                                     counters[:, None])
    cr, ci = ((w >> 8).to(torch.int32).to(c["dtype"]) * c["ulp24"] * span
              + lo for w, lo, span in ((w_r, c["r0"], c["r_span"]),
                                       (w_i, c["i0"], c["i_span"])))
    ci2 = ci * ci
    q = cr - 0.25
    q = q * q + ci2
    cardioid = q * (q + (cr - 0.25)) < ci2 * 0.25
    t = cr + 1.0
    bulb = t * t + ci * ci < (1.0 / 16.0)
    return cr, ci, cardioid | bulb


def _windows(s: dict, c: dict, lane_id, k0: int, k1: int, nb: int,
             u: int, scene: Scene) -> None:
    """``nb`` windows of every lane from the window counter ``s["ctr"]``,
    updating the tensors of ``s`` in place (so that a CUDA graph can
    capture it)."""
    i32 = torch.int32
    ctr = s["ctr"] + torch.arange(nb, dtype=torch.int64,
                                  device=lane_id.device)
    d_r, d_i, d_cull = _draws(k0, k1, lane_id, ctr, c)
    cr, ci, zr, zi, sr, si, it, sv, dead, p_r, p_i, p_it = (
        s[k] for k in ("cr", "ci", "zr", "zi", "sr", "si", "it", "sv",
                       "dead", "p_r", "p_i", "p_it"))
    for j in range(nb):
        ar, ai = zr, zi
        r2, i2 = ar * ar, ai * ai
        nesc = torch.zeros_like(it)
        for _ in range(u):
            nr = r2 - i2 + cr
            ni = 2.0 * ar * ai + ci
            ar, ai = nr, ni
            r2, i2 = ar * ar, ai * ai
            nesc += (r2 + i2 <= c["four"]).to(i32)
        esc = nesc < u
        needed = it + nesc
        cyc = (ar == sr) & (ai == si) & ~esc
        it_new = it + u
        live = dead == 0
        fin = esc | cyc | (it_new >= scene.max_it) | ~live
        band = (esc & live & (needed >= scene.min_it)
                & (needed < scene.max_it))
        p_r = torch.where(band, cr, p_r)
        p_i = torch.where(band, ci, p_i)
        p_it = torch.where(band, needed, p_it)
        save = (it_new >= sv) & ~fin
        n_r, n_i, n_cull = d_r[j], d_i[j], d_cull[j]
        s["drawn"] += fin.to(i32)
        s["culled"] += (fin & n_cull).to(i32)
        s["in_band"] += band.to(i32)
        s["cycles"] += (cyc & live).to(i32)
        s["wasted"] += torch.where(live, torch.where(
            esc, it_new - needed - 1, 0), u).to(i32)
        sr = torch.where(fin, c["big"], torch.where(save, ar, sr))
        si = torch.where(fin, c["big"], torch.where(save, ai, si))
        sv = torch.where(fin, SAVE0, torch.where(save, sv * 2, sv)).to(i32)
        cr = torch.where(fin, n_r, cr)
        ci = torch.where(fin, n_i, ci)
        zr = torch.where(fin, n_r, ar)
        zi = torch.where(fin, n_i, ai)
        it = torch.where(fin, 0, it_new).to(i32)
        dead = torch.where(fin, n_cull.to(i32), dead)
    for k, v in (("cr", cr), ("ci", ci), ("zr", zr), ("zi", zi),
                 ("sr", sr), ("si", si), ("it", it), ("sv", sv),
                 ("dead", dead), ("p_r", p_r), ("p_i", p_i),
                 ("p_it", p_it)):
        s[k].copy_(v)


def classify(lanes: dict, k0: int, k1: int, plan: Plan, scene: Scene,
             dtype=torch.float32):
    """One pass of classify from ``lanes`` (not changed). Returns the lanes
    after it, the recorded escapes (c_r, c_i, index; index -1 where a slot
    holds none), each (flush windows, lanes) in slot order, and the pass's
    per-lane counts summed.

    The windows run in blocks of ``DRAW_BLOCK``, whose draws are computed
    at once. On a card each block is one CUDA graph of the same plain
    operations (captured once a pass, replayed for every block), which
    spares the host a launch per operation; on the CPU it runs as it
    stands."""
    s = {f: lanes[f].clone() for f in LANE_FIELDS}
    dev, n = s["cr"].device, s["cr"].numel()
    u = plan.unroll
    chunks = plan.steps_per_pass // plan.steps_per_flush
    windows = plan.steps_per_flush // u
    r0, r1, i0, i1 = scene.domain
    c = dict(dtype=dtype, four=_const(4.0, dtype, dev),
             big=_const(BIG, dtype, dev), ulp24=_const(2.0 ** -24, dtype, dev),
             r0=_const(r0, dtype, dev), r_span=_const(r1 - r0, dtype, dev),
             i0=_const(i0, dtype, dev), i_span=_const(i1 - i0, dtype, dev))
    lane_id = torch.arange(n, dtype=torch.int64, device=dev)
    for k in ("drawn", "culled", "in_band", "cycles", "wasted"):
        s[k] = torch.zeros(n, dtype=torch.int32, device=dev)
    s.update(p_r=torch.zeros(n, dtype=dtype, device=dev),
             p_i=torch.zeros(n, dtype=dtype, device=dev),
             p_it=torch.full((n,), -1, dtype=torch.int32, device=dev),
             ctr=torch.zeros((), dtype=torch.int64, device=dev))
    emit_r = torch.empty((chunks, n), dtype=dtype, device=dev)
    emit_i = torch.empty_like(emit_r)
    emit_it = torch.empty((chunks, n), dtype=torch.int32, device=dev)
    graphs = {}
    for chunk in range(chunks):
        s["p_r"].zero_()
        s["p_i"].zero_()
        s["p_it"].fill_(-1)
        for w0 in range(0, windows, DRAW_BLOCK):
            nb = min(DRAW_BLOCK, windows - w0)
            s["ctr"].fill_(chunk * windows + w0)
            if dev.type != "cuda":
                _windows(s, c, lane_id, k0, k1, nb, u, scene)
                continue
            if nb not in graphs:
                graphs[nb] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[nb]):
                    _windows(s, c, lane_id, k0, k1, nb, u, scene)
            graphs[nb].replay()
        emit_r[chunk].copy_(s["p_r"])
        emit_i[chunk].copy_(s["p_i"])
        emit_it[chunk].copy_(s["p_it"])
    after = {f: s[f] for f in LANE_FIELDS}
    w_total = int(s["wasted"].sum(dtype=torch.int64))
    counts = {k: int(s[k].sum(dtype=torch.int64))
              for k in ("culled", "in_band", "cycles")}
    counts.update(samples=int(s["drawn"].sum(dtype=torch.int64)),
                  wasted=w_total,
                  iters=plan.steps_per_pass * n - w_total)
    return after, (emit_r, emit_i, emit_it), counts


def select(emissions, pass_key: tuple[int, int], plan: Plan, max_it: int):
    """The kept escapes (c_r, c_i, index) and (kept, dropped): every one
    when they fit the capacity, else the ``capacity`` with the smallest
    (key, slot), the key taken from the pass's selection stream (its top
    31 bits, or 11 bits, capped at 2046, where the slots fit 21 bits and
    the cap 10)."""
    e_r, e_i, e_it = (t.reshape(-1) for t in emissions)
    valid = e_it >= 0
    n_valid = int(valid.sum())
    kept = min(n_valid, plan.capacity)
    if n_valid <= plan.capacity:
        idx = torch.nonzero(valid).reshape(-1)
    else:
        nslots = e_it.numel()
        words = threefry.bits(threefry.fold_in(pass_key, SELECT_FOLD),
                              nslots, e_it.device)
        if nslots <= (1 << 21) and max_it + 1 < 1024:
            k = torch.clamp(words >> 21, max=2046)
        else:
            k = words >> 1
        slot = torch.arange(nslots, dtype=torch.int64, device=e_it.device)
        order = torch.where(valid, (k << 24) | slot, (1 << 56) | slot)
        idx = torch.sort(order).values[:plan.capacity] & ((1 << 24) - 1)
    return (e_r[idx], e_i[idx], e_it[idx]), (kept, n_valid - kept)


def _bins_torch(zr, zi, active, scene: Scene, dtype):
    dev = zr.device
    mr, mi = _const(scene.min_real, dtype, dev), _const(scene.min_imag,
                                                        dtype, dev)
    col = (zr - mr) / _const((scene.max_real - scene.min_real)
                             / float(scene.width), dtype, dev)
    row = (zi - mi) / _const((scene.max_imag - scene.min_imag)
                             / float(scene.height), dtype, dev)
    ok = (active & (zr >= mr) & (zi >= mi) & (col < scene.width)
          & (row < scene.height))
    flat = (torch.where(ok, row, 0.0).to(torch.int64) * scene.width
            + torch.where(ok, col, 0.0).to(torch.int64))
    return flat[ok]


def replay_torch(cr, ci, it, scene: Scene, dtype=torch.float32):
    """Deposits of the kept escapes, step by step over all of them at
    once. Returns (counts per bin as an int64 tensor, points on the
    canvas)."""
    dev = cr.device
    hist = torch.zeros(scene.pixels, dtype=torch.int64, device=dev)
    n_steps = int(it.max()) + 1 if it.numel() else 0
    # Longest first, so the ones still going are a prefix.
    order = torch.argsort(it, descending=True)
    cr, ci, it = cr[order], ci[order], it[order]
    zr, zi = cr, ci
    n = cr.numel()
    hits = 0
    for s in range(n_steps):
        while n > 0 and int(it[n - 1]) < s:
            n = int((it >= s).sum())
        cr, ci, it, zr, zi = cr[:n], ci[:n], it[:n], zr[:n], zi[:n]
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        ids = _bins_torch(zr, zi, torch.ones_like(it, dtype=torch.bool),
                          scene, dtype)
        hist += torch.bincount(ids, minlength=scene.pixels)
        hits += ids.numel()
    return hist, hits


def replay_numpy(cr, ci, it, scene: Scene, block: int = 256):
    """``replay_torch`` at float32 in NumPy on the host, for small kept
    batches of long orbits, where a device launch per operation would
    cost more than the work. The orbits advance a step at a time into a
    buffer of ``block`` steps, which is then binned at once (an orbit's
    points past its escape index are masked there)."""
    f32 = np.float32
    cr, ci = (np.asarray(t, dtype=f32) for t in (cr, ci))
    it = np.asarray(it, dtype=np.int64)
    order = np.argsort(-it, kind="stable")
    cr, ci, it = cr[order], ci[order], it[order]
    mr, mi = f32(scene.min_real), f32(scene.min_imag)
    dr = f32((scene.max_real - scene.min_real) / float(scene.width))
    di = f32((scene.max_imag - scene.min_imag) / float(scene.height))
    two = f32(2.0)
    n = cr.size
    n_steps = int(it.max()) + 1 if n else 0
    zr, zi = cr.copy(), ci.copy()
    a, b = np.empty_like(zr), np.empty_like(zr)
    buf_r = np.empty((block, n), dtype=f32)
    buf_i = np.empty((block, n), dtype=f32)
    chunks = []
    with np.errstate(all="ignore"):  # a finished orbit may overflow
        for s0 in range(0, n_steps, block):
            while n > 0 and it[n - 1] < s0:
                n -= 1
            k = min(block, n_steps - s0)
            xr, xi, ya, yb, vr, vi = (v[:n] for v in (zr, zi, a, b, cr, ci))
            for j in range(k):
                np.multiply(xr, xr, out=ya)
                np.multiply(xi, xi, out=yb)
                np.subtract(ya, yb, out=ya)
                np.add(ya, vr, out=ya)
                np.multiply(two, xr, out=yb)
                np.multiply(yb, xi, out=yb)
                np.add(yb, vi, out=yb)
                xr, ya = ya, xr
                xi, yb = yb, xi
                buf_r[j, :n] = xr
                buf_i[j, :n] = xi
            zr[:n], zi[:n] = xr, xi
            re, im = buf_r[:k, :n], buf_i[:k, :n]
            col = (re - mr) / dr
            row = (im - mi) / di
            live = it[None, :n] >= np.arange(s0, s0 + k)[:, None]
            ok = (live & (re >= mr) & (im >= mi) & (col < scene.width)
                  & (row < scene.height))
            chunks.append(row[ok].astype(np.int64) * scene.width
                          + col[ok].astype(np.int64))
    ids = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
    hist = np.bincount(ids, minlength=scene.pixels)
    return torch.from_numpy(hist), int(ids.size)


def run_pass(lanes: dict, seed: int, pass_index: int, plan: Plan,
             scene: Scene, dtype=torch.float32, ordinal: int = 0):
    """One whole pass of the device with RNG ordinal ``ordinal`` from
    ``lanes``: (lanes after, counts per bin on the host, counters). Both
    the samples and the selection are keyed by ``pass_key(seed, ordinal,
    pass_index)``, so each replica of a data-parallel render draws its
    own stream."""
    pk = threefry.pass_key(seed, ordinal, pass_index)
    k0, k1 = threefry.bits_host(pk, 2)
    after, emissions, counts = classify(lanes, k0, k1, plan, scene, dtype)
    (cr, ci, it), (kept, dropped) = select(emissions, pk, plan,
                                           scene.max_it)
    if dtype == torch.float32 and it.numel() <= HOST_REPLAY_MAX:
        hist, hits = replay_numpy(cr.cpu().numpy(), ci.cpu().numpy(),
                                  it.cpu().numpy(), scene)
    else:
        hist, hits = replay_torch(cr, ci, it, scene, dtype)
        hist = hist.cpu()
    counts.update(emitted=kept, replay_dropped=dropped,
                  points=int((it.to(torch.int64) + 1).sum()),
                  dev_hits=hits)
    return after, hist, counts
