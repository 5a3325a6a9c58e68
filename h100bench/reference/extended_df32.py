"""Plain reference of one render pass at extended precision: uniform
samples over a deep-zoom window, double-float (df32) orbits.

What a pass of the renderer's ``--precision extended`` path has to
produce, written from the algorithm in plain PyTorch, one elementwise
operation per arithmetic operation, so every float32 product and sum is
rounded once. A df32 number is a pair (hi, lo) of float32 with hi =
RN(hi + lo), about 48 bits of mantissa (Dekker's double-length
arithmetic; Hida, Li and Bailey's double-double algorithms, in float32):

  * two-sum: s = a + b, v = s - a, e = (a - (s - v)) + (b - v); then s + e
    == a + b exactly (Knuth);
  * fast two-sum, for |a| >= |b|: s = a + b, e = b - (s - a);
  * two-product: p = a * b and its error e = RN(a * b - p), the one fused
    multiply-add; here a * b - p is formed in float64, where the product
    of two float32 and its difference from p are exact, so the one
    rounding is the conversion back;
  * a + b: two-sum of the hi words, its error plus (a.lo + b.lo), then a
    fast two-sum; a * b: two-product of the hi words, its error plus
    (a.hi * b.lo + a.lo * b.hi), then a fast two-sum (a.lo * b.lo, below
    2^-48 relative, is dropped); a^2: the same with 2 * (a.hi * a.lo);
    negation flips both words' signs; doubling doubles both words.

One pass has three steps:

1. Classify. Every lane holds a sample c as a pair of 24-bit grid indices
   (kr, ki) over the sample window, the df32 c they give, and its df32
   orbit z <- z^2 + c: re z' = (re z^2 + (-im z^2)) + re c, im z' = 2 re z
   im z + im c, and |z'|^2 = re z'.hi^2 + im z'.hi^2 in float32. A grid
   index k gives the offset (k - 2^23) * step from the window's centre,
   step = RN32(span * 2^-24), and c = centre + offset in df32 (the centre
   split into hi and lo words). The lanes advance in windows of
   ``unroll`` steps; at each window's end a lane whose orbit escaped
   (|z|^2 > 4, or NaN), met its Brent checkpoint (hi words equal), reached
   the cap or was culled draws its next grid indices from Threefry-2x32
   keyed by the pass, at counter (lane, window): the top 24 bits of each
   word. The cull (main cardioid, period-2 bulb) reads the float32 c =
   centre.hi + offset. An escape whose index lies in the band [min, max)
   records the lane's grid indices in its slot of the current flush
   window (a later one in the same window replaces it).
2. Select. At most ``capacity`` of the pass's recorded escapes are kept,
   as ``uniform_f32.select`` keeps them.
3. Replay and deposit. Each kept escape's c is rebuilt from its grid
   indices as step 1 built it, and its orbit z_1 .. z_{it+1} (z_0 = c)
   replayed in df32. A point bins by its df32 offset from the canvas
   minimum: the hi word of (z + (-min)), times RN32(1 / pitch), truncated,
   on the canvas where both offsets are >= 0 and both products below the
   width and height.

The counters are those of ``uniform_f32``. The plan is the renderer's
(``plan_of``), the rest comes from the cell's files, the seed and the
RNG ordinal. ``dtype`` is ``DF32``; the control, ``torch.float32``, runs
plain float32 orbits in df32's place (re z' = re z re z - im z im z + re
c, im z' = 2 re z im z + im c, each operation rounded once) with every lo
word held at 0: c = centre.hi + offset, a point's offset z - min.hi.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from reference import threefry
from reference.uniform_f32 import BIG, DRAW_BLOCK, SAVE0, Plan, select

#: The ``dtype`` of the df32 reference (the default of ``run_pass``).
DF32 = "df32"
LANE_FIELDS = ("kr", "ki", "crh", "crl", "cih", "cil", "zr", "zrl", "zi",
               "zil", "sr", "si", "it", "sv", "dead", "vis")
_I32_FIELDS = ("it", "sv", "dead", "vis")
#: What ``_windows`` carries from one window to the next: the lanes but
#: ``vis`` (0 without an emit filter) and the flush window's record.
_CARRIED = LANE_FIELDS[:-1] + ("p_kr", "p_ki", "p_it")
TWO23 = 8388608.0
#: Replay steps one CUDA graph runs.
REPLAY_STEPS = 32
#: The fewest orbits a replay graph runs (the active ones a power of two
#: above this).
REPLAY_MIN_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class Scene:
    """The cell's canvas and band; the sample window is the canvas."""

    width: int
    height: int
    min_real: float
    max_real: float
    min_imag: float
    max_imag: float
    min_it: int
    max_it: int

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

    @property
    def domain(self) -> tuple:
        return (self.min_real, self.max_real, self.min_imag, self.max_imag)


def _refuse(what: str):
    raise ValueError(f"the extended df32 reference does not model {what}")


def plan_of(engine) -> Plan:
    """The execution plan of ``engine`` (a single-device engine, or the
    first inner engine of a data-parallel one). Refuses, by name, every
    pass this reference does not model."""
    name = type(engine).__name__
    if name == "DataParallelHostReplayEngine":
        _refuse(f"host replay (the {name}'s passes)")
    if name == "ShardedHistogramEngine":
        _refuse(f"row shards (the {name}'s passes)")
    inner = getattr(engine, "inners", [engine])[0]
    cfg = inner.cfg
    if not inner.extended:
        _refuse("float32 orbits (--precision float32)")
    if inner.mh:
        _refuse("the MH sampler (--sampler mh)")
    if inner.visit_window is not None:
        _refuse("the canvas emit filter (--emit-filter canvas)")
    if inner.replay_mode != "device":
        _refuse(f"host replay (--replay {inner.replay_mode})")
    cv = cfg.canvas
    if tuple(cfg.sample_domain) != (cv.min_real, cv.max_real, cv.min_imag,
                                    cv.max_imag):
        _refuse("a sample domain other than the canvas (--sample-domain)")
    if cfg.fractal != "buddhabrot" or not cfg.options.cycle_detection:
        _refuse("maps other than the Buddhabrot with cycle detection")
    tn = inner.tuning
    return Plan(lanes=inner.lanes, steps_per_pass=tn.steps_per_pass,
                steps_per_flush=tn.steps_per_flush, unroll=tn.inner_unroll,
                capacity=tn.replay_capacity)


def init_lanes(n: int, device, dtype=DF32) -> dict:
    """Every lane starts dead (its first window draws), every word 0 but
    the Brent registers'."""
    _arith(dtype)

    def f(v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    def i(v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    out = {k: (i(0) if k in _I32_FIELDS else f(0.0)) for k in LANE_FIELDS}
    out.update(sr=f(BIG), si=f(BIG), sv=i(SAVE0), dead=i(1))
    return out


# ----------------------------------------------------------------------
# df32 arithmetic, each operation rounded once.


def two_sum(a, b):
    s = a + b
    v = s - a
    return s, (a - (s - v)) + (b - v)


def fast_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    p = a * b
    return p, (a.double() * b.double() - p.double()).float()


def df_add(ah, al, bh, bl):
    s, e = two_sum(ah, bh)
    return fast_two_sum(s, e + (al + bl))


def df_mul(ah, al, bh, bl):
    p, e = two_prod(ah, bh)
    return fast_two_sum(p, e + (ah * bl + al * bh))


def df_sqr(ah, al):
    p, e = two_prod(ah, ah)
    return fast_two_sum(p, e + 2.0 * (ah * al))


class _DoubleFloat:
    """The df32 orbit, c and canvas offset."""

    @staticmethod
    def sample(ch, cl, off):
        s, e = two_sum(ch, off)
        return fast_two_sum(s, e + cl)

    @staticmethod
    def step(zr, zrl, zi, zil, cr, crl, ci, cil):
        r2, r2l = df_sqr(zr, zrl)
        i2, i2l = df_sqr(zi, zil)
        x, xl = df_mul(zr, zrl, zi, zil)
        nr, nrl = df_add(*df_add(r2, r2l, -i2, -i2l), cr, crl)
        ni, nil_ = df_add(x + x, xl + xl, ci, cil)
        return nr, nrl, ni, nil_, nr * nr + ni * ni

    @staticmethod
    def offset(h, l, neg_min):
        s, e = two_sum(h, neg_min[0])
        return s + (e + (l + neg_min[1]))


class _Float:
    """The control: float32 in df32's place, every lo word 0."""

    @staticmethod
    def sample(ch, cl, off):
        s = ch + off
        return s, torch.zeros_like(s)

    @staticmethod
    def step(zr, zrl, zi, zil, cr, crl, ci, cil):
        nr = zr * zr - zi * zi + cr
        ni = 2.0 * zr * zi + ci
        return nr, zrl, ni, zil, nr * nr + ni * ni

    @staticmethod
    def offset(h, l, neg_min):
        return h + neg_min[0]


def _arith(dtype):
    if dtype == DF32:
        return _DoubleFloat
    if dtype == torch.float32:
        return _Float
    raise ValueError(f"dtype {dtype!r}: the reference runs df32 or, as the "
                     "control, float32")


def _split(x: float) -> tuple[float, float]:
    """A float64 as df32 words: hi = RN32(x), lo = RN32(x - hi)."""
    hi = float(np.float32(x))
    return hi, float(np.float32(x - hi))


def _consts(scene: Scene, device) -> dict:
    """The window's centres and grid pitches, the canvas minimum (negated)
    and inverse pitches, as 0-dim float32 tensors."""
    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    r0, r1, i0, i1 = scene.domain
    nmr, nmi = (_split(v) for v in (scene.min_real, scene.min_imag))
    d_re = (scene.max_real - scene.min_real) / float(scene.width)
    d_im = (scene.max_imag - scene.min_imag) / float(scene.height)
    return dict(
        c_r=tuple(t(v) for v in _split((r0 + r1) / 2.0)),
        c_i=tuple(t(v) for v in _split((i0 + i1) / 2.0)),
        step_r=t(float(np.float32((r1 - r0) * 2.0 ** -24))),
        step_i=t(float(np.float32((i1 - i0) * 2.0 ** -24))),
        nmr=(t(-nmr[0]), t(-nmr[1])), nmi=(t(-nmi[0]), t(-nmi[1])),
        inv_r=t(float(np.float32(1.0 / d_re))),
        inv_i=t(float(np.float32(1.0 / d_im))),
        four=t(4.0), big=t(BIG), two23=t(TWO23))


def _grid_c(k, centre, step, c: dict, arith):
    """(hi, lo, float32 c) of grid indices ``k`` on one axis."""
    off = (k - c["two23"]) * step
    hi, lo = arith.sample(centre[0], centre[1], off)
    return hi, lo, centre[0] + off


def _draws(k0, k1, lane_id, counters, c: dict, arith):
    """Grid indices, df32 c and cull of every (window, lane)."""
    w_r, w_i = threefry.threefry2x32(k0, k1, lane_id[None, :],
                                     counters[:, None])
    kr, ki = ((w >> 8).to(torch.int32).to(torch.float32) for w in (w_r, w_i))
    crh, crl, fr = _grid_c(kr, c["c_r"], c["step_r"], c, arith)
    cih, cil, fi = _grid_c(ki, c["c_i"], c["step_i"], c, arith)
    ci2 = fi * fi
    q = fr - 0.25
    q = q * q + ci2
    cardioid = q * (q + (fr - 0.25)) < ci2 * 0.25
    t = fr + 1.0
    bulb = t * t + fi * fi < (1.0 / 16.0)
    return kr, ki, crh, crl, cih, cil, cardioid | bulb


def _windows(s: dict, c: dict, lane_id, k0: int, k1: int, nb: int, u: int,
             scene: Scene, arith) -> None:
    """``nb`` windows of every lane from the window counter ``s["ctr"]``,
    updating the tensors of ``s`` in place (so that a CUDA graph can
    capture it)."""
    i32 = torch.int32
    ctr = s["ctr"] + torch.arange(nb, dtype=torch.int64,
                                  device=lane_id.device)
    d_kr, d_ki, d_crh, d_crl, d_cih, d_cil, d_cull = _draws(
        k0, k1, lane_id, ctr, c, arith)
    (kr, ki, crh, crl, cih, cil, zr, zrl, zi, zil, sr, si, it, sv, dead,
     p_kr, p_ki, p_it) = (s[k] for k in _CARRIED)
    for j in range(nb):
        ar, arl, ai, ail = zr, zrl, zi, zil
        nesc = torch.zeros_like(it)
        for _ in range(u):
            ar, arl, ai, ail, mag2 = arith.step(ar, arl, ai, ail, crh, crl,
                                                cih, cil)
            nesc += (mag2 <= c["four"]).to(i32)
        esc = nesc < u
        needed = it + nesc
        cyc = (ar == sr) & (ai == si) & ~esc
        it_new = it + u
        live = dead == 0
        fin = esc | cyc | (it_new >= scene.max_it) | ~live
        band = (esc & live & (needed >= scene.min_it)
                & (needed < scene.max_it))
        p_kr = torch.where(band, kr, p_kr)
        p_ki = torch.where(band, ki, p_ki)
        p_it = torch.where(band, needed, p_it)
        save = (it_new >= sv) & ~fin
        n_cull = d_cull[j]
        s["drawn"] += fin.to(i32)
        s["culled"] += (fin & n_cull).to(i32)
        s["in_band"] += band.to(i32)
        s["cycles"] += (cyc & live).to(i32)
        s["wasted"] += torch.where(live, torch.where(
            esc, it_new - needed - 1, 0), u).to(i32)
        sr = torch.where(fin, c["big"], torch.where(save, ar, sr))
        si = torch.where(fin, c["big"], torch.where(save, ai, si))
        sv = torch.where(fin, SAVE0, torch.where(save, sv * 2, sv)).to(i32)
        kr = torch.where(fin, d_kr[j], kr)
        ki = torch.where(fin, d_ki[j], ki)
        crh = torch.where(fin, d_crh[j], crh)
        crl = torch.where(fin, d_crl[j], crl)
        cih = torch.where(fin, d_cih[j], cih)
        cil = torch.where(fin, d_cil[j], cil)
        zr = torch.where(fin, d_crh[j], ar)
        zrl = torch.where(fin, d_crl[j], arl)
        zi = torch.where(fin, d_cih[j], ai)
        zil = torch.where(fin, d_cil[j], ail)
        it = torch.where(fin, 0, it_new).to(i32)
        dead = torch.where(fin, n_cull.to(i32), dead)
    for k, v in zip(_CARRIED, (kr, ki, crh, crl, cih, cil, zr, zrl, zi,
                               zil, sr, si, it, sv, dead, p_kr, p_ki, p_it)):
        s[k].copy_(v)


def classify(lanes: dict, k0: int, k1: int, plan: Plan, scene: Scene,
             dtype=DF32):
    """One pass of classify from ``lanes`` (not changed). Returns the lanes
    after it, the recorded escapes (kr, ki, index; index -1 where a slot
    holds none), each (flush windows, lanes) in slot order, and the pass's
    per-lane counts summed. The windows run in blocks of ``DRAW_BLOCK``,
    each one CUDA graph on a card, as ``uniform_f32.classify`` runs them."""
    arith = _arith(dtype)
    s = {f: lanes[f].clone() for f in LANE_FIELDS}
    dev, n = s["kr"].device, s["kr"].numel()
    u = plan.unroll
    chunks = plan.steps_per_pass // plan.steps_per_flush
    windows = plan.steps_per_flush // u
    c = _consts(scene, dev)
    lane_id = torch.arange(n, dtype=torch.int64, device=dev)
    for k in ("drawn", "culled", "in_band", "cycles", "wasted"):
        s[k] = torch.zeros(n, dtype=torch.int32, device=dev)
    s.update(p_kr=torch.zeros(n, dtype=torch.float32, device=dev),
             p_ki=torch.zeros(n, dtype=torch.float32, device=dev),
             p_it=torch.full((n,), -1, dtype=torch.int32, device=dev),
             ctr=torch.zeros((), dtype=torch.int64, device=dev))
    emit_r = torch.empty((chunks, n), dtype=torch.float32, device=dev)
    emit_i = torch.empty_like(emit_r)
    emit_it = torch.empty((chunks, n), dtype=torch.int32, device=dev)
    graphs = {}
    for chunk in range(chunks):
        s["p_kr"].zero_()
        s["p_ki"].zero_()
        s["p_it"].fill_(-1)
        for w0 in range(0, windows, DRAW_BLOCK):
            nb = min(DRAW_BLOCK, windows - w0)
            s["ctr"].fill_(chunk * windows + w0)
            if dev.type != "cuda":
                _windows(s, c, lane_id, k0, k1, nb, u, scene, arith)
                continue
            if nb not in graphs:
                graphs[nb] = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graphs[nb]):
                    _windows(s, c, lane_id, k0, k1, nb, u, scene, arith)
            graphs[nb].replay()
        emit_r[chunk].copy_(s["p_kr"])
        emit_i[chunk].copy_(s["p_ki"])
        emit_it[chunk].copy_(s["p_it"])
    after = {f: s[f] for f in LANE_FIELDS}
    w_total = int(s["wasted"].sum(dtype=torch.int64))
    counts = {k: int(s[k].sum(dtype=torch.int64))
              for k in ("culled", "in_band", "cycles")}
    counts.update(samples=int(s["drawn"].sum(dtype=torch.int64)),
                  wasted=w_total,
                  iters=plan.steps_per_pass * n - w_total)
    return after, (emit_r, emit_i, emit_it), counts


def _replay_steps(z: dict, cz: tuple, it, s0, hist, ones, m: int,
                  c: dict, scene: Scene, arith) -> None:
    """``REPLAY_STEPS`` steps, from step ``s0`` (a 0-dim tensor), of the
    first ``m`` orbits: each point still inside its orbit and on the
    canvas adds one to its bin of ``hist`` (the last bin takes the rest),
    in place."""
    zr, zrl, zi, zil = (z[k][:m] for k in ("zr", "zrl", "zi", "zil"))
    cr, crl, ci, cil = (t[:m] for t in cz)
    it, ones = it[:m], ones[:m]
    for j in range(REPLAY_STEPS):
        zr, zrl, zi, zil, _ = arith.step(zr, zrl, zi, zil, cr, crl, ci, cil)
        dx = arith.offset(zr, zrl, c["nmr"])
        dy = arith.offset(zi, zil, c["nmi"])
        col = dx * c["inv_r"]
        row = dy * c["inv_i"]
        ok = ((it >= s0 + j) & (dx >= 0.0) & (dy >= 0.0)
              & (col < scene.width) & (row < scene.height))
        ids = (torch.where(ok, row, 0.0).to(torch.int64) * scene.width
               + torch.where(ok, col, 0.0).to(torch.int64))
        hist.index_add_(0, torch.where(ok, ids, scene.pixels), ones)
    for k, v in (("zr", zr), ("zrl", zrl), ("zi", zi), ("zil", zil)):
        z[k][:m].copy_(v)


def replay(kr, ki, it, scene: Scene, dtype=DF32):
    """Deposits of the kept escapes (grid indices and escape indices), all
    of them step by step. Returns (counts per bin as an int64 tensor on
    the host, points on the canvas). On a card, ``REPLAY_STEPS`` steps of
    the orbits still going (the longest first, padded to a power of two)
    run as one CUDA graph."""
    arith = _arith(dtype)
    dev = kr.device
    hist = torch.zeros(scene.pixels + 1, dtype=torch.int64, device=dev)
    n = it.numel()
    if n == 0:
        return hist[:-1].cpu(), 0
    order = torch.argsort(it, descending=True)
    kr, ki, it = kr[order], ki[order], it[order]
    lens = [-int(v) for v in it.cpu().tolist()]  # ascending
    c = _consts(scene, dev)
    crh, crl, _ = _grid_c(kr, c["c_r"], c["step_r"], c, arith)
    cih, cil, _ = _grid_c(ki, c["c_i"], c["step_i"], c, arith)
    z = dict(zr=crh.clone(), zrl=crl.clone(), zi=cih.clone(),
             zil=cil.clone())
    cz = (crh, crl, cih, cil)
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    s0 = torch.zeros((), dtype=torch.int32, device=dev)
    graphs = {}
    for step0 in range(0, 1 - lens[0], REPLAY_STEPS):
        going = bisect.bisect_right(lens, -step0)
        m = min(n, max(REPLAY_MIN_ROWS, 1 << (going - 1).bit_length()))
        s0.fill_(step0)
        if dev.type != "cuda":
            _replay_steps(z, cz, it, s0, hist, ones, m, c, scene, arith)
            continue
        if m not in graphs:
            graphs[m] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[m]):
                _replay_steps(z, cz, it, s0, hist, ones, m, c, scene, arith)
        graphs[m].replay()
    hist = hist[:-1]
    return hist.cpu(), int(hist.sum())


def run_pass(lanes: dict, seed: int, pass_index: int, plan: Plan,
             scene: Scene, dtype=DF32, ordinal: int = 0):
    """One whole pass of the device with RNG ordinal ``ordinal`` from
    ``lanes``: (lanes after, counts per bin on the host, counters), keyed
    by ``pass_key(seed, ordinal, pass_index)`` as ``uniform_f32.run_pass``
    is."""
    pk = threefry.pass_key(seed, ordinal, pass_index)
    k0, k1 = threefry.bits_host(pk, 2)
    after, emissions, counts = classify(lanes, k0, k1, plan, scene, dtype)
    (kr, ki, it), (kept, dropped) = select(emissions, pk, plan,
                                           scene.max_it)
    hist, hits = replay(kr, ki, it, scene, dtype)
    counts.update(emitted=kept, replay_dropped=dropped,
                  points=int((it.to(torch.int64) + 1).sum()),
                  dev_hits=hits)
    return after, hist, counts
