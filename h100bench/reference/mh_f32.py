"""Plain reference of one Metropolis-Hastings (MH) render pass at float32:
Markov chains over a crop's sample window, float32 orbits, tenures
deposited over their recorded canvas bins.

What a pass of the renderer's ``--sampler mh`` path at the default
precision has to produce, written from the algorithm (Boswell's MH
Buddhabrot) in plain PyTorch, one elementwise operation per arithmetic
operation, so every float32 product and sum is rounded once. The chain is
``mh_df32``'s, and its orbit-independent parts (the proposal, the cull,
the deposit and its shares, the plan and the scene) are imported from
there; the generator is ``threefry``'s. What differs is the orbit:

1. The proposal's c. A proposal at grid indices (kr, ki) of the 2^24 x
   2^24 grid of the sample window [r0, r1) x [i0, i1) takes c = (k *
   2^-24) * span + lo an axis, in float32, with lo = RN32(r0) and span =
   RN32(r1 - r0) (float64 difference, one rounding). The cull (main
   cardioid, period-2 bulb) reads that c. z starts at c.
2. The orbit. z <- z^2 + c in float32: re z' = (zr zr - zi zi) + cr, im
   z' = (2 zr) zi + ci, |z'|^2 = zr' zr' + zi' zi' counted while <= 4.
   Brent's checkpoint compares z itself.
3. The window and the bins. A point is on the canvas where x0 <= re z <
   x1 and y0 <= im z < y1, the canvas bounds rounded to float32, in
   absolute coordinates; its bin is column (re z - x0) * inv_x and row (im
   z - y0) * inv_y, truncated and clamped to the canvas, inv_x = RN32(width
   / (max_real - min_real)) from the float64 bounds.

Everything else is ``mh_df32``'s description, steps 1 to 4: the visit
reservoir of ``VISIT_SLOTS`` bins drawn from the per-lane LCG, the
boundary (acceptance at min(1, t(c') / t(x)), tenures retired on an
accept or at ``rep_cap``, one pending emission a lane and flush window,
merged by a weighted reservoir draw), the next proposal (a uniform
restart or a multi-scale mutation), the Threefry words of a boundary, the
burn-in passes, and the deposit of q = floor(v * rep * 65536 / t) split
over the recorded bins.

The plan is the renderer's (``plan_of``), the rest comes from the cell's
files, the seed and the RNG ordinal. ``dtype`` is float32; the control,
``torch.bfloat16``, runs the orbit, its c, the canvas bounds, the bins'
offsets and Brent's point in bfloat16 (the grid indices stay exact
integers in float32, and the reservoir and acceptance draws, which
decide integers, stay float32).
"""

from __future__ import annotations

import torch

from reference import threefry
from reference.mh_df32 import (
    GOLDEN,
    GRID,
    INV24,
    MASK32,
    TARGET_VISIT,
    VISIT_CAP,
    VISIT_SLOTS,
    WINDOW_BLOCK,
    Plan,
    Scene,
    _as_i32,
    _culled,
    _propose,
    deposit,
    shares,
)
from reference.uniform_f32 import BIG, SAVE0

__all__ = ["Plan", "Scene", "VISIT_SLOTS", "init_lanes", "plan_of",
           "run_pass", "chains", "deposit", "shares"]

#: The renderer's MH lane state at float32, in its order.
LANE_FIELDS = ("kr", "ki", "cr", "ci", "zr", "zi", "sr", "si", "it", "sv",
               "dead", "vcnt", "rsv", "xkr", "xki", "xv", "xit", "rep", "vb",
               "xb")
_I32_FIELDS = ("it", "sv", "dead", "vcnt", "rsv", "xv", "xit", "rep", "vb",
               "xb")
#: The orbit's fields, held in ``dtype``; the other float fields are grid
#: indices, exact in float32.
_ORBIT_FIELDS = ("cr", "ci", "zr", "zi", "sr", "si")
#: The fields of ``VISIT_SLOTS`` words a lane, slot-major.
_PLANES = ("vb", "xb")
#: The counters a lane keeps over a pass.
_COUNTS = ("drawn", "culled", "in_band", "cycles", "wasted")
#: What ``_windows`` carries from one window to the next: the lanes (the
#: LCG as uint32 values in ``rsv_u``), the pending emission, the counts.
_PENDING = ("p_it", "p_rep", "p_v", "p_b")
_CARRIED = (tuple(f for f in LANE_FIELDS if f != "rsv") + ("rsv_u",)
            + _PENDING + _COUNTS)
_DTYPES = (torch.float32, torch.bfloat16)


def _refuse(what: str):
    raise ValueError(f"the MH float32 reference does not model {what}")


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
    cfg, o = inner.cfg, inner.cfg.options
    if not inner.mh:
        _refuse("the uniform sampler (--sampler uniform)")
    if inner.extended:
        _refuse("df32 orbits (--precision extended)")
    if inner.replay_mode != "device":
        _refuse(f"host replay (--replay {inner.replay_mode})")
    if cfg.fractal != "buddhabrot" or not o.cycle_detection:
        _refuse("maps other than the Buddhabrot with cycle detection")
    if inner.visit_slots != VISIT_SLOTS:
        _refuse(f"{inner.visit_slots} visit slots (--mh-visit-slots; it "
                f"models {VISIT_SLOTS})")
    tn = inner.tuning
    return Plan(lanes=inner.lanes, steps_per_pass=tn.steps_per_pass,
                steps_per_flush=tn.steps_per_flush, unroll=tn.inner_unroll,
                domain=tuple(float(v) for v in cfg.sample_domain),
                restart256=o.mh_restart, rep_cap=o.mh_rep_cap,
                burnin=o.mh_burnin_passes)


def _check_dtype(dtype) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype!r}: the reference runs float32 or, "
                         "as the control, bfloat16")


def init_lanes(n: int, device, dtype=torch.float32) -> dict:
    """Every proposal starts dead and every chain unseeded (t = 0, escape
    index -1): the first boundary draws a uniform restart. The LCG of
    lane i starts at i * 0x9E3779B9 + 1 (mod 2^32)."""
    _check_dtype(dtype)

    def f(v, dt=torch.float32):
        return torch.full((n,), v, dtype=dt, device=device)

    def i(v):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    out = {k: (i(0) if k in _I32_FIELDS
               else f(0.0, dtype if k in _ORBIT_FIELDS else torch.float32))
           for k in LANE_FIELDS}
    lane = torch.arange(n, dtype=torch.int64, device=device)
    out.update(sr=f(BIG, dtype), si=f(BIG, dtype), sv=i(SAVE0), dead=i(1),
               xit=i(-1), rsv=_as_i32((lane * GOLDEN + 1) & MASK32))
    for k in _PLANES:
        out[k] = torch.zeros(VISIT_SLOTS * n, dtype=torch.int32,
                             device=device)
    return out


def _consts(plan: Plan, scene: Scene, dtype, device) -> dict:
    """The grid's origins and spans, the canvas bounds and the inverse
    pitches (float64 arithmetic, one rounding to ``dtype`` each), as
    0-dim tensors."""
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    r0, r1, i0, i1 = plan.domain
    return dict(
        lo_r=t(r0), span_r=t(r1 - r0), lo_i=t(i0), span_i=t(i1 - i0),
        x0=t(scene.min_real), x1=t(scene.max_real),
        y0=t(scene.min_imag), y1=t(scene.max_imag),
        inv_x=t(scene.width / (scene.max_real - scene.min_real)),
        inv_y=t(scene.height / (scene.max_imag - scene.min_imag)),
        four=t(4.0), big=t(BIG), inv24=t(INV24),
        slots=torch.arange(VISIT_SLOTS, device=device)[:, None])


def _steps(s: dict, c: dict, u: int, scene: Scene):
    """``u`` orbit steps of every lane's proposal with its visit record.
    Returns the orbit after them, the steps inside |z|^2 <= 4 and the
    visits counted so far."""
    i32 = torch.int32
    zr, zi, cr, ci = s["zr"], s["zi"], s["cr"], s["ci"]
    jv, rsv, vb = s["vcnt"], s["rsv_u"], s["vb"]
    nesc = torch.zeros_like(jv)
    for _ in range(u):
        zr, zi = zr * zr - zi * zi + cr, 2.0 * zr * zi + ci
        nesc = nesc + (zr * zr + zi * zi <= c["four"]).to(i32)
        vis = (zr >= c["x0"]) & (zr < c["x1"]) & (zi >= c["y0"]) & (
            zi < c["y1"])
        rsv = (rsv * 1664525 + 1013904223) & MASK32
        mix = rsv ^ (rsv >> 16)
        take = vis & ((mix >> 8).to(torch.float32)
                      * (jv + 1).to(torch.float32)
                      < float(VISIT_SLOTS * GRID))
        col = torch.clamp(torch.where(vis, (zr - c["x0"]) * c["inv_x"], 0.0)
                          .to(i32), max=scene.width - 1)
        row = torch.clamp(torch.where(vis, (zi - c["y0"]) * c["inv_y"], 0.0)
                          .to(i32), max=scene.height - 1)
        slot = torch.where(jv < VISIT_SLOTS, jv.to(torch.int64),
                           mix & (VISIT_SLOTS - 1))
        vb = torch.where(take[None] & (c["slots"] == slot[None]),
                         (row * scene.width + col)[None], vb)
        jv = jv + vis.to(i32)
    return zr, zi, nesc, jv, rsv, vb


def _windows(s: dict, c: dict, lane_id, k0: int, k1: int, nb: int,
             plan: Plan, scene: Scene) -> None:
    """``nb`` boundary windows of every lane from the window counter
    ``s["ctr"]``, updating the tensors of ``s`` in place (so that a CUDA
    graph can capture it)."""
    i32, f32 = torch.int32, torch.float32
    u = plan.unroll
    ctr = (s["ctr"] + torch.arange(nb, dtype=torch.int64,
                                   device=lane_id.device))[:, None]
    words_ri = threefry.threefry2x32(k0, k1, lane_id[None, :], ctr)
    words_ab = threefry.threefry2x32(k0, k1, lane_id[None, :] | (1 << 30),
                                     ctr)
    for j in range(nb):
        w_r, w_i = (w[j] for w in words_ri)
        w_a, w_b = (w[j] for w in words_ab)
        zr, zi, nesc, jv, rsv, vb = _steps(s, c, u, scene)
        it, xv, rep = s["it"], s["xv"], s["rep"]
        # The proposal's end.
        esc = nesc < u
        needed = it + nesc
        cyc = (zr == s["sr"]) & (zi == s["si"]) & ~esc
        it_new = it + u
        dead = s["dead"] != 0
        fin = esc | cyc | (it_new >= scene.max_it) | dead
        cand = esc & ~dead & (needed >= scene.min_it) & (
            needed < scene.max_it)
        t_new = torch.where(cand, torch.clamp(jv, max=VISIT_CAP)
                            * TARGET_VISIT + 1, 0).to(i32)
        # Acceptance, and the retiring tenure into the pending slot.
        u24 = (w_a >> 8).to(f32) * INV24
        accept = fin & (t_new.to(f32) > u24 * xv.to(f32))
        rep1 = rep + 1
        visited = xv > 1
        retire = accept & visited & (rep > 0)
        at_cap = fin & ~accept & (rep1 >= plan.rep_cap)
        out = retire | (at_cap & visited)
        mass = torch.where(retire, rep, rep1)
        held = s["p_it"] >= 0
        total = s["p_rep"] + mass
        keep_new = ~held | (((w_b >> 20) & 0xFFF).to(f32) * total.to(f32)
                            < 4096.0 * mass.to(f32))
        new = out & keep_new
        p_it = torch.where(new, s["xit"], s["p_it"])
        p_v = torch.where(new, xv, s["p_v"])
        p_b = torch.where(new[None], s["xb"], s["p_b"])
        p_rep = torch.where(out, torch.where(held, total, mass), s["p_rep"])
        # The chain moves on an accept.
        xkr = torch.where(accept, s["kr"], s["xkr"])
        xki = torch.where(accept, s["ki"], s["xki"])
        xv = torch.where(accept, t_new, xv)
        xit = torch.where(accept, needed, s["xit"])
        xb = torch.where(accept[None], vb, s["xb"])
        rep = torch.where(accept, 1, torch.where(
            fin, torch.where(at_cap, 0, rep1), rep)).to(i32)
        # Brent's checkpoint of a proposal going on.
        save = (it_new >= s["sv"]) & ~fin
        sr = torch.where(fin, c["big"], torch.where(save, zr, s["sr"]))
        si = torch.where(fin, c["big"], torch.where(save, zi, s["si"]))
        sv = torch.where(fin, SAVE0, torch.where(save, s["sv"] * 2,
                                                 s["sv"])).to(i32)
        # The next proposal where this one finished: c from the grid.
        k_r, k_i, off = _propose(xkr, xki, xv, w_r, w_i, w_b,
                                 plan.restart256)
        nkr, nki = k_r.to(f32), k_i.to(f32)
        ncr = nkr.to(c["lo_r"].dtype) * c["inv24"] * c["span_r"] + c["lo_r"]
        nci = nki.to(c["lo_i"].dtype) * c["inv24"] * c["span_i"] + c["lo_i"]
        gone = _culled(ncr, nci) | off
        s.update(cr=torch.where(fin, ncr, s["cr"]),
                 ci=torch.where(fin, nci, s["ci"]),
                 zr=torch.where(fin, ncr, zr), zi=torch.where(fin, nci, zi),
                 kr=torch.where(fin, nkr, s["kr"]),
                 ki=torch.where(fin, nki, s["ki"]))
        s["drawn"] += fin.to(i32)
        s["culled"] += (fin & gone).to(i32)
        s["in_band"] += (t_new > 0).to(i32)
        s["cycles"] += (cyc & ~dead).to(i32)
        s["wasted"] += (torch.where(dead, u, 0) + torch.where(
            esc & ~dead, it_new - needed - 1, 0)).to(i32)
        s.update(it=torch.where(fin, 0, it_new).to(i32), sr=sr, si=si, sv=sv,
                 dead=torch.where(fin, gone.to(i32), s["dead"]),
                 vcnt=torch.where(fin, 0, jv).to(i32), rsv_u=rsv, vb=vb,
                 xkr=xkr, xki=xki, xv=xv, xit=xit, rep=rep, xb=xb,
                 p_it=p_it, p_v=p_v, p_b=p_b, p_rep=p_rep)


def _run_windows(s: dict, c: dict, lane_id, k0, k1, nb, plan, scene,
                 graphs: dict) -> None:
    """``_windows`` on the tensors of ``s`` in place: plainly on the CPU,
    as a CUDA graph (captured once for each ``nb``) on a card."""
    def body():
        w = dict(s)
        _windows(w, c, lane_id, k0, k1, nb, plan, scene)
        for k in _CARRIED:
            s[k].copy_(w[k])

    if lane_id.device.type != "cuda":
        body()
        return
    if nb not in graphs:
        graphs[nb] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[nb]):
            body()
    graphs[nb].replay()


def chains(lanes: dict, k0: int, k1: int, plan: Plan, scene: Scene,
           dtype=torch.float32):
    """One pass of every lane's chain from ``lanes`` (not changed).
    Returns the lanes after it, the emissions (escape index, rep, target,
    each (flush windows, lanes), and the recorded bins, (flush windows, V,
    lanes)) and the pass's per-lane counts summed. The windows run in
    blocks of ``WINDOW_BLOCK``, each one CUDA graph on a card."""
    _check_dtype(dtype)
    dev, n = lanes["kr"].device, lanes["kr"].numel()
    s = {}
    for f in LANE_FIELDS:
        v = lanes[f].to(dev).clone()
        if f in _ORBIT_FIELDS:
            v = v.to(dtype)
        s[f] = v.view(VISIT_SLOTS, n) if f in _PLANES else v
    s["rsv_u"] = s.pop("rsv").to(torch.int64) & MASK32
    for k in _COUNTS:
        s[k] = torch.zeros(n, dtype=torch.int32, device=dev)
    s.update(p_it=torch.empty(n, dtype=torch.int32, device=dev),
             p_rep=torch.empty(n, dtype=torch.int32, device=dev),
             p_v=torch.empty(n, dtype=torch.int32, device=dev),
             p_b=torch.empty((VISIT_SLOTS, n), dtype=torch.int32,
                             device=dev),
             ctr=torch.zeros((), dtype=torch.int64, device=dev))
    c = _consts(plan, scene, dtype, dev)
    lane_id = torch.arange(n, dtype=torch.int64, device=dev)
    flushes = plan.steps_per_pass // plan.steps_per_flush
    windows = plan.steps_per_flush // plan.unroll
    emit = {k: torch.empty((flushes, n), dtype=torch.int32, device=dev)
            for k in ("it", "rep", "v")}
    emit["bins"] = torch.empty((flushes, VISIT_SLOTS, n), dtype=torch.int32,
                               device=dev)
    graphs: dict = {}
    for flush in range(flushes):
        s["p_it"].fill_(-1)
        s["p_rep"].zero_()
        s["p_v"].zero_()
        s["p_b"].zero_()
        for w0 in range(0, windows, WINDOW_BLOCK):
            nb = min(WINDOW_BLOCK, windows - w0)
            s["ctr"].fill_(flush * windows + w0)
            _run_windows(s, c, lane_id, k0, k1, nb, plan, scene, graphs)
        for k in ("it", "rep", "v"):
            emit[k][flush].copy_(s["p_" + k])
        emit["bins"][flush].copy_(s["p_b"])
    after = {f: s[f].reshape(-1) for f in LANE_FIELDS if f != "rsv"}
    after["rsv"] = _as_i32(s["rsv_u"])
    after = {f: after[f] for f in LANE_FIELDS}
    counts = {k: int(s[k].sum(dtype=torch.int64)) for k in _COUNTS}
    counts["samples"] = counts.pop("drawn")
    counts["iters"] = plan.steps_per_pass * n - counts["wasted"]
    return after, emit, counts


def run_pass(lanes: dict, seed: int, pass_index: int, plan: Plan,
             scene: Scene, dtype=torch.float32, ordinal: int = 0):
    """One whole pass of the device with RNG ordinal ``ordinal`` from
    ``lanes``: (lanes after, counts per bin on the host, counters), keyed
    by ``pass_key(seed, ordinal, pass_index)`` as every pass of the
    renderer is. A burn-in pass deposits nothing, and the last one zeroes
    every tenure counter after its chains' steps."""
    pk = threefry.pass_key(seed, ordinal, pass_index)
    k0, k1 = threefry.bits_host(pk, 2)
    after, emit, counts = chains(lanes, k0, k1, plan, scene, dtype)
    if pass_index == plan.burnin - 1:
        after["rep"].zero_()
    if pass_index < plan.burnin:
        hist, points = torch.zeros(scene.pixels, dtype=torch.int64), 0
    else:
        hist, points = deposit(emit, scene)
    counts.update(emitted=int((emit["it"] >= 0).sum()), replay_dropped=0,
                  points=points, dev_hits=0)
    return after, hist, counts
