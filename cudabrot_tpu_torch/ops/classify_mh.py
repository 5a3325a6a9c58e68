"""Metropolis-Hastings classify passes (f32 and df32 orbits): the CUDA
kernels and their plain version.

Port of ``cudabrot_tpu/ops/pallas_kernels_mh.py`` (``MhLaneState``,
``ExtMhLaneState``, their initializers, ``_mh_propose``, ``_mh_boundary``,
``_record_visit``, ``_mh_bits``, ``classify_pass_mh``,
``classify_pass_ext_mh``). Uniform sampling cannot feed a deep crop: the
samples whose orbits visit a small canvas window grow rare with the
window. Here every lane runs a Markov chain over the 2^24-point sample
grid whose stationary density is proportional to the target

    t(c) = 256 * min(v(c), 32767) + 1[c in band],

v(c) being the number of orbit points the sample puts on the canvas window.
The ``+ 1`` is the ergodicity bridge: in-band samples that never visit stay
proposable, so chains seed by hitting the in-band set and walk to the
visiting filaments. A proposal's orbit evaluation is its target evaluation;
the pass also quantizes every in-window position to its canvas bin and
keeps a uniform reservoir of ``visit_slots`` of them per proposal. A
rejected proposal adds one to the chain state's tenure ``rep``; a tenure is
emitted once, when an accept retires it or ``rep`` reaches the cap, as
(escape index, rep, t, recorded bins). The deposit weights each emission by
rep * 65536 / t (``ops/binning.mh_deposit``), which undoes the chains'
density: the rendered measure is the uniform one. Two emissions of one
lane within a flush window merge by weighted reservoir sampling, which
conserves their mass exactly.

``classify_pass_mh`` and ``classify_pass_ext_mh`` launch the two kernels of
``csrc/classify_mh.cu`` for CUDA tensors and run ``classify_pass_mh_plain`` for CPU tensors. Both round every operation
once, so on one input they agree bitwise. The chain functions here
(``mh_propose``, ``mh_boundary``, ``record_visit``) are the vector forms of
the ones in ``csrc/mh.cuh``. A pass updates the lane state in place.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cudabrot_tpu_torch.config import SAMPLE_DOMAIN
from cudabrot_tpu_torch.models.fractals import FractalMap, cull_mask
from cudabrot_tpu_torch.ops import _build, df32, launches, prng
from cudabrot_tpu_torch.ops.classify import (
    BIG,
    SAVE0,
    STAT_CULLED,
    STAT_CYCLES,
    STAT_DRAWN,
    STAT_IN_BAND,
    STAT_WASTED,
)
from cudabrot_tpu_torch.ops.classify_ext import TWO23, grid_params

#: Histogram counts are in units of 1/WEIGHT_SCALE, so sub-unit weights
#: still deposit. Tone mapping max-normalizes, so the scale cancels in the
#: image; checkpoints record it so MH and uniform histograms never mix.
WEIGHT_SCALE = 256
#: Chain-target units per canvas visit, and the visit cap that keeps t
#: exact in f32 and below 2^23 for the deposit's u32 long division.
TARGET_VISIT = 256
T_VCAP = 32767

STAT_MH_ACCEPT = 5  # accepted proposals (chain moves)
STAT_MH_MERGE = 6  # pending-slot reservoir merges
STAT_MH_MERGED_REP = 7  # min-side rep mass involved in those merges
MH_STATS_ROWS = 8

TWO24 = 1 << 24  # grid points per axis
INV24 = 5.9604644775390625e-08  # 2^-24
_MASK32 = prng.MASK32
_I32 = torch.int32
_F32 = torch.float32


class MhLaneState(NamedTuple):
    """Per-lane chain and in-flight proposal state, (R, 128) each except
    the visit-bin reservoirs vb/xb, (visit_slots, R, 128) (the JAX layout,
    same names and order)."""

    kr: torch.Tensor  # f32 proposal grid index (real axis, 0..2^24)
    ki: torch.Tensor  # f32 proposal grid index (imag axis)
    cr: torch.Tensor  # f32 proposal c (rebuilt at the draw)
    ci: torch.Tensor
    zr: torch.Tensor  # f32 orbit position
    zi: torch.Tensor
    sr: torch.Tensor  # f32 Brent saved point
    si: torch.Tensor
    it: torch.Tensor  # i32 completed updates of the proposal
    sv: torch.Tensor  # i32 next Brent save index
    dead: torch.Tensor  # i32 1 => proposal invalid (culled / out of domain)
    vcnt: torch.Tensor  # i32 in-window updated positions so far
    rsv: torch.Tensor  # i32 reservoir LCG state
    xkr: torch.Tensor  # f32 chain state grid index (real)
    xki: torch.Tensor  # f32 chain state grid index (imag)
    xv: torch.Tensor  # i32 chain target t(x); 0 = unseeded
    xit: torch.Tensor  # i32 chain state escape index
    rep: torch.Tensor  # i32 chain steps the current state has been kept
    vb: torch.Tensor  # i32 (V, R, 128) proposal visit-bin reservoir
    xb: torch.Tensor  # i32 (V, R, 128) chain state visit-bin reservoir


class ExtMhLaneState(NamedTuple):
    """``MhLaneState`` with the proposal's c and orbit carried in df32."""

    kr: torch.Tensor
    ki: torch.Tensor
    crh: torch.Tensor  # df32 proposal c
    crl: torch.Tensor
    cih: torch.Tensor
    cil: torch.Tensor
    zr: torch.Tensor  # df32 orbit position
    zrl: torch.Tensor
    zi: torch.Tensor
    zil: torch.Tensor
    sr: torch.Tensor  # f32 Brent saved point (hi parts)
    si: torch.Tensor
    it: torch.Tensor
    sv: torch.Tensor
    dead: torch.Tensor
    vcnt: torch.Tensor
    rsv: torch.Tensor
    xkr: torch.Tensor
    xki: torch.Tensor
    xv: torch.Tensor
    xit: torch.Tensor
    rep: torch.Tensor
    vb: torch.Tensor
    xb: torch.Tensor


#: The int32 fields of both MH lane states; every other field is float32.
I32_FIELDS = ("it", "sv", "dead", "vcnt", "rsv", "xv", "xit", "rep", "vb",
              "xb")
#: The fields shaped (visit_slots, R, 128).
PLANE_FIELDS = ("vb", "xb")


def init_rsv(shape, device="cpu") -> torch.Tensor:
    """Per-lane LCG seeds: lane * -1640531527 + 1 in wrapping int32 (a
    golden-ratio mix; the reservoir draw is part of the reproducible sample
    schedule)."""
    n = shape[0] * shape[1]
    lane = torch.arange(n, dtype=torch.int64, device=device)
    return _wrap_i32((lane * (-1640531527) + 1) & _MASK32).view(shape)


def _init(cls, lane_rows: int, visit_slots: int, device):
    shape = (lane_rows, 128)

    def f(v):
        return torch.full(shape, v, dtype=_F32, device=device)

    def i(v):
        return torch.full(shape, v, dtype=_I32, device=device)

    # All proposals start dead: the first boundary draws the first real
    # (restart) proposals; xv = 0 keeps them forced-uniform and accepted
    # at their first in-band finish until every chain is seeded.
    fields = dict(sr=f(BIG), si=f(BIG), it=i(0), sv=i(SAVE0), dead=i(1),
                  vcnt=i(0), rsv=init_rsv(shape, device), xv=i(0),
                  xit=i(-1), rep=i(0))
    for name in cls._fields:
        if name in PLANE_FIELDS:
            fields[name] = torch.zeros((visit_slots,) + shape, dtype=_I32,
                                       device=device)
        elif name not in fields:
            fields[name] = f(0.0)
    return cls(**fields)


def init_mh_lane_state(lane_rows: int, visit_slots: int = 8,
                       device="cpu") -> MhLaneState:
    return _init(MhLaneState, lane_rows, visit_slots, device)


def init_ext_mh_lane_state(lane_rows: int, visit_slots: int = 8,
                           device="cpu") -> ExtMhLaneState:
    return _init(ExtMhLaneState, lane_rows, visit_slots, device)


class MhClassifyResult(NamedTuple):
    state: MhLaneState | ExtMhLaneState
    emit_it: torch.Tensor  # (chunks, R, 128) i32 escape index, -1 empty
    emit_rep: torch.Tensor  # (chunks, R, 128) i32 tenure chain steps
    emit_v: torch.Tensor  # (chunks, R, 128) i32 the chain's target t
    emit_bins: torch.Tensor  # (chunks, V, R, 128) i32 visit-bin reservoir
    stats: torch.Tensor  # (MH_STATS_ROWS, R, 128) i32 per-lane counters


# ----------------------------------------------------------------------
# The chain functions, all lanes as one vector. Random words are int64
# tensors holding uint32 values (PyTorch has no full uint32 arithmetic).


def _wrap_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> the int32 with the same bits."""
    return ((u ^ 0x80000000) - 0x80000000).to(_I32)


def _u32(i: torch.Tensor) -> torch.Tensor:
    """int32 -> int64 holding the same bits as a uint32 value."""
    return i.to(torch.int64) & _MASK32


def mh_propose(xkr, xki, xv, rb_r, rb_i, rb_b, restart256: int):
    """The proposal draw: a symmetric multi-scale integer mutation of the
    chain's grid indices (mantissa >> scale, the scale uniform over 24
    octaves, random sign) mixed with a uniform restart of weight
    ``restart256``/256, forced while the chain is unseeded. Returns
    (nk_r, nk_i [int32, clipped into range], oob): a local move that left
    the domain keeps an in-range index but must resolve as dead."""
    m24_r, m24_i = rb_r >> 8, rb_i >> 8
    sh_r = torch.clamp((rb_b >> 2) & 31, max=23)
    sh_i = torch.clamp((rb_b >> 7) & 31, max=23)
    off_r, off_i = m24_r >> sh_r, m24_i >> sh_i
    dk_r = torch.where((rb_b & 1) != 0, -off_r, off_r)
    dk_i = torch.where((rb_b & 2) != 0, -off_i, off_i)
    restart = (((rb_b >> 12) & 255) < restart256) | (xv == 0)
    loc_r = xkr.to(torch.int64) + dk_r
    loc_i = xki.to(torch.int64) + dk_i
    nk_r = torch.where(restart, m24_r, loc_r)
    nk_i = torch.where(restart, m24_i, loc_i)
    oob = ~restart & ((loc_r < 0) | (loc_r >= TWO24)
                      | (loc_i < 0) | (loc_i >= TWO24))
    return (torch.clamp(nk_r, 0, TWO24 - 1).to(_I32),
            torch.clamp(nk_i, 0, TWO24 - 1).to(_I32), oob)


def mh_boundary(fin, v_prop, needed, kr, ki, xkr, xki, xv, xit, rep, vb, xb,
                p_it, p_rep, p_v, p_b, rb_a, rb_b, rep_cap: int):
    """The chain boundary: Metropolis acceptance on the bridge target
    (accept iff u * t(x) < t(c'), u uniform), emission of the retiring
    tenure into the pending registers (on accept, or forced at the rep cap;
    only tenures with visits, xv > 1, emit), the weighted-reservoir merge
    of a pending collision (keep the new record with probability
    rep_new / (mass_old + rep_new), carry the summed mass either way), and
    the chain update. The pending copy takes the old ``xb`` before the
    accept overwrites it with ``vb``. Returns (accept, xkr, xki, xv, xit,
    rep, xb, p_it, p_rep, p_v, p_b, d_merges, d_merged_rep)."""
    u24 = (rb_a >> 8).to(_F32) * INV24
    accept = fin & (v_prop.to(_F32) > u24 * xv.to(_F32))

    rep_rej = rep + 1
    emit_ok = xv > 1
    emit = accept & emit_ok & (rep > 0)
    at_cap = fin & ~accept & (rep_rej >= rep_cap)
    emit_any = emit | (at_cap & emit_ok)
    rep_used = torch.where(emit, rep, rep_rej)
    occupied = p_it >= 0
    merged = emit_any & occupied
    tot = p_rep + rep_used
    u12 = ((rb_b >> 20) & 0xFFF).to(_F32)
    take_new = ~occupied | (u12 * tot.to(_F32) < 4096.0 * rep_used.to(_F32))
    upd = emit_any & take_new
    d_merges = merged.to(_I32)
    d_merged_rep = torch.where(merged, torch.minimum(p_rep, rep_used), 0)
    p_it = torch.where(upd, xit, p_it)
    p_v = torch.where(upd, xv, p_v)
    p_b = torch.where(upd[None], xb, p_b)
    p_rep = torch.where(emit_any, torch.where(occupied, tot, rep_used), p_rep)

    xkr = torch.where(accept, kr, xkr)
    xki = torch.where(accept, ki, xki)
    xv = torch.where(accept, v_prop, xv)
    xit = torch.where(accept, needed, xit)
    xb = torch.where(accept[None], vb, xb)
    rep = torch.where(
        accept, 1,
        torch.where(fin, torch.where(at_cap, 0, rep_rej), rep),
    ).to(_I32)
    return (accept, xkr, xki, xv, xit, rep, xb, p_it, p_rep, p_v, p_b,
            d_merges, d_merged_rep.to(_I32))


def _record_visit_u(vis, dr, di, jvis, rsv_u, vb, bin_map):
    """``record_visit`` on the LCG state as an int64 tensor of uint32
    values (the pass keeps it so between steps)."""
    wx0, wy0, inv_dx, inv_dy, width, height = bin_map
    v_slots = vb.shape[0]
    # Quantized only where the visit is inside the window, so no
    # out-of-range float is converted; truncation toward zero, then the
    # clamp (a visit at the upper edge can round up to the width).
    col = torch.where(vis, (dr - wx0) * inv_dx, 0.0).to(_I32)
    row = torch.where(vis, (di - wy0) * inv_dy, 0.0).to(_I32)
    col = torch.clamp(col, max=width - 1)
    row = torch.clamp(row, max=height - 1)
    bin_ = row * width + col
    rsv_u = (rsv_u * 1664525 + 1013904223) & _MASK32
    mix = rsv_u ^ (rsv_u >> 16)
    u24 = (mix >> 8).to(_F32)
    take = vis & (u24 * (jvis + 1).to(_F32) < float(v_slots * TWO24))
    slot = torch.where(jvis < v_slots, jvis.to(torch.int64),
                       mix & (v_slots - 1))
    kidx = torch.arange(v_slots, device=vb.device).view(
        (v_slots,) + (1,) * jvis.dim())
    hit = take[None] & (kidx == slot[None])
    return rsv_u, torch.where(hit, bin_[None], vb)


def record_visit(vis, dr, di, jvis, rsv, vb, bin_map):
    """Reservoir-record one (masked) canvas visit per lane.

    ``vis``: this step's in-window mask; ``dr``/``di``: the updated
    position in the window's own coordinates (absolute at f32,
    centre-relative at df32); ``jvis``: visits recorded so far this
    proposal; ``rsv``: per-lane int32 LCG state; ``vb``: (V, ...) reservoir;
    ``bin_map`` = (wx0, wy0, inv_dx, inv_dy [0-dim f32 tensors], width,
    height). The first V visits fill slots in order; visit j >= V replaces
    a uniform slot with probability V/(j+1), so the recorded set is a
    uniform subsample of all visits. The LCG advances on every call, masked
    lanes included. Returns (rsv', vb')."""
    rsv_u, vb = _record_visit_u(vis, dr, di, jvis, _u32(rsv), vb, bin_map)
    return _wrap_i32(rsv_u), vb


# ----------------------------------------------------------------------
# The passes.


def classify_pass_mh(state: MhLaneState, seed, bits=None, **kw
                     ) -> MhClassifyResult:
    """One MH chain pass over the f32 orbit: the call contract of
    ``classify.classify_pass`` with visit-bin emissions plus rep and target
    rows.

    ``window`` is the exact canvas bounds (the chain target and, with
    ``canvas_wh`` as its pixel grid, the bin map); ``restart256`` the
    uniform-restart mixture weight in 1/256ths; ``rep_cap`` bounds tenure
    batching. ``bits``, given iff ``rng == "bits"``, is a (chunks, windows,
    4, R, 128) int32 tensor of uint32 words: the two mutation mantissas, the
    acceptance word and the control word of every boundary. The reservoir
    width is the leading axis of the state's vb/xb."""
    return _classify(False, state, seed, bits, **kw)


def classify_pass_ext_mh(state: ExtMhLaneState, seed, bits=None, **kw
                         ) -> MhClassifyResult:
    """``classify_pass_mh`` over the df32 orbit. ``window`` is
    centre-relative here: the canvas bounds minus the exact f64 value of the
    df32 sample-window centre (absolute f32 bounds collapse below the
    centre's ulp); visit bins are quantized in the same coordinates."""
    return _classify(True, state, seed, bits, **kw)


def _classify(
    ext: bool,
    state,
    seed: tuple[int, int],
    bits: torch.Tensor | None,
    *,
    fractal: FractalMap,
    min_it: int,
    max_it: int,
    steps_per_pass: int,
    steps_per_flush: int,
    cycle_detection: bool = True,
    inner_unroll: int = 1,
    rng: str | None = None,
    sample_domain: tuple = SAMPLE_DOMAIN,
    window: tuple = SAMPLE_DOMAIN,
    restart256: int = 16,
    rep_cap: int = 4096,
    canvas_wh: tuple = (1000, 1000),
) -> MhClassifyResult:
    if steps_per_pass % steps_per_flush != 0:
        raise ValueError("steps_per_pass must be a multiple of steps_per_flush")
    if steps_per_flush % inner_unroll != 0:
        raise ValueError("steps_per_flush must be a multiple of inner_unroll")
    if not 0 <= restart256 <= 256:
        raise ValueError("restart256 must be in [0, 256]")
    if rep_cap < 2:
        raise ValueError("rep_cap must be at least 2")
    chunks = steps_per_pass // steps_per_flush
    windows = steps_per_flush // inner_unroll
    lane_rows = state.kr.shape[0]
    visit_slots = state.vb.shape[0]
    if visit_slots not in (2, 4, 8, 16, 32):
        raise ValueError("visit_slots must be a power of two in [2, 32]")
    if rng is None:
        rng = "bits" if bits is not None else "threefry"
    if rng in ("hardware", "hardware_rw"):
        raise ValueError(
            f"rng {rng} draws from the TPU's hardware generator; this "
            "package draws from threefry or given bits"
        )
    if rng not in ("threefry", "bits"):
        raise ValueError(f"Unknown rng mode: {rng}")
    if (rng == "bits") != (bits is not None):
        raise ValueError("bits must be supplied iff rng == 'bits'")
    if bits is not None:
        if tuple(bits.shape) != (chunks, windows, 4, lane_rows, 128):
            raise ValueError(f"bits has wrong shape {tuple(bits.shape)}")
        if bits.dtype != _I32:
            raise ValueError("bits must be an int32 tensor of uint32 words")
    _check_state(state)
    wx0, wx1, wy0, wy1 = (float(v) for v in window)
    cv_w, cv_h = (int(v) for v in canvas_wh)
    spec = dict(
        fractal=fractal, min_it=min_it, max_it=max_it, chunks=chunks,
        windows=windows, unroll=inner_unroll,
        detect=bool(cycle_detection and fractal.cycle_detect),
        sample_domain=tuple(float(v) for v in sample_domain),
        # The bin map's pitches: f64 arithmetic, one rounding to f32.
        window=(wx0, wx1, wy0, wy1, cv_w / (wx1 - wx0), cv_h / (wy1 - wy0)),
        restart256=restart256, rep_cap=rep_cap, canvas_wh=(cv_w, cv_h),
    )
    k0, k1 = (int(w) & _MASK32 for w in seed)
    if state.kr.device.type == "cpu":
        return classify_pass_mh_plain(ext, state, k0, k1, bits, **spec)
    return _classify_mh_cuda(ext, state, k0, k1, bits, **spec)


def _check_state(state) -> None:
    shape = state.kr.shape
    vshape = (state.vb.shape[0],) + tuple(shape)
    for name, t in zip(state._fields, state):
        want = _I32 if name in I32_FIELDS else _F32
        want_shape = vshape if name in PLANE_FIELDS else tuple(shape)
        if (t.dtype != want or tuple(t.shape) != want_shape
                or not t.is_contiguous()):
            raise ValueError(
                f"lane state field {name}: want contiguous {want} "
                f"{want_shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != state.kr.device:
            raise ValueError("lane state fields lie on different devices")


def _grid_constants(ext: bool, sample_domain) -> tuple:
    """The six f32 constants of the sample grid (``csrc/mh.cuh`` grid[6])."""
    if ext:
        c0r, c0i, step_r, step_i = grid_params(sample_domain)
        return (*c0r, *c0i, step_r, step_i)
    r0, r1, i0, i1 = sample_domain
    return (r0, r1 - r0, i0, i1 - i0, 0.0, 0.0)


def _classify_mh_cuda(ext, state, k0, k1, bits, *, fractal, min_it, max_it,
                      chunks, windows, unroll, detect, sample_domain, window,
                      restart256, rep_cap, canvas_wh) -> MhClassifyResult:
    dev = state.kr.device
    rows, slots = state.kr.shape[0], state.vb.shape[0]
    lanes = rows * 128
    name = "classify_ext_mh" if ext else "classify_mh"
    lib = _lib(name)

    def out(*shape):
        return torch.empty(shape, dtype=_I32, device=dev)

    emit_it, emit_rep, emit_v = (out(chunks, rows, 128) for _ in range(3))
    emit_b = out(chunks, slots, rows, 128)
    stats = out(MH_STATS_ROWS, rows, 128)
    if bits is not None:
        bits = bits.to(dev).contiguous()
    ptrs = (ctypes.c_void_p * (len(state) + 6))(
        *(t.data_ptr() for t in state),
        emit_it.data_ptr(), emit_rep.data_ptr(), emit_v.data_ptr(),
        emit_b.data_ptr(), stats.data_ptr(),
        bits.data_ptr() if bits is not None else None,
    )
    iargs = (ctypes.c_int * 13)(
        fractal.kernel_id, slots, lanes, chunks, windows, unroll, min_it,
        max_it, int(detect), restart256, rep_cap, *canvas_wh,
    )
    fargs = (ctypes.c_float * 12)(*_grid_constants(ext, sample_domain),
                                  *window)
    with torch.cuda.device(dev):
        rc = getattr(lib, f"cb_{name}")(ptrs, iargs, fargs, k0, k1,
                                        _build.stream_of(state.kr))
    _build.check(rc, f"{name} kernel")
    launches.COUNTS[name] += 1
    return MhClassifyResult(state, emit_it, emit_rep, emit_v, emit_b, stats)


def _lib(name: str):
    """The MH classify library with ``cb_<name>`` bound."""
    lib = _build.load("classify_mh")
    fn = getattr(lib, f"cb_{name}")
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def classify_pass_mh_plain(ext, state, k0, k1, bits, *, fractal, min_it,
                           max_it, chunks, windows, unroll, detect,
                           sample_domain, window, restart256, rep_cap,
                           canvas_wh) -> MhClassifyResult:
    """The two kernels' function in plain PyTorch (``ext`` picks the df32
    orbit), all lanes as one vector: one elementwise op per arithmetic
    operation (single rounding), the window loop in Python. The kernels draw
    a boundary's four words only for a finished lane; here they are computed
    for every lane (the generator is counter-based, so the words are the
    same)."""
    launches.COUNTS["classify_ext_mh_plain" if ext
                    else "classify_mh_plain"] += 1
    dev = state.kr.device
    shape = state.kr.shape
    n = state.kr.numel()
    v_slots = state.vb.shape[0]
    s = {name: (t.reshape(v_slots, n) if name in PLANE_FIELDS
                else t.reshape(-1)).clone()
         for name, t in zip(state._fields, state)}
    kr, ki, sr, si = s["kr"], s["ki"], s["sr"], s["si"]
    it, sv, dead, vcnt = s["it"], s["sv"], s["dead"], s["vcnt"]
    xkr, xki, xv, xit, rep = s["xkr"], s["xki"], s["xv"], s["xit"], s["rep"]
    vb, xb = s["vb"], s["xb"]
    rsv_u = _u32(s["rsv"])
    if ext:
        c = [s["crh"], s["crl"], s["cih"], s["cil"]]
        z = [s["zr"], s["zrl"], s["zi"], s["zil"]]
    else:
        c = [s["cr"], s["ci"]]
        z = [s["zr"], s["zi"]]

    def f32(v):
        return prng.f32(v, dev)

    big, four = f32(BIG), f32(4.0)
    grid = [f32(v) for v in _grid_constants(ext, sample_domain)]
    wx0, wx1, wy0, wy1, inv_dx, inv_dy = (f32(v) for v in window)
    bin_map = (wx0, wy0, inv_dx, inv_dy, *canvas_wh)
    lane_id = torch.arange(n, dtype=torch.int64, device=dev)
    if bits is not None:
        words = _u32(bits.to(dev).reshape(chunks, windows, 4, n))
    p_it = torch.full((n,), -1, dtype=_I32, device=dev)
    p_rep = torch.zeros(n, dtype=_I32, device=dev)
    p_v = torch.zeros_like(p_rep)
    p_b = torch.zeros((v_slots, n), dtype=_I32, device=dev)
    counts = torch.zeros((MH_STATS_ROWS, n), dtype=_I32, device=dev)
    emit_it = torch.empty((chunks, n), dtype=_I32, device=dev)
    emit_rep = torch.empty_like(emit_it)
    emit_v = torch.empty_like(emit_it)
    emit_b = torch.empty((chunks, v_slots, n), dtype=_I32, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    # Threefry words for a block of windows at a time (at most 2^22 words
    # per call).
    block = max(1, min(windows, (1 << 22) // n))

    for chunk in range(chunks):
        for w in range(windows):
            # --- inner window: updates, survival counter, in-window
            # counting and visit-bin recording. `<= 4` so the NaNs an
            # escaped lane coasts into count as escaped; NaN is outside the
            # window too (all four compares false).
            az = list(z)
            nesc = torch.zeros(n, dtype=_I32, device=dev)
            jv = vcnt
            for _ in range(unroll):
                if ext:
                    *az, mag2 = df32.complex_sqr_add(
                        *az, *c, fold_abs=fractal.fold_abs)
                    dr = (az[0] - grid[0]) + (az[1] - grid[1])
                    di = (az[2] - grid[2]) + (az[3] - grid[3])
                else:
                    azr, azi = az
                    nzr = azr * azr - azi * azi + c[0]
                    if fractal.fold_abs:
                        nzi = 2.0 * torch.abs(azr * azi) + c[1]
                    else:
                        nzi = 2.0 * azr * azi + c[1]
                    az = [nzr, nzi]
                    mag2 = nzr * nzr + nzi * nzi
                    dr, di = nzr, nzi
                nesc = nesc + (mag2 <= four).to(_I32)
                vis = (dr >= wx0) & (dr < wx1) & (di >= wy0) & (di < wy1)
                rsv_u, vb = _record_visit_u(vis, dr, di, jv, rsv_u, vb,
                                            bin_map)
                jv = jv + vis.to(_I32)
            hi_r, hi_i = (az[0], az[2]) if ext else az
            esc = nesc < unroll
            needed = it + nesc
            cyc = ((hi_r == sr) & (hi_i == si) & ~esc) if detect else no

            # --- boundary: proposal resolution ---
            it_new = it + unroll
            maxed = it_new >= max_it
            deadb = dead != 0
            fin = esc | cyc | maxed | deadb
            if fractal.emit == "interior":
                esc_in_cap = esc & (needed < max_it)
                cand = (cyc | maxed) & ~esc_in_cap & ~deadb
                needed = torch.where(cand, max_it - 1, needed).to(_I32)
            else:
                cand = esc & ~deadb & (needed >= min_it) & (needed < max_it)
            v_prop = torch.where(
                cand, torch.clamp(jv, max=T_VCAP) * TARGET_VISIT + 1, 0
            ).to(_I32)

            if bits is not None:
                rb_r, rb_i, rb_a, rb_b = words[chunk, w]
            else:
                if w % block == 0:
                    gwin = (chunk * windows + w + torch.arange(
                        min(block, windows - w), dtype=torch.int64,
                        device=dev))[:, None]
                    tf_ri = prng.threefry2x32(k0, k1, lane_id[None, :], gwin)
                    tf_ab = prng.threefry2x32(
                        k0, k1, lane_id[None, :] | 0x40000000, gwin)
                rb_r, rb_i = (t[w % block] for t in tf_ri)
                rb_a, rb_b = (t[w % block] for t in tf_ab)

            (accept, xkr, xki, xv, xit, rep, xb, p_it, p_rep, p_v, p_b,
             d_merges, d_merged) = mh_boundary(
                fin, v_prop, needed, kr, ki, xkr, xki, xv, xit, rep, vb, xb,
                p_it, p_rep, p_v, p_b, rb_a, rb_b, rep_cap)

            if detect:
                at_save = (it_new >= sv) & ~fin
                sr2 = torch.where(at_save, hi_r, sr)
                si2 = torch.where(at_save, hi_i, si)
                sv2 = torch.where(at_save, sv * 2, sv)
            else:
                sr2, si2, sv2 = sr, si, sv

            # --- the next proposal, from the updated chain state ---
            nk_r, nk_i, oob = mh_propose(xkr, xki, xv, rb_r, rb_i, rb_b,
                                         restart256)
            nkr_f, nki_f = nk_r.to(_F32), nk_i.to(_F32)
            if ext:
                off_r = (nkr_f - TWO23) * grid[4]
                off_i = (nki_f - TWO23) * grid[5]
                nc = [*df32.add_f(grid[0], grid[1], off_r),
                      *df32.add_f(grid[2], grid[3], off_i)]
                # The cull runs on the f32 approximation of c.
                ca_r, ca_i = grid[0] + off_r, grid[2] + off_i
            else:
                nc = [nkr_f * INV24 * grid[1] + grid[0],
                      nki_f * INV24 * grid[3] + grid[2]]
                ca_r, ca_i = nc
            ncull = cull_mask(fractal, ca_r, ca_i) | oob

            kr = torch.where(fin, nkr_f, kr)
            ki = torch.where(fin, nki_f, ki)
            c = [torch.where(fin, new, old) for new, old in zip(nc, c)]
            # z starts at c.
            z = [torch.where(fin, new, old) for new, old in zip(nc, az)]
            it = torch.where(fin, 0, it_new).to(_I32)
            sr = torch.where(fin, big, sr2)
            si = torch.where(fin, big, si2)
            sv = torch.where(fin, SAVE0, sv2).to(_I32)
            dead = torch.where(fin, ncull.to(_I32), dead)
            vcnt = torch.where(fin, 0, jv).to(_I32)

            counts[STAT_DRAWN] += fin.to(_I32)
            counts[STAT_CULLED] += (fin & ncull).to(_I32)
            counts[STAT_IN_BAND] += (v_prop > 0).to(_I32)
            counts[STAT_CYCLES] += (cyc & ~deadb).to(_I32)
            counts[STAT_WASTED] += torch.where(deadb, unroll, 0).to(_I32)
            counts[STAT_WASTED] += torch.where(
                esc & ~deadb, it_new - needed - 1, 0).to(_I32)
            counts[STAT_MH_ACCEPT] += accept.to(_I32)
            counts[STAT_MH_MERGE] += d_merges
            counts[STAT_MH_MERGED_REP] += d_merged

        emit_it[chunk] = p_it
        emit_rep[chunk] = p_rep
        emit_v[chunk] = p_v
        emit_b[chunk] = p_b
        p_it = torch.full_like(p_it, -1)
        p_rep = torch.zeros_like(p_rep)
        p_v = torch.zeros_like(p_v)
        p_b = torch.zeros_like(p_b)

    s.update(kr=kr, ki=ki, sr=sr, si=si, it=it, sv=sv, dead=dead, vcnt=vcnt,
             rsv=_wrap_i32(rsv_u), xkr=xkr, xki=xki, xv=xv, xit=xit, rep=rep,
             vb=vb, xb=xb)
    if ext:
        s.update(crh=c[0], crl=c[1], cih=c[2], cil=c[3],
                 zr=z[0], zrl=z[1], zi=z[2], zil=z[3])
    else:
        s.update(cr=c[0], ci=c[1], zr=z[0], zi=z[1])
    for name, dst in zip(state._fields, state):
        dst.copy_(s[name].view(dst.shape))
    rows = shape[0]
    return MhClassifyResult(
        state,
        emit_it.view(chunks, rows, 128),
        emit_rep.view(chunks, rows, 128),
        emit_v.view(chunks, rows, 128),
        emit_b.view(chunks, v_slots, rows, 128),
        counts.view(MH_STATS_ROWS, rows, 128),
    )
