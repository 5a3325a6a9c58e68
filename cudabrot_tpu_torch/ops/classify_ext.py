"""Extended-precision (df32) classify pass: the CUDA kernel and its plain
version.

Port of ``cudabrot_tpu/ops/pallas_kernels_ext.py`` (``ExtLaneState``,
``init_ext_lane_state``, ``grid_params``, ``_make_kernel_ext``,
``classify_pass_ext``). The persistent-lane design of ``ops/classify.py``
with the orbit carried as double-float (hi, lo) float32 pairs
(``ops/df32.py``, ~2^-48 relative), enough to resolve canvas widths down to
~1e-10 that plain f32 quantizes into bands. What differs from the f32
pass, all for precision:

  * the lane state is 16 arrays: the df32 orbit (zr, zrl, zi, zil), the
    df32 sample c (crh, crl, cih, cil, computed once per refill), the
    24-bit refill grid indices (kr, ki) and the f32 Brent and bookkeeping
    registers;
  * samples are drawn on the 2^24-point grid of the sample window:
    off = (k - 2^23) * step with step = f32(span / 2^24), c = center (+)
    off in df32. The emission payload is (kr, ki): the raw grid index is
    the one representation that round-trips to the replay by construction;
  * escape tracking is always the survival counter ("thin");
  * Brent cycle checks compare hi components only;
  * the cardioid/bulb cull runs on the f32 approximation center_hi + off.

``classify_pass_ext`` launches ``csrc/classify_ext.cu`` for CUDA tensors
and runs ``classify_pass_ext_plain`` for CPU tensors. Both round every
operation once, so on one input they agree bitwise. The pass updates the
lane state in place and returns it with the pass's emissions and stats.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
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
    STATS_ROWS,
)

TWO23 = 8388608.0  # 2^23


class ExtLaneState(NamedTuple):
    """Persistent per-lane df32 sampler state, (R, 128) each (the JAX
    layout, same names and order)."""

    kr: torch.Tensor  # f32 holding the 24-bit real-axis grid index
    ki: torch.Tensor  # f32 holding the 24-bit imag-axis grid index
    crh: torch.Tensor  # df32 c (real)
    crl: torch.Tensor
    cih: torch.Tensor  # df32 c (imag)
    cil: torch.Tensor
    zr: torch.Tensor  # df32 orbit position (real)
    zrl: torch.Tensor
    zi: torch.Tensor  # df32 orbit position (imag)
    zil: torch.Tensor
    sr: torch.Tensor  # f32 Brent saved point (hi components)
    si: torch.Tensor
    it: torch.Tensor  # i32 completed updates of current sample
    sv: torch.Tensor  # i32 next Brent save index
    dead: torch.Tensor  # i32 1 => refill at next step (culled / initial)
    vis: torch.Tensor  # i32 1 => trajectory entered the visit window


#: The int32 fields of both lane states; every other field is float32.
I32_FIELDS = ("it", "sv", "dead", "vis")


def init_ext_lane_state(lane_rows: int, device="cpu") -> ExtLaneState:
    """All lanes start dead: the first step of the first pass draws."""
    shape = (lane_rows, 128)

    def f(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    def i(v):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    return ExtLaneState(
        kr=f(0.0), ki=f(0.0),
        crh=f(0.0), crl=f(0.0), cih=f(0.0), cil=f(0.0),
        zr=f(0.0), zrl=f(0.0), zi=f(0.0), zil=f(0.0),
        sr=f(BIG), si=f(BIG),
        it=i(0), sv=i(SAVE0), dead=i(1), vis=i(0),
    )


def grid_params(sample_domain) -> tuple:
    """((crh, crl), (cih, cil), step_r, step_i): the df32 window-center
    constants and the f32 grid pitches (f64 Python arithmetic, then one
    rounding to f32). Shared by the classify pass and the replay, so c is
    rebuilt the same everywhere."""
    r0, r1, i0, i1 = (float(v) for v in sample_domain)
    center_r = df32.from_float((r0 + r1) / 2.0)
    center_i = df32.from_float((i0 + i1) / 2.0)
    step_r = float(np.float32((r1 - r0) * 2.0**-24))
    step_i = float(np.float32((i1 - i0) * 2.0**-24))
    return center_r, center_i, step_r, step_i


def grid_sample(center, k, step):
    """c = center (+) (k - 2^23) * step in df32: the sample at grid index
    ``k`` (f32 tensor). ``center`` is a (hi, lo) pair of 0-dim f32 tensors
    and ``step`` a 0-dim f32 tensor (tensor operands: one rounded product,
    no scalar rewrite). Returns (hi, lo, off)."""
    off = (k - TWO23) * step
    hi, lo = df32.add_f(center[0], center[1], off)
    return hi, lo, off


class ExtClassifyResult(NamedTuple):
    state: ExtLaneState
    emit_c: torch.Tensor  # (chunks, 2, R, 128) f32: grid indices (kr, ki)
    emit_it: torch.Tensor  # (chunks, R, 128) i32 escape index, -1 empty
    stats: torch.Tensor  # (STATS_ROWS, R, 128) i32 per-lane pass counters


def classify_pass_ext(
    state: ExtLaneState,
    seed: tuple[int, int],
    bits: torch.Tensor | None = None,
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
    visit_window: tuple | None = None,
) -> ExtClassifyResult:
    """Run one extended-precision classify pass of ``steps_per_pass``
    lane-steps: the contract of ``classify.classify_pass`` with df32 orbit
    state and grid-index emissions.

    ``seed``: the (k0, k1) Threefry key words (uint32).
    ``bits``: (chunks, windows, 2, R, 128) int32 tensor of uint32 bit
    patterns replacing Threefry, given iff ``rng == "bits"``.
    """
    if steps_per_pass % steps_per_flush != 0:
        raise ValueError("steps_per_pass must be a multiple of steps_per_flush")
    if steps_per_flush % inner_unroll != 0:
        raise ValueError("steps_per_flush must be a multiple of inner_unroll")
    if rng is None:
        rng = "bits" if bits is not None else "threefry"
    if rng in ("hardware", "hardware_rw"):
        raise ValueError(
            f"rng {rng} draws from the TPU's hardware generator; this "
            "package refills from threefry or given bits"
        )
    if rng not in ("threefry", "bits"):
        raise ValueError(f"Unknown rng mode: {rng}")
    if (rng == "bits") != (bits is not None):
        raise ValueError("bits must be supplied iff rng == 'bits'")
    chunks = steps_per_pass // steps_per_flush
    windows = steps_per_flush // inner_unroll
    lane_rows = state.kr.shape[0]
    if bits is not None:
        if tuple(bits.shape) != (chunks, windows, 2, lane_rows, 128):
            raise ValueError(f"bits has wrong shape {tuple(bits.shape)}")
        if bits.dtype != torch.int32:
            raise ValueError("bits must be an int32 tensor of uint32 words")
    spec = dict(
        fractal=fractal, min_it=min_it, max_it=max_it, chunks=chunks,
        windows=windows, unroll=inner_unroll,
        detect=bool(cycle_detection and fractal.cycle_detect),
        sample_domain=tuple(float(v) for v in sample_domain),
        visit_window=visit_window,
    )
    k0, k1 = (int(w) & prng.MASK32 for w in seed)
    if state.kr.device.type == "cpu":
        return classify_pass_ext_plain(state, k0, k1, bits, **spec)
    return _classify_ext_cuda(state, k0, k1, bits, **spec)


def _check_state(state: ExtLaneState) -> None:
    shape = state.kr.shape
    for name, t in zip(ExtLaneState._fields, state):
        want = torch.int32 if name in I32_FIELDS else torch.float32
        if t.dtype != want or t.shape != shape or not t.is_contiguous():
            raise ValueError(
                f"lane state field {name}: want contiguous {want} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != state.kr.device:
            raise ValueError("lane state fields lie on different devices")


def _classify_ext_cuda(state, k0, k1, bits, *, fractal, min_it, max_it,
                       chunks, windows, unroll, detect, sample_domain,
                       visit_window) -> ExtClassifyResult:
    _check_state(state)
    dev = state.kr.device
    rows = state.kr.shape[0]
    lanes = rows * 128
    lib = _lib()
    emit_c = torch.empty((chunks, 2, rows, 128), dtype=torch.float32,
                         device=dev)
    emit_it = torch.empty((chunks, rows, 128), dtype=torch.int32, device=dev)
    stats = torch.empty((STATS_ROWS, rows, 128), dtype=torch.int32,
                        device=dev)
    if bits is not None:
        bits = bits.to(dev).contiguous()
    ptrs = (ctypes.c_void_p * 20)(
        *(t.data_ptr() for t in state),
        emit_c.data_ptr(), emit_it.data_ptr(), stats.data_ptr(),
        bits.data_ptr() if bits is not None else None,
    )
    c0r, c0i, step_r, step_i = grid_params(sample_domain)
    vw = visit_window or (0.0, 0.0, 0.0, 0.0)
    iargs = (ctypes.c_int * 9)(
        fractal.kernel_id, int(visit_window is not None), lanes, chunks,
        windows, unroll, min_it, max_it, int(detect),
    )
    fargs = (ctypes.c_float * 10)(*c0r, *c0i, step_r, step_i, *vw)
    with torch.cuda.device(dev):
        rc = lib.cb_classify_ext(ptrs, iargs, fargs, k0, k1,
                                 _build.stream_of(state.kr))
    _build.check(rc, "classify_ext kernel")
    launches.COUNTS["classify_ext"] += 1
    return ExtClassifyResult(state, emit_c, emit_it, stats)


def _lib():
    lib = _build.load("classify_ext")
    if lib.cb_classify_ext.argtypes is None:
        lib.cb_classify_ext.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.cb_classify_ext.restype = ctypes.c_int
    return lib


def classify_pass_ext_plain(state, k0, k1, bits, *, fractal, min_it, max_it,
                            chunks, windows, unroll, detect, sample_domain,
                            visit_window) -> ExtClassifyResult:
    """The kernel's function in plain PyTorch, all lanes as one vector:
    one elementwise op per arithmetic operation (single rounding), the
    window loop in Python. The refill draws of a chunk are computed for
    every lane and window at once (the kernel draws only on a refill; the
    generator is counter-based, so the words are the same)."""
    launches.COUNTS["classify_ext_plain"] += 1
    _check_state(state)
    dev = state.kr.device
    shape = state.kr.shape
    n = state.kr.numel()
    (kr, ki, crh, crl, cih, cil, zr, zrl, zi, zil, sr, si, it, sv, dead,
     vis) = (t.reshape(-1).clone() for t in state)
    i32 = torch.int32
    big, four = prng.f32(BIG, dev), prng.f32(4.0, dev)
    c0r, c0i, step_r, step_i = grid_params(sample_domain)
    c0r = tuple(prng.f32(v, dev) for v in c0r)
    c0i = tuple(prng.f32(v, dev) for v in c0i)
    step_r, step_i = prng.f32(step_r, dev), prng.f32(step_i, dev)
    lane_id = torch.arange(n, dtype=torch.int64, device=dev)
    if bits is not None:
        words = bits.to(dev).reshape(chunks, windows, 2, n).to(torch.int64)
        words = words & prng.MASK32
    if visit_window is not None:
        vx0, vx1, vy0, vy1 = (prng.f32(v, dev) for v in visit_window)
    p_kr = torch.zeros(n, dtype=torch.float32, device=dev)
    p_ki = torch.zeros_like(p_kr)
    p_it = torch.full((n,), -1, dtype=i32, device=dev)
    counts = torch.zeros((STATS_ROWS, n), dtype=i32, device=dev)
    emit_c = torch.empty((chunks, 2, n), dtype=torch.float32, device=dev)
    emit_it = torch.empty((chunks, n), dtype=i32, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    window_ids = torch.arange(windows, dtype=torch.int64, device=dev)
    for chunk in range(chunks):
        if bits is not None:
            rb_r, rb_i = words[chunk, :, 0], words[chunk, :, 1]
        else:
            rb_r, rb_i = prng.threefry2x32(
                k0, k1, lane_id[None, :],
                (chunk * windows + window_ids)[:, None],
            )
        # 24-bit grid indices: the top bits, exact in i32 and in f32.
        draw_kr = (rb_r >> 8).to(i32).to(torch.float32)
        draw_ki = (rb_i >> 8).to(i32).to(torch.float32)
        draw_crh, draw_crl, off_r = grid_sample(c0r, draw_kr, step_r)
        draw_cih, draw_cil, off_i = grid_sample(c0i, draw_ki, step_i)
        # The cull runs on the f32 approximation of c.
        draw_cull = cull_mask(fractal, c0r[0] + off_r, c0i[0] + off_i)
        for w in range(windows):
            azr, azrl, azi, azil = zr, zrl, zi, zil
            nesc = torch.zeros(n, dtype=i32, device=dev)
            hit = no
            for _ in range(unroll):
                azr, azrl, azi, azil, mag2 = df32.complex_sqr_add(
                    azr, azrl, azi, azil, crh, crl, cih, cil,
                    fold_abs=fractal.fold_abs,
                )
                # `<= 4` so the NaNs an escaped lane coasts into count as
                # escaped.
                nesc = nesc + (mag2 <= four).to(i32)
                if visit_window is not None:
                    hit = hit | ((azr >= vx0) & (azr < vx1)
                                 & (azi >= vy0) & (azi < vy1))
            if visit_window is not None:
                vis = vis | hit.to(i32)
            esc = nesc < unroll
            needed = it + nesc
            cyc = ((azr == sr) & (azi == si) & ~esc) if detect else no

            it_new = it + unroll
            maxed = it_new >= max_it
            deadb = dead != 0
            fin = esc | cyc | maxed | deadb
            if fractal.emit == "interior":
                esc_in_cap = esc & (needed < max_it)
                in_band = (cyc | maxed) & ~esc_in_cap & ~deadb
                band_it = torch.full_like(it, max_it - 1)
            else:
                in_band = esc & ~deadb & (needed >= min_it) & (needed < max_it)
                band_it = needed
            if visit_window is not None:
                in_band = in_band & (vis != 0)
            p_kr = torch.where(in_band, kr, p_kr)
            p_ki = torch.where(in_band, ki, p_ki)
            p_it = torch.where(in_band, band_it, p_it)

            if detect:
                at_save = (it_new >= sv) & ~fin
                sr2 = torch.where(at_save, azr, sr)
                si2 = torch.where(at_save, azi, si)
                sv2 = torch.where(at_save, sv * 2, sv)
            else:
                sr2, si2, sv2 = sr, si, sv

            ncull = draw_cull[w]
            kr = torch.where(fin, draw_kr[w], kr)
            ki = torch.where(fin, draw_ki[w], ki)
            crh = torch.where(fin, draw_crh[w], crh)
            crl = torch.where(fin, draw_crl[w], crl)
            cih = torch.where(fin, draw_cih[w], cih)
            cil = torch.where(fin, draw_cil[w], cil)
            # z starts at c (cudabrot.cu:323-324): the df32 copy.
            zr = torch.where(fin, draw_crh[w], azr)
            zrl = torch.where(fin, draw_crl[w], azrl)
            zi = torch.where(fin, draw_cih[w], azi)
            zil = torch.where(fin, draw_cil[w], azil)
            it = torch.where(fin, 0, it_new).to(i32)
            sr = torch.where(fin, big, sr2)
            si = torch.where(fin, big, si2)
            sv = torch.where(fin, SAVE0, sv2).to(i32)
            dead = torch.where(fin, ncull.to(i32), dead)
            if visit_window is not None:
                vis = torch.where(fin, 0, vis).to(i32)

            counts[STAT_DRAWN] += fin.to(i32)
            counts[STAT_CULLED] += (fin & ncull).to(i32)
            counts[STAT_IN_BAND] += in_band.to(i32)
            counts[STAT_CYCLES] += (cyc & ~deadb).to(i32)
            counts[STAT_WASTED] += torch.where(deadb, unroll, 0).to(i32)
            counts[STAT_WASTED] += torch.where(
                esc & ~deadb, it_new - needed - 1, 0
            ).to(i32)

        emit_c[chunk, 0] = p_kr
        emit_c[chunk, 1] = p_ki
        emit_it[chunk] = p_it
        p_kr = p_kr * 0.0
        p_ki = p_ki * 0.0
        p_it = torch.full_like(p_it, -1)

    new = (kr, ki, crh, crl, cih, cil, zr, zrl, zi, zil, sr, si, it, sv,
           dead, vis)
    for dst, src in zip(state, new):
        dst.copy_(src.view(shape))
    rows = shape[0]
    return ExtClassifyResult(
        state,
        emit_c.view(chunks, 2, rows, 128),
        emit_it.view(chunks, rows, 128),
        counts.view(STATS_ROWS, rows, 128),
    )
