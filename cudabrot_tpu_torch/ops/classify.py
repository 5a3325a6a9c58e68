"""Persistent-lane classify pass: the CUDA kernel and its plain version.

Port of ``cudabrot_tpu/ops/pallas_kernels.py`` (``LaneState``,
``init_lane_state``, ``_make_kernel``, ``classify_pass``). Every lane is an
independent sampler that refills from Threefry-2x32 the moment its sample
finishes, so orbits of any length cost no idle lanes, and lane state
persists across passes so no orbit is truncated. The semantics, layouts
and stats are the JAX kernel's; ``csrc/classify.cu`` says how the kernel
maps them onto Hopper.

``classify_pass`` launches the CUDA kernel for CUDA tensors and runs
``classify_pass_plain`` for CPU tensors. Both round every operation once,
so on one input they agree bitwise. The pass updates the lane state in
place (the JAX version donates it) and returns it with the pass's
emissions and per-lane stats.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cudabrot_tpu_torch.config import SAMPLE_DOMAIN
from cudabrot_tpu_torch.models.fractals import FractalMap, cull_mask
from cudabrot_tpu_torch.ops import _build, launches, prng

#: First Brent checkpoint index; doubles after every save.
SAVE0 = 16
#: Sentinel "never matches" value for the saved cycle point.
BIG = 1.0e30

STATS_ROWS = 5
STAT_DRAWN, STAT_CULLED, STAT_IN_BAND, STAT_CYCLES, STAT_WASTED = range(
    STATS_ROWS
)

class LaneState(NamedTuple):
    """Persistent per-lane sampler state, (R, 128) each (the JAX layout)."""

    cr: torch.Tensor  # f32 current sample
    ci: torch.Tensor
    zr: torch.Tensor  # f32 current orbit position
    zi: torch.Tensor
    sr: torch.Tensor  # f32 Brent saved point
    si: torch.Tensor
    it: torch.Tensor  # i32 completed updates of current sample
    sv: torch.Tensor  # i32 next Brent save index
    dead: torch.Tensor  # i32 1 => refill at next step (culled / initial)
    vis: torch.Tensor  # i32 1 => trajectory entered the visit window


_F32_FIELDS = ("cr", "ci", "zr", "zi", "sr", "si")


def init_lane_state(lane_rows: int, device="cpu") -> LaneState:
    """All lanes start dead: the first step of the first pass draws."""
    shape = (lane_rows, 128)

    def f(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    def i(v):
        return torch.full(shape, v, dtype=torch.int32, device=device)

    return LaneState(
        cr=f(0.0), ci=f(0.0), zr=f(0.0), zi=f(0.0), sr=f(BIG), si=f(BIG),
        it=i(0), sv=i(SAVE0), dead=i(1), vis=i(0),
    )


class ClassifyResult(NamedTuple):
    state: LaneState
    emit_c: torch.Tensor  # (chunks, 2, R, 128) f32 candidate c values
    emit_it: torch.Tensor  # (chunks, R, 128) i32 escape index, -1 empty
    stats: torch.Tensor  # (STATS_ROWS, R, 128) i32 per-lane pass counters


def classify_pass(
    state: LaneState,
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
    thin_tracking: bool = False,
    sample_domain: tuple = SAMPLE_DOMAIN,
    visit_window: tuple | None = None,
) -> ClassifyResult:
    """Run one classify pass of ``steps_per_pass`` lane-steps.

    ``seed``: the (k0, k1) Threefry key words (uint32).
    ``bits``: optional (chunks, windows, 2, R, 128) int32 tensor of uint32
    bit patterns that replaces Threefry (the JAX kernel's ``rng="bits"``,
    for tests driving both with known randomness).
    """
    if steps_per_pass % steps_per_flush != 0:
        raise ValueError("steps_per_pass must be a multiple of steps_per_flush")
    if steps_per_flush % inner_unroll != 0:
        raise ValueError("steps_per_flush must be a multiple of inner_unroll")
    if visit_window is not None and not thin_tracking:
        raise ValueError("visit_window requires thin_tracking")
    chunks = steps_per_pass // steps_per_flush
    windows = steps_per_flush // inner_unroll
    lane_rows = state.cr.shape[0]
    if bits is not None:
        if tuple(bits.shape) != (chunks, windows, 2, lane_rows, 128):
            raise ValueError(f"bits has wrong shape {tuple(bits.shape)}")
        if bits.dtype != torch.int32:
            raise ValueError("bits must be an int32 tensor of uint32 words")
    spec = dict(
        fractal=fractal, min_it=min_it, max_it=max_it, chunks=chunks,
        windows=windows, unroll=inner_unroll, thin=thin_tracking,
        detect=bool(cycle_detection and fractal.cycle_detect),
        sample_domain=tuple(float(v) for v in sample_domain),
        visit_window=visit_window,
    )
    k0, k1 = (int(w) & prng.MASK32 for w in seed)
    if state.cr.device.type == "cpu":
        return classify_pass_plain(state, k0, k1, bits, **spec)
    return _classify_cuda(state, k0, k1, bits, **spec)


def _check_state(state: LaneState) -> None:
    shape = state.cr.shape
    for name, t in zip(LaneState._fields, state):
        want = torch.float32 if name in _F32_FIELDS else torch.int32
        if t.dtype != want or t.shape != shape or not t.is_contiguous():
            raise ValueError(
                f"lane state field {name}: want contiguous {want} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != state.cr.device:
            raise ValueError("lane state fields lie on different devices")


def _classify_cuda(state, k0, k1, bits, *, fractal, min_it, max_it, chunks,
                   windows, unroll, thin, detect, sample_domain,
                   visit_window) -> ClassifyResult:
    _check_state(state)
    dev = state.cr.device
    rows = state.cr.shape[0]
    lanes = rows * 128
    lib = _lib()
    emit_c = torch.empty((chunks, 2, rows, 128), dtype=torch.float32,
                         device=dev)
    emit_it = torch.empty((chunks, rows, 128), dtype=torch.int32, device=dev)
    stats = torch.empty((STATS_ROWS, rows, 128), dtype=torch.int32,
                        device=dev)
    if bits is not None:
        bits = bits.to(dev).contiguous()
    ptrs = (ctypes.c_void_p * 14)(
        *(t.data_ptr() for t in state),
        emit_c.data_ptr(), emit_it.data_ptr(), stats.data_ptr(),
        bits.data_ptr() if bits is not None else None,
    )
    r0, r1, i0, i1 = sample_domain
    vw = visit_window or (0.0, 0.0, 0.0, 0.0)
    iargs = (ctypes.c_int * 10)(
        fractal.kernel_id, int(thin), int(visit_window is not None), lanes,
        chunks, windows, unroll, min_it, max_it, int(detect),
    )
    fargs = (ctypes.c_float * 8)(r0, r1 - r0, i0, i1 - i0, *vw)
    with torch.cuda.device(dev):
        rc = lib.cb_classify(ptrs, iargs, fargs, k0, k1,
                             _build.stream_of(state.cr))
        launches.COUNTS["classify"] += 1
    _build.check(rc, "classify kernel")
    return ClassifyResult(state, emit_c, emit_it, stats)


def _lib():
    lib = _build.load("classify")
    if lib.cb_classify.argtypes is None:
        lib.cb_classify.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.cb_classify.restype = ctypes.c_int
    return lib


def classify_pass_plain(state, k0, k1, bits, *, fractal, min_it, max_it,
                        chunks, windows, unroll, thin, detect, sample_domain,
                        visit_window) -> ClassifyResult:
    """The kernel's function in plain PyTorch, all lanes as one vector:
    one elementwise op per arithmetic operation (single rounding), the
    window loop in Python. Threefry words are computed for every lane and
    window of a chunk at once (the kernel draws only on a refill; the
    generator is counter-based, so the words are the same)."""
    launches.COUNTS["classify_plain"] += 1
    _check_state(state)
    dev = state.cr.device
    shape = state.cr.shape
    n = state.cr.numel()
    cr, ci, zr, zi, sr, si, it, sv, dead, vis = (
        t.reshape(-1).clone() for t in state
    )
    i32 = torch.int32
    big, four = prng.f32(BIG, dev), prng.f32(4.0, dev)
    r0, r1, i0, i1 = sample_domain
    lane_id = torch.arange(n, dtype=torch.int64, device=dev)
    if bits is not None:
        words = bits.to(dev).reshape(chunks, windows, 2, n).to(torch.int64)
        words = words & prng.MASK32
    if visit_window is not None:
        vx0, vx1, vy0, vy1 = (prng.f32(v, dev) for v in visit_window)
    p_cr = torch.zeros(n, dtype=torch.float32, device=dev)
    p_ci = torch.zeros_like(p_cr)
    p_it = torch.full((n,), -1, dtype=i32, device=dev)
    counts = torch.zeros((STATS_ROWS, n), dtype=i32, device=dev)
    emit_c = torch.empty((chunks, 2, n), dtype=torch.float32, device=dev)
    emit_it = torch.empty((chunks, n), dtype=i32, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    window_ids = torch.arange(windows, dtype=torch.int64, device=dev)
    for chunk in range(chunks):
        # This chunk's refill draws for every (window, lane), computed at
        # once: Threefry is counter-based, so each window's words do not
        # depend on the lanes' state.
        if bits is not None:
            rb_r, rb_i = words[chunk, :, 0], words[chunk, :, 1]
        else:
            rb_r, rb_i = prng.threefry2x32(
                k0, k1, lane_id[None, :],
                (chunk * windows + window_ids)[:, None],
            )
        draw_r = prng.u32_to_domain(rb_r, r0, r1 - r0)
        draw_i = prng.u32_to_domain(rb_i, i0, i1 - i0)
        draw_cull = cull_mask(fractal, draw_r, draw_i)
        for w in range(windows):
            azr, azi = zr, zi
            if thin:
                nesc = torch.zeros(n, dtype=i32, device=dev)
                r2, i2 = azr * azr, azi * azi
                hit = no
                for _ in range(unroll):
                    nzr = r2 - i2 + cr
                    if fractal.fold_abs:
                        nzi = 2.0 * torch.abs(azr * azi) + ci
                    else:
                        nzi = 2.0 * azr * azi + ci
                    azr, azi = nzr, nzi
                    r2, i2 = azr * azr, azi * azi
                    nesc = nesc + (r2 + i2 <= four).to(i32)
                    if visit_window is not None:
                        hit = hit | ((azr >= vx0) & (azr < vx1)
                                     & (azi >= vy0) & (azi < vy1))
                if visit_window is not None:
                    vis = vis | hit.to(i32)
                esc = nesc < unroll
                needed = it + nesc
                cyc = ((azr == sr) & (azi == si) & ~esc) if detect else no
            else:
                esc, cyc = no, no
                needed = torch.zeros(n, dtype=i32, device=dev)
                for k in range(unroll):
                    if fractal.fold_abs:
                        azr, azi = torch.abs(azr), torch.abs(azi)
                    azr, azi = azr * azr - azi * azi + cr, 2.0 * azr * azi + ci
                    newly = (azr * azr + azi * azi > four) & ~esc & ~cyc
                    needed = torch.where(newly, it + k, needed)
                    esc = esc | newly
                    if detect:
                        cyc = cyc | ((azr == sr) & (azi == si) & ~esc)

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
            p_cr = torch.where(in_band, cr, p_cr)
            p_ci = torch.where(in_band, ci, p_ci)
            p_it = torch.where(in_band, band_it, p_it)

            if detect:
                at_save = (it_new >= sv) & ~fin
                sr2 = torch.where(at_save, azr, sr)
                si2 = torch.where(at_save, azi, si)
                sv2 = torch.where(at_save, sv * 2, sv)
            else:
                sr2, si2, sv2 = sr, si, sv

            ncr, nci, ncull = draw_r[w], draw_i[w], draw_cull[w]

            cr = torch.where(fin, ncr, cr)
            ci = torch.where(fin, nci, ci)
            zr = torch.where(fin, ncr, azr)
            zi = torch.where(fin, nci, azi)
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

        emit_c[chunk, 0] = p_cr
        emit_c[chunk, 1] = p_ci
        emit_it[chunk] = p_it
        p_cr = p_cr * 0.0
        p_ci = p_ci * 0.0
        p_it = torch.full_like(p_it, -1)

    for dst, src in zip(state, (cr, ci, zr, zi, sr, si, it, sv, dead, vis)):
        dst.copy_(src.view(shape))
    rows = shape[0]
    return ClassifyResult(
        state,
        emit_c.view(chunks, 2, rows, 128),
        emit_it.view(chunks, rows, 128),
        counts.view(STATS_ROWS, rows, 128),
    )
