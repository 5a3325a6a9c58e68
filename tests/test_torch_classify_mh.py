"""The Metropolis-Hastings classify passes of cudabrot_tpu_torch: the plain
versions against the JAX Pallas kernels (interpret mode), and the CUDA
sources' lane function (csrc/mh.cuh, built with g++) against the plain
versions, bitwise.

Against JAX. Both packages draw the same Threefry words (or take the same
injected bits), so restarts install the same grid indices and the same c.
But the JAX kernel runs jitted on XLA's CPU backend, which contracts
``r2 + i2``, the cull and the df32 error sums into fused multiply-adds and
flushes denormals, and a chain is a feedback loop: one borderline escape
that finishes a window apart changes every later proposal of that lane. So
one short pass from the initial state is compared, with the measured share
of equal lanes stated beside each floor (the orbit position itself differs
in its last bits for about half the lanes after two windows), and the
integer quantities that do not depend on the orbit (the LCG state, the
restart installs in bits mode) are held exactly.

Against the g++ build. ``host_harness.cpp`` runs the lane functions of
``csrc/mh.cuh`` (``mh_window``, ``mh_advance``, ``mh_block``,
``mh_resolve``) one lane a thread over the lanes, with the reservoirs in
registers and each finished lane drawing its own words (the kernels' warps
and builds: tests/test_torch_classify_mh_warps.py). g++ with
``-ffp-contract=off`` rounds every operation once, as ``__fmul_rn`` and
``__fadd_rn`` do on the device, so lane state, emissions and stats must
equal the plain version bit for bit, at f32 and df32, for every fractal and
reservoir width, from a carried mid-flight state.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.models import fractals as jfr
from cudabrot_tpu.ops import pallas_kernels_mh as pkm
from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import classify_mh as cmh
from cudabrot_tpu_torch.ops import launches
from tests.test_torch_df32 import FP, harness  # noqa: F401  (fixture)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

FULL = (-2.0, 2.0, -2.0, 2.0)
#: The seahorse crop of tests/test_mh.py and its band.
CROP = (-0.78, -0.72, 0.05, 0.11)
_CX, _CY = -0.743643887, 0.131825904


def _deep(span):
    """(sample domain, centre-relative window) of a deep crop whose domain
    is 4x the window, as tests/test_mh.py sizes it."""
    dom = (_CX - 2 * span, _CX + 2 * span, _CY - 2 * span, _CY + 2 * span)
    c_r = (dom[0] + dom[1]) / 2.0
    c_i = (dom[2] + dom[3]) / 2.0
    h = span / 2.0
    return dom, (_CX - h - c_r, _CX + h - c_r, _CY - h - c_i, _CY + h - c_i)


def _bits(seed, chunks, windows, rows):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, (chunks, windows, 4, rows, 128), dtype=np.uint64
    ).astype(np.uint32)


# ----------------------------------------------------------------------
# Against the JAX kernels.

JAX_CASES = [
    # ext, fractal, domain, window, band, steps, flush, rng, chain floor
    # (measured), slot floor over the slots valid in either package
    # (measured share of the measured count of such slots; None where the
    # pass emits too few for a share to mean anything), stat tolerance
    (False, "buddhabrot", FULL, CROP, (20, 300), 256, 64, "threefry",
     0.95, None, 0.03),    # 0.975; 7 of 7
    (False, "buddhabrot", FULL, FULL, (5, 200), 128, 32, "bits",
     0.97, 0.99, 0.03),    # 0.990; 0.9986 of 722
    (False, "burning-ship", FULL, (-1.8, -1.6, -0.1, 0.1), (20, 300), 256,
     64, "threefry", 0.85, None, 0.03),    # 0.896; 0 of 1
    (False, "anti-buddhabrot", FULL, (-0.6, 0.1, -0.4, 0.3), (0, 64), 256,
     64, "threefry", 0.85, 0.85, 0.06),    # 0.896; 0.8894 of 841
    (True, "buddhabrot", *_deep(1e-2), (20, 300), 256, 64, "threefry",
     0.97, None, 0.03),    # 0.992; 2 of 2
    # df32 passes that emit: the whole domain as the window, so every
    # in-band orbit visits and every retiring tenure is an emission.
    (True, "buddhabrot", FULL, FULL, (5, 200), 128, 32, "bits",
     0.98, 0.99, 0.03),    # 0.998; 1.0 of 722
    (True, "buddhabrot", FULL, FULL, (5, 200), 256, 64, "threefry",
     0.97, 0.99, 0.03),    # 0.990; 0.9992 of 1180
    # The deep-zoom geometry: a 2e-5 window over a domain 4x as wide (and a
    # 1e-3 one). Nearly every sample there is a long chaotic orbit, so the
    # chain fields are held after a pass of 256 steps, where most lanes have
    # not yet met a borderline escape ...
    (True, "buddhabrot", *_deep(2e-5), (100, 3000), 256, 64, "threefry",
     0.85, None, 0.03),    # 0.8945; no emission yet in either package
    (True, "buddhabrot", *_deep(1e-3), (50, 1000), 256, 64, "bits",
     0.93, None, 0.03),    # 0.9629; no emission yet in either package
    # ... and after 2048 and 1024 steps, where the chain fields are equal
    # for only 24-63% of the lanes, the totals alone (6 and 14 slots valid
    # in either package, equal in 0 and in 10 of them).
    (True, "buddhabrot", *_deep(2e-5), (100, 3000), 2048, 256, "threefry",
     None, None, 0.05),
    (True, "buddhabrot", *_deep(1e-3), (50, 1000), 1024, 256, "bits",
     None, None, 0.05),
    # The chain fields of those two long cases' geometry (flush window 256,
    # their generators), held where the chains still agree: one 256-step
    # window.
    (True, "buddhabrot", *_deep(2e-5), (100, 3000), 256, 256, "threefry",
     0.85, None, 0.03),    # 0.8945; no emission yet in either package
    (True, "buddhabrot", *_deep(1e-3), (50, 1000), 256, 256, "bits",
     0.93, None, 0.03),    # 0.9629; no emission yet in either package
]
#: Compared bitwise between the packages: the chain, the proposal's grid
#: index and its bookkeeping. The orbit position and the Brent point carry
#: XLA's contraction in their last bits from the first step on.
CHAIN_FIELDS = ("kr", "ki", "it", "sv", "dead", "vcnt", "xkr", "xki", "xv",
                "xit", "rep")


@pytest.mark.parametrize(
    "ext,name,domain,window,band,steps,flush,rng,chain_floor,slot_floor,"
    "stat_tol", JAX_CASES)
def test_pass_matches_jax_kernel(ext, name, domain, window, band, steps,
                                 flush, rng, chain_floor, slot_floor,
                                 stat_tol):
    """One pass of 1024 lanes from the initial state, inner window 4.
    Held exactly: the LCG state (it advances once per inner step whatever
    the orbit does). Held by measured share: each chain field bitwise equal
    for at least ``chain_floor`` of the lanes; of the emission slots valid
    in either package, at least ``slot_floor`` equal as a whole (escape
    index, rep, target) -- empty slots, equal in both, do not count; the
    recorded bins of slots valid in both with the same target equal for
    >= 85% of them (measured 99.1-100% over 7 to 1180 such slots, and 9
    of 10). The two packages' emission counts agree within 10% or 4, and
    the per-pass stat totals within ``stat_tol`` or 10 counts. The deep
    windows' 2048- and 1024-step passes hold totals only; at their flush
    window of 256 steps every chain field is equal for >= 0.85 (2e-5
    window, measured 0.8945) and >= 0.93 (1e-3 window, measured 0.9629) of
    the lanes."""
    rows, unroll, slots = 4, 4, 8
    kw = dict(min_it=band[0], max_it=band[1], steps_per_pass=steps,
              steps_per_flush=flush, inner_unroll=unroll,
              sample_domain=domain, window=window, restart256=16, rep_cap=64,
              canvas_wh=(40, 40))
    seed = (0x9E3779B9, 0x7F4A7C15)
    bits = None
    if rng == "bits":
        bits = _bits(4, steps // flush, flush // unroll, rows)
    if ext:
        j0, jfn = pkm.init_ext_mh_lane_state(rows, slots), \
            pkm.classify_pass_ext_mh
        t0, tfn = cmh.init_ext_mh_lane_state(rows, slots), \
            cmh.classify_pass_ext_mh
    else:
        j0, jfn = pkm.init_mh_lane_state(rows, slots), pkm.classify_pass_mh
        t0, tfn = cmh.init_mh_lane_state(rows, slots), cmh.classify_pass_mh
    ref = jfn(j0, jnp.asarray(seed, jnp.uint32),
              None if bits is None else jnp.asarray(bits),
              fractal=jfr.FRACTALS[name], interpret=True, rng=rng, **kw)
    launches.reset()
    got = tfn(t0, seed,
              None if bits is None else torch.from_numpy(bits.view(np.int32)),
              fractal=tfr.FRACTALS[name], rng=rng, **kw)
    plain = "classify_ext_mh_plain" if ext else "classify_mh_plain"
    assert launches.COUNTS[plain] == 1
    assert launches.COUNTS[plain[:-6]] == 0

    np.testing.assert_array_equal(got.state.rsv.numpy(),
                                  np.asarray(ref.state.rsv))
    for f in got.state._fields:
        a = np.asarray(getattr(ref.state, f))
        b = getattr(got.state, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if chain_floor is not None and f in CHAIN_FIELDS:
            share = (a.view(np.int32) == b.view(np.int32)).mean()
            assert share >= chain_floor, (f, share)
    jit, tit = np.asarray(ref.emit_it), got.emit_it.numpy()
    same_slot = ((jit == tit)
                 & (np.asarray(ref.emit_rep) == got.emit_rep.numpy())
                 & (np.asarray(ref.emit_v) == got.emit_v.numpy()))
    either = (jit >= 0) | (tit >= 0)
    n_j, n_t = int((jit >= 0).sum()), int((tit >= 0).sum())
    assert abs(n_j - n_t) <= max(4, 0.1 * max(n_j, n_t)), (n_j, n_t)
    if slot_floor is not None:
        assert either.sum() >= 500, either.sum()
        share = same_slot[either].mean()
        assert share >= slot_floor, share
    both = (jit >= 0) & (tit >= 0) & same_slot
    if both.any():
        jb = np.moveaxis(np.asarray(ref.emit_bins), 1, -1)[both]
        tb = np.moveaxis(got.emit_bins.numpy(), 1, -1)[both]
        n_rec = np.minimum((got.emit_v.numpy()[both] - 1) // 256, slots)
        live = np.arange(slots)[None] < n_rec[:, None]
        same_bins = ((jb == tb) | ~live).all(axis=1)
        assert same_bins.mean() >= 0.85, same_bins.mean()
        assert (tb[live] >= 0).all() and (tb[live] < 1600).all()
    ref_st = np.asarray(ref.stats).sum(axis=(1, 2))
    got_st = got.stats.numpy().sum(axis=(1, 2))
    np.testing.assert_allclose(got_st, ref_st, rtol=stat_tol, atol=10)
    assert got_st[cmh.STAT_MH_ACCEPT] > 0


@pytest.mark.parametrize("ext", [False, True])
def test_bits_injection_restart_install(ext):
    """With known randomness the first boundary seeds every lane with a
    forced uniform restart: kr/ki are the words' top 24 bits, c is rebuilt
    with the exact draw arithmetic, chains stay unseeded (the dead first
    resolution rejects) with rep 1. Every field equals the JAX kernel's bit
    for bit: nothing here depends on an orbit."""
    rows = 2
    bits = _bits(7, 1, 1, rows)
    if ext:
        domain, window = _deep(2e-5)
        jst, jfn = pkm.init_ext_mh_lane_state(rows), pkm.classify_pass_ext_mh
        tst, tfn = cmh.init_ext_mh_lane_state(rows), cmh.classify_pass_ext_mh
    else:
        domain, window = FULL, CROP
        jst, jfn = pkm.init_mh_lane_state(rows), pkm.classify_pass_mh
        tst, tfn = cmh.init_mh_lane_state(rows), cmh.classify_pass_mh
    kw = dict(min_it=2, max_it=1 << 20, steps_per_pass=4, steps_per_flush=4,
              inner_unroll=4, rng="bits", sample_domain=domain, window=window,
              restart256=16, rep_cap=64)
    ref = jfn(jst, jnp.asarray([0, 0], jnp.uint32), jnp.asarray(bits),
              fractal=jfr.FRACTALS["buddhabrot"], interpret=True, **kw)
    got = tfn(tst, (0, 0), torch.from_numpy(bits.view(np.int32)),
              fractal=tfr.FRACTALS["buddhabrot"], **kw)
    st = got.state
    np.testing.assert_array_equal(st.kr.numpy(),
                                  (bits[0, 0, 0] >> 8).astype(np.float32))
    np.testing.assert_array_equal(st.ki.numpy(),
                                  (bits[0, 0, 1] >> 8).astype(np.float32))
    if not ext:
        inv24 = np.float32(5.9604644775390625e-08)
        want_cr = (st.kr.numpy() * inv24 * np.float32(4.0)
                   + np.float32(-2.0))
        np.testing.assert_array_equal(st.cr.numpy(), want_cr)
        np.testing.assert_array_equal(st.zr.numpy(), st.cr.numpy())
    assert (st.xv.numpy() == 0).all()
    assert (st.rep.numpy() == 1).all()
    assert (st.it.numpy() == 0).all()
    for f in st._fields:
        np.testing.assert_array_equal(
            getattr(st, f).numpy().view(np.int32),
            np.asarray(getattr(ref.state, f)).view(np.int32), err_msg=f)
    stats = got.stats.numpy()
    np.testing.assert_array_equal(stats, np.asarray(ref.stats))
    assert stats[cmh.STAT_DRAWN].sum() == rows * 128
    assert stats[cmh.STAT_MH_ACCEPT].sum() == 0
    assert (got.emit_it.numpy() < 0).all()


def test_chain_state_consistency_after_many_windows():
    """Structural invariants after a multi-window run (the port's form of
    the JAX test of the same name): seeded chains carry a valid escape
    index and a positive rep below the cap; emissions carry positive reps,
    in-band escape indices, bridge-form targets and canvas-valid bins."""
    rows = 4
    res = cmh.classify_pass_mh(
        cmh.init_mh_lane_state(rows), (3, 4),
        fractal=tfr.FRACTALS["buddhabrot"], min_it=5, max_it=200,
        steps_per_pass=2048, steps_per_flush=64, inner_unroll=4,
        sample_domain=FULL, window=FULL, restart256=16, rep_cap=32)
    st = res.state
    xv, xit, rep = st.xv.numpy(), st.xit.numpy(), st.rep.numpy()
    seeded = xv > 0
    assert seeded.any()
    assert (xit[seeded] >= 5).all() and (xit[seeded] < 200).all()
    assert (rep[seeded] >= 1).all() and (rep[seeded] < 32).all()
    stats = res.stats.numpy()
    assert stats[cmh.STAT_MH_ACCEPT].sum() >= seeded.sum()
    em_it, em_rep = res.emit_it.numpy(), res.emit_rep.numpy()
    valid = em_it >= 0
    assert valid.any()
    assert (em_rep[valid] >= 1).all()
    assert (em_it[valid] >= 5).all() and (em_it[valid] < 200).all()
    em_v = res.emit_v.numpy()
    assert ((em_v[valid] - 1) % 256 == 0).all() and (em_v[valid] > 1).all()
    assert (em_rep[~valid] == 0).all() and (em_v[~valid] == 0).all()
    slots = res.emit_bins.shape[1]
    n_rec = np.minimum((em_v[valid] - 1) // 256, slots)
    bins_v = np.moveaxis(res.emit_bins.numpy(), 1, -1)[valid]
    live = bins_v[np.arange(slots)[None] < n_rec[:, None]]
    assert (live >= 0).all() and (live < 1000 * 1000).all()
    for f, t in zip(st._fields, st):
        if t.dtype == torch.float32:
            assert bool(torch.isfinite(t).all()), f


def test_classify_mh_validation():
    fr = tfr.FRACTALS["buddhabrot"]
    kw = dict(fractal=fr, min_it=5, max_it=60, steps_per_pass=64,
              steps_per_flush=32)
    st = cmh.init_mh_lane_state
    with pytest.raises(ValueError, match="multiple of steps_per_flush"):
        cmh.classify_pass_mh(st(1), (1, 2), **{**kw, "steps_per_pass": 48})
    with pytest.raises(ValueError, match="multiple of inner_unroll"):
        cmh.classify_pass_mh(st(1), (1, 2), **kw, inner_unroll=5)
    with pytest.raises(ValueError, match="restart256"):
        cmh.classify_pass_mh(st(1), (1, 2), **kw, restart256=300)
    with pytest.raises(ValueError, match="rep_cap"):
        cmh.classify_pass_mh(st(1), (1, 2), **kw, rep_cap=1)
    with pytest.raises(ValueError, match="visit_slots"):
        cmh.classify_pass_mh(st(1, 6), (1, 2), **kw)
    with pytest.raises(ValueError, match="hardware generator"):
        cmh.classify_pass_ext_mh(cmh.init_ext_mh_lane_state(1), (1, 2), **kw,
                                 rng="hardware")
    with pytest.raises(ValueError, match="Unknown rng"):
        cmh.classify_pass_mh(st(1), (1, 2), **kw, rng="dice")
    with pytest.raises(ValueError, match="iff rng == 'bits'"):
        cmh.classify_pass_mh(st(1), (1, 2), **kw, rng="bits")
    with pytest.raises(ValueError, match="bits has wrong shape"):
        cmh.classify_pass_mh(st(1), (1, 2),
                             torch.zeros((1, 2, 2), dtype=torch.int32), **kw)
    bad = st(1)._replace(xb=torch.zeros((8, 1, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="lane state field xb"):
        cmh.classify_pass_mh(bad, (1, 2), **kw)


# ----------------------------------------------------------------------
# The CUDA sources' lane function, built with g++, against the plain
# versions.

HARNESS_CASES = [
    # ext, fractal, domain, window, band, slots, rng
    (False, "buddhabrot", FULL, CROP, (20, 300), 8, "threefry"),
    (False, "buddhabrot", FULL, FULL, (5, 200), 2, "bits"),
    (False, "buddhabrot", FULL, (-1.5, 0.5, -1.0, 1.0), (5, 200), 32,
     "threefry"),
    (False, "burning-ship", FULL, (-1.8, -1.6, -0.1, 0.1), (20, 300), 4,
     "threefry"),
    (False, "anti-buddhabrot", FULL, (-0.6, 0.1, -0.4, 0.3), (0, 64), 16,
     "threefry"),
    (True, "buddhabrot", *_deep(2e-5), (100, 3000), 8, "threefry"),
    (True, "buddhabrot", *_deep(1e-3), (50, 1000), 4, "bits"),
    (True, "buddhabrot", *_deep(1e-2), (20, 300), 32, "threefry"),
    (True, "burning-ship", (-1.7648, -1.7448, -0.0438, -0.0238),
     (-0.005, 0.005, -0.005, 0.005), (5, 500), 2, "threefry"),
    (True, "anti-buddhabrot", FULL, (-0.6, 0.1, -0.4, 0.3), (0, 64), 16,
     "bits"),
]


@pytest.mark.parametrize("ext,name,domain,window,band,slots,rng",
                         HARNESS_CASES)
def test_header_classify_mh_lane_bitwise(harness, ext, name, domain,  # noqa: F811
                                         window, band, slots, rng):
    rows, steps, flush, unroll = 2, 1024, 128, 4
    if ext and band[1] > 1000:
        steps, flush = 4096, 256
    chunks, windows = steps // flush, flush // unroll
    fr = tfr.FRACTALS[name]
    kw = dict(fractal=fr, min_it=band[0], max_it=band[1],
              steps_per_pass=steps, steps_per_flush=flush,
              inner_unroll=unroll, sample_domain=domain, window=window,
              restart256=16, rep_cap=24, canvas_wh=(40, 37))
    init = cmh.init_ext_mh_lane_state if ext else cmh.init_mh_lane_state
    fn = cmh.classify_pass_ext_mh if ext else cmh.classify_pass_mh
    state = init(rows, slots)
    fn(state, (5, 6), **kw)  # a mid-flight start
    bits = _bits(9, chunks, windows, rows) if rng == "bits" else None
    want = fn(type(state)(*(t.clone() for t in state)), (7, 8),
              None if bits is None else torch.from_numpy(bits.view(np.int32)),
              **kw)

    lanes = rows * 128
    arrays = [t.numpy().reshape(-1).copy() for t in state]
    i32 = np.int32
    emit = [np.empty((chunks, lanes), i32) for _ in range(3)]
    emit_b = np.empty((chunks, slots, lanes), i32)
    stats = np.empty((cmh.MH_STATS_ROWS, lanes), i32)
    outs = (*arrays, *emit, emit_b, stats)
    ptrs = (ctypes.c_void_p * (len(outs) + 1))(
        *(a.ctypes.data for a in outs),
        None if bits is None else bits.ctypes.data)
    iargs = (ctypes.c_int * 13)(
        fr.kernel_id, slots, lanes, chunks, windows, unroll, band[0],
        band[1], int(fr.cycle_detect), 16, 24, 40, 37)
    wx0, wx1, wy0, wy1 = window
    fargs = (ctypes.c_float * 12)(
        *cmh._grid_constants(ext, domain), wx0, wx1, wy0, wy1,
        40 / (wx1 - wx0), 37 / (wy1 - wy0))
    harness.cbh_classify_mh.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), FP, ctypes.c_uint32, ctypes.c_uint32]
    assert harness.cbh_classify_mh(int(ext), ptrs, iargs, fargs, 7, 8) == 0
    for f, a, w in zip(state._fields, arrays, want.state):
        assert a.tobytes() == w.numpy().tobytes(), f
    for f, a, w in zip(("emit_it", "emit_rep", "emit_v"), emit,
                       (want.emit_it, want.emit_rep, want.emit_v)):
        assert a.tobytes() == w.numpy().tobytes(), f
    assert emit_b.tobytes() == want.emit_bins.numpy().tobytes()
    assert stats.tobytes() == want.stats.numpy().tobytes()
    assert (emit[0] >= 0).sum() > 0
    assert stats[cmh.STAT_MH_ACCEPT].sum() > 0
