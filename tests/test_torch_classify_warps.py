"""The f32 classify kernel's warps, built for the CPU, against the plain
version.

csrc/classify.cu runs S lanes per thread (S = 1, 2 or 4) and compacts the
refills of a warp: its finished lanes queue their ids at the slots
``classify.cuh refill_slot`` gives them and the warp computes the queued
Threefry draws in full passes. Its warps take the pass as a queue of
(lane group, slice) items in slice-major order, a slice being a run of
whole windows (``classify.cuh slice_plan``: 64 windows and more, on passes
of 2,048 windows and more); at a slice's ends the lanes' state, counters
and pending emissions go through the arrays.
``host_harness.cpp`` emulates those items with the same lane functions
(g++, one rounding per operation), the groups of each slice in a shuffled
order, so the lane-to-thread mapping, the slot function, the draw each
finished lane reads back and the hand-over at every slice end (on chunk
ends and inside chunks) are held here bitwise against
``classify_pass_plain``: lane state, emissions and stats, for every S and
the kernel's variants. The card holds the kernel itself to the same plain
version (tests/test_torch_cuda.py, chip_smoke.py);
tests/test_torch_classify.py holds the plain version against the JAX
Pallas kernel.
"""

import ctypes

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cudabrot_tpu_torch import config
from cudabrot_tpu_torch.models.fractals import FRACTALS
from cudabrot_tpu_torch.ops import classify as cls
from tests.test_torch_df32 import FP, harness  # noqa: F401  (fixture)

torch.set_num_threads(1)

ROWS = 4  # 512 lanes

VARIANTS = [
    # name, fractal, thin, unroll, band, visit window
    ("buddhabrot-thin", "buddhabrot", True, 1, (20, 100), None),
    ("step-tracking", "buddhabrot", False, 2, (5, 200), None),
    ("burning-ship", "burning-ship", True, 4, (5, 200), None),
    ("anti-buddhabrot", "anti-buddhabrot", True, 1, (0, 64), None),
    ("visit-window", "buddhabrot", True, 2, (5, 200),
     (-1.5, 0.5, -1.0, 1.0)),
]

#: (chunks, windows) of a pass, short enough for the plain version here and
#: cut as slice_plan cuts a longer one, into slices of 64 windows: 2 chunks
#: of 128 inside the chunks and on the chunk end, 8 chunks of 64 on chunk
#: ends only, 3 chunks of 100 at odd places (the last slice 44 windows).
PLANS = {"2x128": (2, 128), "8x64": (8, 64), "3x100": (3, 100)}
SLICE = 64


def _harness_pass(harness, state, seed, per_thread, fr, thin, unroll, band,  # noqa: F811
                  visit, *, chunks, windows, detect=None, bits=None,
                  order=1, slice_len=SLICE):
    """One pass of the emulated kernel on numpy copies of ``state``, the
    groups of each slice in the order ``order`` shuffles them (0: in turn),
    cut into slices of ``slice_len`` windows (0: as slice_plan cuts it);
    returns the arrays (lane state, emit_c, emit_it, stats)."""
    lanes = ROWS * 128
    arrays = [t.numpy().reshape(-1).copy() for t in state]
    emit_c = np.empty((chunks, 2, lanes), np.float32)
    emit_it = np.empty((chunks, lanes), np.int32)
    stats = np.empty((cls.STATS_ROWS, lanes), np.int32)
    words = None if bits is None else np.ascontiguousarray(bits.numpy())
    ptrs = (ctypes.c_void_p * 16)(
        *(a.ctypes.data for a in (*arrays, emit_c, emit_it, stats)),
        None if words is None else words.ctypes.data, None, None)
    if detect is None:
        detect = fr.cycle_detect
    iargs = (ctypes.c_int * 13)(
        fr.kernel_id, int(thin), int(visit is not None), lanes, chunks,
        windows, unroll, band[0], band[1], int(detect), per_thread, order,
        slice_len)
    r0, r1, i0, i1 = config.SAMPLE_DOMAIN
    fargs = (ctypes.c_float * 8)(r0, r1 - r0, i0, i1 - i0,
                                 *(visit or (0.0,) * 4))
    harness.cbh_classify.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), FP,
        ctypes.c_uint32, ctypes.c_uint32]
    assert harness.cbh_classify(ptrs, iargs, fargs, *seed) == 0
    return arrays, emit_c, emit_it, stats


def _check_against_plain(harness, per_thread, frac, thin, unroll, band,  # noqa: F811
                         visit, chunks, windows, order, detect=True,
                         use_bits=False, slice_len=SLICE):
    fr = FRACTALS[frac]
    flush = windows * unroll
    kw = dict(fractal=fr, min_it=band[0], max_it=band[1],
              steps_per_pass=chunks * flush, steps_per_flush=flush,
              inner_unroll=unroll, thin_tracking=thin, visit_window=visit,
              cycle_detection=detect)
    state = cls.init_lane_state(ROWS)
    cls.classify_pass(state, (5, 6), **kw)  # a carried, mid-flight state
    bits = None
    if use_bits:
        gen = torch.Generator().manual_seed(chunks * 1000 + windows)
        bits = torch.randint(-2**31, 2**31, (chunks, windows, 2, ROWS, 128),
                             dtype=torch.int32, generator=gen)
    want = cls.classify_pass(cls.LaneState(*(t.clone() for t in state)),
                             (7, 8), bits, **kw)
    arrays, emit_c, emit_it, stats = _harness_pass(
        harness, state, (7, 8), per_thread, fr, thin, unroll, band, visit,
        chunks=chunks, windows=windows, detect=detect and fr.cycle_detect,
        bits=bits, order=order, slice_len=slice_len)
    for f, a, w in zip(cls.LaneState._fields, arrays, want.state):
        assert a.tobytes() == w.numpy().tobytes(), f
    assert emit_c.tobytes() == want.emit_c.numpy().tobytes()
    assert emit_it.tobytes() == want.emit_it.numpy().tobytes()
    assert stats.tobytes() == want.stats.numpy().tobytes()
    assert stats[cls.STAT_DRAWN].sum() > 0 and (emit_it >= 0).sum() > 0
    return stats


@pytest.mark.parametrize("per_thread", [1, 2, 4])
@pytest.mark.parametrize("name,frac,thin,unroll,band,visit", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_compacted_warps_match_plain(harness, per_thread, name, frac, thin,  # noqa: F811
                                     unroll, band, visit):
    for chunks, windows in PLANS.values():
        _check_against_plain(harness, per_thread, frac, thin, unroll, band,
                             visit, chunks, windows,
                             order=per_thread * 7 + 1)


@pytest.mark.parametrize("order", [0, 3])
@pytest.mark.parametrize("unroll", [1, 3, 8])
@pytest.mark.parametrize("detect,use_bits", [(True, False), (False, False),
                                             (True, True)],
                         ids=["threefry", "no-cycles", "bits"])
def test_sliced_warps_match_plain(harness, unroll, detect, use_bits, order):  # noqa: F811
    """The kernel's warps at S = 2 over the slice plans, in turn and
    shuffled: unrolled windows of 1 and 8 and a window of 3 (the kernel's
    runtime loop), cycle detection on and off, and bits mode."""
    for chunks, windows in PLANS.values():
        stats = _check_against_plain(
            harness, 2, "buddhabrot", True, unroll, (5, 200), None, chunks,
            windows, order, detect=detect, use_bits=use_bits)
        if not detect:
            assert stats[cls.STAT_CYCLES].sum() == 0


def test_sliced_warps_match_plain_past_the_slice_cap(harness):  # noqa: F811
    """A pass of 4,200 windows as slice_plan cuts it, into 64 slices of 66
    (the cap on the slices a pass), shuffled, at S = 2."""
    _check_against_plain(harness, 2, "buddhabrot", True, 1, (20, 100), None,
                         1, 4200, order=11, slice_len=0)


def _slice_plan(harness, chunks, windows):  # noqa: F811
    out = np.zeros(2, np.int32)
    harness.cbh_slice_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    assert harness.cbh_slice_plan(chunks, windows, out.ctypes.data) == 0
    return int(out[0]), int(out[1])


@pytest.mark.parametrize("chunks,windows,want", [
    (32, 128, (64, 64)),  # canvas1k.default, dp4, hires15k.coarse
    (1, 512, (512, 1)),  # canvas1k.cutoff2000, hires15k.medium
    (1, 8192, (128, 64)),  # hires15k.fine
    (2, 128, (256, 1)), (8, 64, (512, 1)), (1, 1, (1, 1)),
    (1, 2047, (2047, 1)), (1, 2048, (64, 32)), (1, 4200, (66, 64)),
    (40, 130, (82, 64)),
])
def test_slice_plan_cuts_every_pass_into_whole_windows(harness, chunks,  # noqa: F811
                                                       windows, want):
    """The cells' plans cut as the design says, and every plan's slices
    cover its windows once: a pass of fewer than 2,048 windows whole, a
    longer one into slices of 64 windows, or more where it would have more
    than 64 slices."""
    length, count = _slice_plan(harness, chunks, windows)
    assert (length, count) == want
    total = chunks * windows
    assert (count - 1) * length < total <= count * length
    assert (count == 1) == (total < 2048)
    assert count == 1 or (count <= 64 and (length == 64 or count == 64))


@settings(max_examples=60, deadline=None, database=None)
@given(per_thread=st.sampled_from([1, 2, 4]),
       masks=st.lists(st.integers(0, 2**32 - 1), min_size=4, max_size=4))
def test_refill_slots_are_a_permutation(harness, per_thread, masks):  # noqa: F811
    """Every finished (thread, sub-lane) pair of a warp gets its own slot,
    and the F pairs fill 0..F-1 exactly."""
    m = np.asarray(masks[:per_thread], np.uint32)
    slots = np.empty(32 * per_thread, np.int32)
    harness.cbh_refill_slots.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    assert harness.cbh_refill_slots(per_thread, m.ctypes.data,
                                    slots.ctypes.data) == 0
    fin = ((m[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
    taken = slots[fin.reshape(-1)]
    assert (slots[~fin.reshape(-1)] == -1).all()
    assert sorted(taken.tolist()) == list(range(int(fin.sum())))
