"""The f32 classify kernel's warps, built for the CPU, against the plain
version.

csrc/classify.cu runs S lanes per thread (S = 1, 2 or 4) and compacts the
refills of a warp: its finished lanes queue their ids at the slots
``classify.cuh refill_slot`` gives them and the warp computes the queued
Threefry draws in full passes. ``host_harness.cpp`` emulates those warps
with the same lane functions (g++, one rounding per operation), so the
lane-to-thread mapping, the slot function and the draw each finished lane
reads back are held here bitwise against ``classify_pass_plain``: lane
state, emissions and stats, for every S and five kernel variants. The card
holds the kernel itself to the same plain version (tests/test_torch_cuda.py,
chip_smoke.py); tests/test_torch_classify.py holds the plain version
against the JAX Pallas kernel.
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
CHUNKS, WINDOWS = 2, 32

VARIANTS = [
    # name, fractal, thin, unroll, band, visit window
    ("buddhabrot-thin", "buddhabrot", True, 1, (20, 100), None),
    ("step-tracking", "buddhabrot", False, 2, (5, 200), None),
    ("burning-ship", "burning-ship", True, 4, (5, 200), None),
    ("anti-buddhabrot", "anti-buddhabrot", True, 1, (0, 64), None),
    ("visit-window", "buddhabrot", True, 2, (5, 200),
     (-1.5, 0.5, -1.0, 1.0)),
]


def _harness_pass(harness, state, seed, per_thread, fr, thin, unroll, band,  # noqa: F811
                  visit):
    """One pass of the emulated kernel on numpy copies of ``state``;
    returns the arrays (lane state, emit_c, emit_it, stats)."""
    lanes = ROWS * 128
    arrays = [t.numpy().reshape(-1).copy() for t in state]
    emit_c = np.empty((CHUNKS, 2, lanes), np.float32)
    emit_it = np.empty((CHUNKS, lanes), np.int32)
    stats = np.empty((cls.STATS_ROWS, lanes), np.int32)
    ptrs = (ctypes.c_void_p * 14)(
        *(a.ctypes.data for a in (*arrays, emit_c, emit_it, stats)), None)
    iargs = (ctypes.c_int * 11)(
        fr.kernel_id, int(thin), int(visit is not None), lanes, CHUNKS,
        WINDOWS, unroll, band[0], band[1], int(fr.cycle_detect), per_thread)
    r0, r1, i0, i1 = config.SAMPLE_DOMAIN
    fargs = (ctypes.c_float * 8)(r0, r1 - r0, i0, i1 - i0,
                                 *(visit or (0.0,) * 4))
    harness.cbh_classify.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), FP,
        ctypes.c_uint32, ctypes.c_uint32]
    assert harness.cbh_classify(ptrs, iargs, fargs, *seed) == 0
    return arrays, emit_c, emit_it, stats


@pytest.mark.parametrize("per_thread", [1, 2, 4])
@pytest.mark.parametrize("name,frac,thin,unroll,band,visit", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_compacted_warps_match_plain(harness, per_thread, name, frac, thin,  # noqa: F811
                                     unroll, band, visit):
    fr = FRACTALS[frac]
    flush = WINDOWS * unroll
    kw = dict(fractal=fr, min_it=band[0], max_it=band[1],
              steps_per_pass=CHUNKS * flush, steps_per_flush=flush,
              inner_unroll=unroll, thin_tracking=thin, visit_window=visit)
    state = cls.init_lane_state(ROWS)
    cls.classify_pass(state, (5, 6), **kw)  # a carried, mid-flight state
    want = cls.classify_pass(cls.LaneState(*(t.clone() for t in state)),
                             (7, 8), **kw)
    arrays, emit_c, emit_it, stats = _harness_pass(
        harness, state, (7, 8), per_thread, fr, thin, unroll, band, visit)
    for f, a, w in zip(cls.LaneState._fields, arrays, want.state):
        assert a.tobytes() == w.numpy().tobytes(), f
    assert emit_c.tobytes() == want.emit_c.numpy().tobytes()
    assert emit_it.tobytes() == want.emit_it.numpy().tobytes()
    assert stats.tobytes() == want.stats.numpy().tobytes()
    assert stats[cls.STAT_DRAWN].sum() > 0 and (emit_it >= 0).sum() > 0


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
