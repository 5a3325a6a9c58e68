"""The f32 Metropolis-Hastings classify kernel's warps, built for the CPU,
against the plain version.

csrc/classify_mh.cu runs S lanes per thread and compacts the boundary
draws of a warp: its finished lanes queue their ids at the slots
``classify.cuh refill_slot`` gives them, the warp computes the two
Threefry-2x32 blocks of each (``mh.cuh mh_block``) in full passes, and each
finished lane reads its four words back and resolves (``mh_resolve``).
``host_harness.cpp`` emulates those warps with the same lane functions
(g++, one rounding per operation), so the lane-to-thread mapping, the slot
function and the words each finished lane reads back are held here
bitwise against ``classify_pass_mh_plain``: lane state, the emission
buffers and the 8 stat rows, for reservoir widths 2, 8 and 32, the three
fractals, cycle detection on and off, drawn and injected words, and every
build of the kernel: one lane a thread with the chain's reservoirs (xb,
p_b) in columns of shared memory and the window unrolled at compile time
(the package's), two lanes a thread (S = 2), all reservoirs in registers,
all three in shared memory, and the window as a run-time loop. The df32 kernel runs the same lane functions one thread a lane
(``classify_mh_lane``, tests/test_torch_classify_mh.py). The card
holds the kernel itself to the same plain version (tests/test_torch_cuda.py,
chip_smoke.py); tests/test_torch_classify_mh.py holds the plain version
against the JAX Pallas kernel.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import classify_mh as cmh
from tests.test_torch_classify_mh import CROP, FULL, _bits
from tests.test_torch_df32 import FP, harness  # noqa: F401  (fixture)

torch.set_num_threads(1)

ROWS, STEPS, FLUSH, UNROLL = 2, 512, 128, 4  # 256 lanes
CHUNKS, WINDOWS = STEPS // FLUSH, FLUSH // UNROLL
CANVAS = (40, 37)

CASES = {
    # fractal, domain, window, band, slots, cycle detection, rng
    "crop-v8": ("buddhabrot", FULL, CROP, (20, 300), 8, True, "threefry"),
    "full-v2-nodetect-bits": ("buddhabrot", FULL, FULL, (5, 200), 2, False,
                              "bits"),
    "wide-v32": ("buddhabrot", FULL, (-1.5, 0.5, -1.0, 1.0), (5, 200), 32,
                 True, "threefry"),
    "ship-v8-nodetect": ("burning-ship", FULL, (-1.8, -1.6, -0.1, 0.1),
                         (20, 300), 8, False, "threefry"),
    "anti-v32": ("anti-buddhabrot", FULL, (-0.6, 0.1, -0.4, 0.3), (0, 64),
                 32, True, "threefry"),
}
#: The kernel's builds: lanes per thread, reservoirs in shared memory and
#: the window unrolled at compile time (csrc/classify_mh.cu
#: CB_MH_LANES_PER_THREAD, CB_MH_SHARED_SLOTS, CB_MH_WINDOW_UNROLL; the
#: emulation unrolls the package's window, its other builds run the loop).
BUILDS = {"package": (1, 1, 1), "two-lanes": (2, 1, 0),
          "registers": (1, 0, 0), "shared-all": (1, 2, 0),
          "window-loop": (1, 1, 0)}


def _args(case):
    name, domain, window, band, slots, detect, _ = CASES[case]
    wx0, wx1, wy0, wy1 = window
    return dict(
        fractal=tfr.FRACTALS[name], min_it=band[0], max_it=band[1],
        chunks=CHUNKS, windows=WINDOWS, unroll=UNROLL, detect=detect,
        sample_domain=domain,
        window=(wx0, wx1, wy0, wy1, CANVAS[0] / (wx1 - wx0),
                CANVAS[1] / (wy1 - wy0)),
        restart256=16, rep_cap=24, canvas_wh=CANVAS)


@functools.lru_cache(maxsize=None)
def _plain(case):
    """A carried mid-flight lane state, the words (None: Threefry), and
    the plain version's pass from it."""
    *_, slots, _, rng = CASES[case]
    state = cmh.init_mh_lane_state(ROWS, slots)
    cmh.classify_pass_mh_plain(False, state, 5, 6, None, **_args(case))
    bits = _bits(9, CHUNKS, WINDOWS, ROWS) if rng == "bits" else None
    want = cmh.classify_pass_mh_plain(
        False, type(state)(*(t.clone() for t in state)), 7, 8,
        None if bits is None else torch.from_numpy(bits.view(np.int32)),
        **_args(case))
    return state, bits, want


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_compacted_mh_warps_match_plain(harness, case, build):  # noqa: F811
    _, _, _, band, slots, detect, _ = CASES[case]
    per_thread, shared, unrolled = BUILDS[build]
    state, bits, want = _plain(case)
    a = _args(case)
    lanes = ROWS * 128
    arrays = [t.numpy().reshape(-1).copy() for t in state]
    i32 = np.int32
    emit = [np.empty((CHUNKS, lanes), i32) for _ in range(3)]
    emit_b = np.empty((CHUNKS, slots, lanes), i32)
    stats = np.empty((cmh.MH_STATS_ROWS, lanes), i32)
    outs = (*arrays, *emit, emit_b, stats)
    ptrs = (ctypes.c_void_p * (len(outs) + 1))(
        *(x.ctypes.data for x in outs),
        None if bits is None else bits.ctypes.data)
    iargs = (ctypes.c_int * 16)(
        a["fractal"].kernel_id, slots, lanes, CHUNKS, WINDOWS, UNROLL,
        band[0], band[1], int(detect), 16, 24, *CANVAS, per_thread, shared,
        unrolled)
    fargs = (ctypes.c_float * 12)(
        *cmh._grid_constants(False, a["sample_domain"]), *a["window"])
    harness.cbh_classify_mh_warps.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), FP,
        ctypes.c_uint32, ctypes.c_uint32]
    assert harness.cbh_classify_mh_warps(ptrs, iargs, fargs, 7, 8) == 0
    for f, x, w in zip(state._fields, arrays, want.state):
        assert x.tobytes() == w.numpy().tobytes(), f
    for f, x, w in zip(("emit_it", "emit_rep", "emit_v"), emit,
                       (want.emit_it, want.emit_rep, want.emit_v)):
        assert x.tobytes() == w.numpy().tobytes(), f
    assert emit_b.tobytes() == want.emit_bins.numpy().tobytes()
    assert stats.tobytes() == want.stats.numpy().tobytes()
    assert stats[cmh.STAT_MH_ACCEPT].sum() > 0
    assert (emit[0] >= 0).sum() > 0
