"""The Metropolis-Hastings classify kernels' warps, built for the CPU,
against the plain version.

csrc/classify_mh.cu runs both kernels (the f32 and the df32 orbit) in one
warp template: S lanes per thread, the window unrolled at compile time,
the reservoirs in registers or shared memory. The f32 kernel compacts the
boundary draws of a warp: its finished lanes queue their ids at the slots
``classify.cuh refill_slot`` gives them, the warp computes the two
Threefry-2x32 blocks of each (``mh.cuh mh_block``) in full passes, and each
finished lane reads its four words back and resolves (``mh_resolve``); the
df32 kernel compacts them the same way. ``host_harness.cpp`` emulates those warps with the same
lane functions (g++, one rounding per operation, the df32 product errors
through ``std::fmaf``), so the lane-to-thread mapping, the slot function
and the words each finished lane resolves with are held here bitwise
against ``classify_pass_mh_plain``: lane state, the emission buffers and
the 8 stat rows, for reservoir widths 2, 8 and 32, the three fractals,
cycle detection on and off, drawn and injected words, and every build of
each kernel: at f32 one lane a thread with the chain's reservoirs (xb,
p_b) in columns of shared memory and the window unrolled (the package's),
two lanes a thread (S = 2), all reservoirs in registers, all three in
shared memory, and the window as a run-time loop; at df32 all three
reservoirs in shared memory with the window unrolled (the package's), two
lanes a thread, the reservoirs in registers, the chain's two shared, and
the window as a loop. The card holds the kernels themselves
to the same plain version (tests/test_torch_cuda.py, chip_smoke.py);
tests/test_torch_classify_mh.py holds the plain version against the JAX
Pallas kernel.
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import classify_mh as cmh
from tests.test_torch_classify_mh import CROP, FULL, _bits, _deep
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
#: The df32 kernel's cases: deep seahorse-valley windows (domain 4x the
#: window, centre-relative window coordinates) and a burning-ship crop.
EXT_CASES = {
    "deep-v8": ("buddhabrot", *_deep(1e-3), (50, 1000), 8, True,
                "threefry"),
    "deep-v2-bits": ("buddhabrot", *_deep(1e-2), (20, 300), 2, True, "bits"),
    "ship-v32": ("burning-ship", (-1.7648, -1.7448, -0.0438, -0.0238),
                 (-0.005, 0.005, -0.005, 0.005), (5, 500), 32, False,
                 "threefry"),
}
#: The kernel's builds: lanes per thread, reservoirs in shared memory and
#: the window unrolled at compile time (csrc/classify_mh.cu
#: CB_MH_LANES_PER_THREAD, CB_MH_SHARED_SLOTS, CB_MH_WINDOW_UNROLL; the
#: emulation unrolls the package's window, its other builds run the loop).
BUILDS = {"package": (1, 1, 1), "two-lanes": (2, 1, 0),
          "registers": (1, 0, 0), "shared-all": (1, 2, 0),
          "window-loop": (1, 1, 0)}
#: The df32 kernel's builds (CB_MH_EXT_LANES_PER_THREAD,
#: CB_MH_EXT_SHARED_SLOTS, CB_MH_WINDOW_UNROLL): the package's has all
#: three reservoirs in shared memory.
EXT_BUILDS = {"package": (1, 2, 1), "two-lanes": (2, 2, 1),
              "registers": (1, 0, 1), "chain-shared": (1, 1, 1),
              "window-loop": (1, 2, 0)}


def _case(case):
    return EXT_CASES[case] if case in EXT_CASES else CASES[case]


def _args(case):
    name, domain, window, band, slots, detect, _ = _case(case)
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
    *_, slots, _, rng = _case(case)
    ext = case in EXT_CASES
    init = cmh.init_ext_mh_lane_state if ext else cmh.init_mh_lane_state
    state = init(ROWS, slots)
    cmh.classify_pass_mh_plain(ext, state, 5, 6, None, **_args(case))
    bits = _bits(9, CHUNKS, WINDOWS, ROWS) if rng == "bits" else None
    want = cmh.classify_pass_mh_plain(
        ext, type(state)(*(t.clone() for t in state)), 7, 8,
        None if bits is None else torch.from_numpy(bits.view(np.int32)),
        **_args(case))
    return state, bits, want


def _warps_pass(harness, case, build):  # noqa: F811
    """The emulated kernel's pass in ``build`` (per thread, shared,
    unrolled) from _plain(case)'s state, held bitwise to the plain
    version's."""
    _, _, _, band, slots, detect, _ = _case(case)
    per_thread, shared, unrolled = build
    ext = case in EXT_CASES
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
        *cmh._grid_constants(ext, a["sample_domain"]), *a["window"])
    harness.cbh_classify_mh_warps.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), FP, ctypes.c_uint32, ctypes.c_uint32]
    assert harness.cbh_classify_mh_warps(int(ext), ptrs, iargs, fargs, 7,
                                         8) == 0
    for f, x, w in zip(state._fields, arrays, want.state):
        assert x.tobytes() == w.numpy().tobytes(), f
    for f, x, w in zip(("emit_it", "emit_rep", "emit_v"), emit,
                       (want.emit_it, want.emit_rep, want.emit_v)):
        assert x.tobytes() == w.numpy().tobytes(), f
    assert emit_b.tobytes() == want.emit_bins.numpy().tobytes()
    assert stats.tobytes() == want.stats.numpy().tobytes()
    assert stats[cmh.STAT_MH_ACCEPT].sum() > 0
    assert (emit[0] >= 0).sum() > 0


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_compacted_mh_warps_match_plain(harness, case, build):  # noqa: F811
    _warps_pass(harness, case, BUILDS[build])


@pytest.mark.parametrize("build", sorted(EXT_BUILDS))
@pytest.mark.parametrize("case", sorted(EXT_CASES))
def test_ext_mh_warps_match_plain(harness, case, build):  # noqa: F811
    """The df32 kernel's warps (classify_ext_mh: the df32 orbit in the
    same warp template, its window unrolled at compile time) in each of
    its builds."""
    _warps_pass(harness, case, EXT_BUILDS[build])
