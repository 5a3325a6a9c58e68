"""The df32 classify kernel's warps, built for the CPU, against the plain
version.

csrc/classify_ext.cu runs S lanes per thread (S = 1 or 2), the window
unrolled at compile time, and splits the boundary: every lane takes
``classify_ext.cuh ext_window`` (the U df32 updates, the finish test, the
counter and the Brent save), the warp votes (``__any_sync``), and only a
warp with a finished lane runs ``ext_finish`` (band filter, pending
emission, stats, refill) for its finished lanes. ``host_harness.cpp``
emulates those warps with the same lane functions (g++, one rounding per
operation, the FFMA two-products through ``std::fmaf``), so the
lane-to-thread mapping, the vote's skip and the split boundary are held
here bitwise against ``classify_pass_ext_plain``: lane state, emissions
and stats, at U = 1 and 4, unrolled and as a run-time loop, for S = 1 and
2. The card holds the kernel itself to the same plain version
(tests/test_torch_cuda.py, chip_smoke.py); tests/test_torch_classify_ext.py
holds the plain version against the JAX Pallas kernel.
"""

import ctypes

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch import config
from cudabrot_tpu_torch.models.fractals import FRACTALS
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.ops import classify_ext as cx
from tests.test_torch_df32 import FP, harness  # noqa: F401  (fixture)

torch.set_num_threads(1)

ROWS = 3  # 384 lanes: at S = 2 the last warp's second lanes are dead
CHUNKS = 2

#: A seahorse-valley deep zoom (orbits of ~1000 steps: most warp-windows
#: have no finished lane), one just outside the set, a burning-ship crop,
#: the anti-Buddhabrot with a visit window.
DEEP = (-0.743643887037151 - 1e-7, -0.743643887037151 + 1e-7,
        0.131825904205330 - 1e-7, 0.131825904205330 + 1e-7)
VARIANTS = {
    # fractal, sample domain, band, visit window, windows per chunk, steps
    # of the carried state
    "deep": ("buddhabrot", DEEP, (50, 3000), None, 128, 2048),
    "fast-visit": ("buddhabrot", (-0.75 - 5e-7, -0.75 + 5e-7,
                                  0.055 - 5e-7, 0.055 + 5e-7), (20, 400),
                   (-1.5, 0.5, -1.0, 1.0), 32, 256),
    "ship": ("burning-ship", (-1.7548 - 5e-7, -1.7548 + 5e-7,
                              -0.0338 - 5e-7, -0.0338 + 5e-7), (5, 500),
             None, 32, 256),
    "anti-visit": ("anti-buddhabrot", config.SAMPLE_DOMAIN, (0, 64),
                   (-0.6, 0.1, -0.4, 0.3), 32, 256),
}


@pytest.mark.parametrize("window", ["unrolled", "loop"])
@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("per_thread", [1, 2])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ext_warps_match_plain(harness, variant, per_thread, unroll,  # noqa: F811
                               window):
    name, domain, band, visit, windows, carried = VARIANTS[variant]
    fr = FRACTALS[name]
    flush = windows * unroll
    kw = dict(fractal=fr, min_it=band[0], max_it=band[1],
              steps_per_pass=CHUNKS * flush, steps_per_flush=flush,
              inner_unroll=unroll, sample_domain=domain, visit_window=visit)
    state = cx.init_ext_lane_state(ROWS)
    # A carried, mid-flight state.
    cx.classify_pass_ext(state, (5, 6), **dict(
        kw, steps_per_pass=carried, steps_per_flush=carried))
    want = cx.classify_pass_ext(
        cx.ExtLaneState(*(t.clone() for t in state)), (7, 8), **kw)

    lanes = ROWS * 128
    arrays = [t.numpy().reshape(-1).copy() for t in state]
    emit_c = np.empty((CHUNKS, 2, lanes), np.float32)
    emit_it = np.empty((CHUNKS, lanes), np.int32)
    stats = np.empty((cls.STATS_ROWS, lanes), np.int32)
    ptrs = (ctypes.c_void_p * 20)(
        *(a.ctypes.data for a in (*arrays, emit_c, emit_it, stats)), None)
    c0r, c0i, step_r, step_i = cx.grid_params(domain)
    iargs = (ctypes.c_int * 11)(
        fr.kernel_id, int(visit is not None), lanes, CHUNKS, windows,
        unroll, band[0], band[1], int(fr.cycle_detect), per_thread,
        int(window == "unrolled"))
    fargs = (ctypes.c_float * 10)(*c0r, *c0i, step_r, step_i,
                                  *(visit or (0.0,) * 4))
    harness.cbh_classify_ext_warps.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), FP,
        ctypes.c_uint32, ctypes.c_uint32]
    assert harness.cbh_classify_ext_warps(ptrs, iargs, fargs, 7, 8) == 0
    for f, a, w in zip(cx.ExtLaneState._fields, arrays, want.state):
        assert a.tobytes() == w.numpy().tobytes(), f
    assert emit_c.tobytes() == want.emit_c.numpy().tobytes()
    assert emit_it.tobytes() == want.emit_it.numpy().tobytes()
    assert stats.tobytes() == want.stats.numpy().tobytes()
    assert stats[cls.STAT_DRAWN].sum() > 0 and (emit_it >= 0).sum() > 0


def test_ext_warps_skip_most_windows_at_a_deep_zoom():
    """At the deep zoom most warp-windows have no finished lane, so the
    vote skips the rest of their boundary: the share of (warp, window)
    pairs with a finish, from one-window passes of the plain version, is
    small at U = 1 (and the emulation above runs such windows)."""
    name, domain, band, _, _, carried = VARIANTS["deep"]
    kw = dict(fractal=FRACTALS[name], min_it=band[0], max_it=band[1],
              steps_per_pass=1, steps_per_flush=1, inner_unroll=1,
              sample_domain=domain)
    state = cx.init_ext_lane_state(ROWS)
    cx.classify_pass_ext(state, (5, 6), **dict(
        kw, steps_per_pass=carried, steps_per_flush=carried))
    fins = []
    for w in range(64):
        r = cx.classify_pass_ext(state, (7, w), **kw)
        fins.append(r.stats[cls.STAT_DRAWN].reshape(-1, 32).sum(-1) > 0)
    share = float(torch.stack(fins).float().mean())
    assert 0.0 < share < 0.5, share
