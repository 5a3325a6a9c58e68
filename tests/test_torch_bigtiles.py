"""The bigtiles route of cudabrot_tpu_torch (``--scatter bigtiles``: replay
to an id stream, sort, run-length deposit) on the CPU, against the JAX
package's bigtiles deposit and against the port's own fused route.

Bitwise throughout: the deposit is exact integer addition, so the port's
``scatter_bigtiles`` equals the JAX ``scatter_bigtiles`` (interpret mode,
both its variants) on the JAX test's cases, and the bigtiles route of the
engine equals its fused route in the histogram and every stat. Against the
JAX engine's bigtiles route the whole render is held by the statistical
criteria of ``test_torch_engine.test_whole_slice_statistical_vs_jax_engine``
(XLA's CPU backend contracts the JAX kernel's orbits into FMAs). The g++
build of the CUDA sources' id writers (the f32 kernel's staged warps,
``csrc/orbit.cuh``; ``classify_ext.cuh``) and run-length deposit
(``bigtiles.cuh``) is held to the plain versions bitwise.
"""

import ctypes
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.engines import pallas_engine as jpe
from cudabrot_tpu.ops import binning as jb
from cudabrot_tpu_torch import cli
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine, compact
from cudabrot_tpu_torch.models.fractals import FRACTALS
from cudabrot_tpu_torch.ops import binning, df32, launches
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.ops import classify_ext as cx
from tests.test_torch_df32 import FP, harness  # noqa: F401  (fixture)

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores.
torch.set_num_threads(1)

#: The JAX deposit test's histogram (tests/test_binning.py): 10 tiles of
#: 32768 bins at its tile_rows 256.
NBINS, TR = 300_000, 256
#: Just outside the set: every df32 sample escapes in ~56 steps.
FAST = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)


def _jax_cases():
    """The seven id streams of test_binning's bigtiles test."""
    rng = np.random.default_rng(3)
    p = 5000
    ids = np.concatenate([rng.integers(0, NBINS // 50, p // 2),
                          rng.integers(0, NBINS, p - p // 2)])
    ids[rng.random(p) < 0.1] = NBINS
    return [
        ids,                                               # mixed, sentinels
        np.linspace(0, NBINS - 1, 256 * 2, dtype=np.int32),   # many tiles
        np.full(256 * 3, 12345, np.int32),                 # one id, 3 chunks
        np.asarray([0, 1, NBINS, NBINS - 1], np.int32),    # under one chunk
        np.full(256, NBINS - 1, np.int32),                 # last tile only
        np.concatenate([np.arange(TR * 128 - 300, TR * 128, 2),
                        rng.integers(TR * 128 - 5000, TR * 128, 500)]),
        np.linspace(0, TR * 128 - 1, 128, dtype=np.int32),    # one group
    ]


CASES = _jax_cases()


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("mxu", [False, True])
def test_scatter_bigtiles_matches_jax(case, mxu):
    """The port's scatter_bigtiles (its plain version here) against the JAX
    kernel at the JAX test's geometry, interpret mode, from a random
    histogram: bitwise on every bin."""
    ids = CASES[case].astype(np.int32)
    hist0 = np.random.default_rng(case).integers(0, 5, NBINS).astype(
        np.uint32)
    want = np.asarray(jb.scatter_bigtiles(
        jnp.asarray(hist0), jnp.asarray(ids), tile_rows=TR, chunk=256,
        slots=4, unroll=4, mxu=mxu, interpret=True))
    got = torch.from_numpy(hist0.view(np.int32).copy())
    launches.reset()
    binning.scatter_bigtiles(got, torch.from_numpy(ids), chunk=256)
    assert launches.COUNTS["bigtiles_deposit_plain"] == 1
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # The first NBINS cells of the JAX kernel's padded layout, deposited
    # by bigtiles_deposit on the sorted stream: the same cells, the pad
    # (the sentinel's cell included) untouched.
    _, rows = jb.bigtiles_layout(NBINS)
    pad = torch.zeros(rows * 128, dtype=torch.int32)
    pad[:NBINS] = torch.from_numpy(hist0.view(np.int32))
    binning.bigtiles_deposit(pad[:NBINS], torch.sort(
        torch.from_numpy(ids)).values, chunk=256)
    np.testing.assert_array_equal(pad[:NBINS].numpy().view(np.uint32), want)
    assert not pad[NBINS:].any()


def test_select_scatter_backend():
    assert binning.select_scatter_backend("auto") == "fused"
    assert binning.select_scatter_backend("xla") == "fused"
    assert binning.select_scatter_backend("bigtiles") == "bigtiles"
    assert binning.select_scatter_backend("pallas") == "ids"
    assert binning.select_scatter_backend("sorted") == "bigtiles"
    for name in ("sort", "mosaic", "ids", "fused"):
        with pytest.raises(ValueError, match="Unknown scatter backend"):
            binning.select_scatter_backend(name)


def _f32_batch():
    """One compacted batch of a classify pass (512 lanes, default band)."""
    res = cls.classify_pass(
        cls.init_lane_state(4), (11, 12), fractal=FRACTALS["buddhabrot"],
        min_it=20, max_it=100, steps_per_pass=256, steps_per_flush=32,
        inner_unroll=1)
    return compact(res.emit_c, res.emit_it, (1, 2), 4096, 100)[:3]


def _ext_batch():
    """One compacted batch of a df32 classify pass over FAST."""
    res = cx.classify_pass_ext(
        cx.init_ext_lane_state(2), (11, 12), fractal=FRACTALS["buddhabrot"],
        min_it=20, max_it=400, steps_per_pass=512, steps_per_flush=32,
        inner_unroll=1, sample_domain=FAST)
    return compact(res.emit_c, res.emit_it, (1, 2), 4096, 400)[:3]


def _offsets(it):
    off, ends = binning.id_offsets(it)
    return off, int(ends[-1])


@pytest.mark.parametrize("ext", [False, True])
def test_sorted_id_stream_equals_fused_replay(ext):
    """replay_ids_plain -> sort -> bigtiles_deposit_plain on one compacted
    batch equals replay_deposit_plain bitwise, with the same hit count;
    every slot of the stream is written, sentinels off the canvas."""
    canvas = tcfg.Canvas(width=64, height=48)
    kw = dict(canvas=canvas, fractal=FRACTALS["buddhabrot"])
    if ext:
        kw["sample_domain"] = FAST
        xr, xi, it = _ext_batch()
        write, fused = binning.replay_ids_ext_plain, \
            binning.replay_deposit_ext_plain
    else:
        xr, xi, it = _f32_batch()
        write, fused = binning.replay_ids_plain, binning.replay_deposit_plain
    off, n = _offsets(it)
    assert int((it >= 0).sum()) > 50
    ids, hits = write(xr, xi, it, off, n, **kw)
    nbins = canvas.num_pixels
    assert ids.numel() == n and ((ids >= 0) & (ids <= nbins)).all()
    assert int(hits) == int((ids < nbins).sum()) > 0
    got = torch.zeros(nbins, dtype=torch.int32)
    binning.bigtiles_deposit_plain(got, torch.sort(ids).values)
    want = torch.zeros(nbins, dtype=torch.int32)
    assert int(fused(want, xr, xi, it, **kw)) == int(hits)
    assert torch.equal(got, want)
    # The whole route, split into groups by a small id budget.
    max_len = int(it.max()) + 1
    for budget in (0, max_len + n // 5, max_len + n // 2):
        h = torch.zeros(nbins, dtype=torch.int32)
        route = (binning.replay_id_stream_ext if ext
                 else binning.replay_id_stream)
        launches.reset()
        hits_b = route(h, xr, xi, it, max_len=max_len, budget=budget, **kw)
        assert int(hits_b) == int(hits) and torch.equal(h, want)
        groups = launches.COUNTS["bigtiles_deposit_plain"]
        assert groups == 1 if budget == 0 else groups > 1


def test_replay_bigtiles_budget_and_length_checks():
    canvas = tcfg.Canvas(width=64, height=48)
    kw = dict(canvas=canvas, fractal=FRACTALS["buddhabrot"])
    cr, ci, it = _f32_batch()
    hist = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit the id budget"):
        binning.replay_id_stream(hist, cr, ci, it, max_len=64, budget=64, **kw)
    with pytest.raises(ValueError, match="exceeds max_len"):
        binning.replay_id_stream(hist, cr, ci, it, max_len=10, **kw)
    assert not hist.any()
    empty = torch.zeros(0, dtype=torch.float32)
    assert int(binning.replay_id_stream(
        hist, empty, empty, torch.zeros(0, dtype=torch.int32), **kw)) == 0
    with pytest.raises(ValueError, match="histogram size"):
        binning.replay_id_stream(hist[:10], cr, ci, it, **kw)
    with pytest.raises(ValueError, match="int32"):
        binning.bigtiles_deposit(hist, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="chunk"):
        binning.bigtiles_deposit(hist, torch.zeros(3, dtype=torch.int32),
                                 chunk=8193)


def _cfg(mod, extended, **opt):
    """test_torch_engine's _cfg geometry (32x32, 8 lane rows, 256 steps,
    band [3,50), device replay), or test_torch_engine_ext's df32 one."""
    if extended:
        base = dict(precision="extended", lane_rows=8, steps_per_pass=512,
                    steps_per_flush=32, replay_capacity=1 << 14)
        canvas, band, dom = dict(width=48, height=48), (400, 20), FAST
    else:
        base = dict(lane_rows=8, steps_per_pass=256, steps_per_flush=16,
                    replay_capacity=1 << 14)
        canvas, band, dom = dict(width=32, height=32), (50, 3), None
    base.update(opt)
    if mod is jcfg:
        base.update(engine="pallas", replay="device")
    kw = {} if dom is None else dict(sample_domain=dom)
    return mod.RenderConfig(
        canvas=mod.Canvas(**canvas),
        band=mod.IterationBand(max_escape_iterations=band[0],
                               min_escape_iterations=band[1]),
        options=mod.EngineOptions(**base), **kw)


def _render(eng, passes):
    st = eng.init_state(None)
    for p in range(passes):
        st = eng.run_pass(st, p)
    return eng.histogram(st), eng.stats(st)


@pytest.mark.parametrize("extended,budget", [
    (False, 0), (True, 0), (False, 1 << 11)])
def test_engine_bigtiles_equals_fused_route(monkeypatch, extended, budget):
    """CudaEngine on the CPU, 2 passes: --scatter bigtiles renders the
    --scatter auto histogram and stats bit for bit (with a 2048-id budget
    each pass splits into groups)."""
    if budget:
        monkeypatch.setattr(binning, "BIGTILES_ID_BUDGET", budget)
    runs = {}
    for scatter in ("auto", "bigtiles"):
        eng = CudaEngine(_cfg(tcfg, extended, scatter=scatter), device="cpu")
        launches.reset()
        runs[scatter] = _render(eng, 2)
        counts = dict(launches.COUNTS)
        write = "replay_ids_ext_plain" if extended else "replay_ids_plain"
        fused = ("replay_deposit_ext_plain" if extended
                 else "replay_deposit_plain")
        if scatter == "bigtiles":
            assert counts.get(fused, 0) == 0
            assert counts[write] == counts["bigtiles_deposit_plain"]
            assert counts[write] > 2 if budget else counts[write] == 2
        else:
            assert counts[fused] == 2 and counts.get(write, 0) == 0
    (ha, sa), (hb, sb) = runs["auto"], runs["bigtiles"]
    assert hb.sum() == sb["on_canvas_points"] > 0
    np.testing.assert_array_equal(hb, ha)
    assert sb == sa
    assert 0 < sb["on_canvas_points"] <= sb["orbit_points"]


def test_bigtiles_route_statistical_vs_jax_bigtiles_engine():
    """The port's bigtiles route against the JAX engine's (--scatter
    bigtiles, device replay, interpret mode) over 2 passes, by the
    criteria of test_whole_slice_statistical_vs_jax_engine: mass per
    emission and in-band fraction within 5%, normalized-histogram
    correlation > 0.99 (same seed and geometry: the engines draw the same
    samples; measured corr 0.999998, ratios within 0.05%)."""
    jeng = jpe.PallasEngine(_cfg(jcfg, False, scatter="bigtiles"))
    teng = CudaEngine(_cfg(tcfg, False, scatter="bigtiles"), device="cpu")
    js = jeng.init_state(None)
    for p in range(2):
        js = jeng.run_pass(js, p)
    jh, jst = jeng.histogram(js), jeng.stats(js)
    launches.reset()
    th, tst = _render(teng, 2)
    assert launches.COUNTS["bigtiles_deposit_plain"] == 2
    assert tst["on_canvas_points"] == th.sum() > 0
    j_rate = jh.sum() / max(jst["emitted"], 1)
    t_rate = th.sum() / max(tst["emitted"], 1)
    assert abs(t_rate / j_rate - 1) < 0.05, (t_rate, j_rate)
    j_band = jst["in_band"] / (jst["samples"] - jst["culled"])
    t_band = tst["in_band"] / (tst["samples"] - tst["culled"])
    assert abs(t_band / j_band - 1) < 0.05, (t_band, j_band)
    p = th.astype(np.float64) / th.sum()
    q = jh.astype(np.float64) / jh.sum()
    assert np.corrcoef(p.ravel(), q.ravel())[0, 1] > 0.99


SMALL = ["-w", "40", "-h", "30", "-m", "60", "-c", "5", "--lane-rows", "4",
         "--steps-per-pass", "128", "--steps-per-flush", "16",
         "--replay-capacity", "8192", "-t", "-1"]
MH = ["--sampler", "mh", "--center", "-0.7436,0.1319", "--span", "6e-3",
      "-w", "24", "-h", "24", "-m", "300", "-c", "20", "--lane-rows", "2",
      "--steps-per-pass", "512", "--steps-per-flush", "128", "--mh-burnin",
      "1", "-t", "-1"]


@pytest.mark.parametrize("argv,mh", [(SMALL, False), (MH, True)])
def test_cli_scatter_bigtiles_renders_as_auto(tmp_path, argv, mh):
    """Through cli.main on the CPU, --scatter bigtiles writes the image
    and stats of --scatter auto, bit for bit. With --sampler mh the flag
    is accepted and changes nothing, launches included (the MH deposit
    reads the emissions' recorded bins, as in the JAX engine)."""
    out = {}
    for scatter in ("auto", "bigtiles"):
        img, stats = (str(tmp_path / f"{scatter}.{e}") for e in ("pgm", "json"))
        launches.reset()
        assert cli.main([*argv, "--scatter", scatter, "--passes", "2", "-o",
                         img, "--stats-json", stats], device="cpu") == 0
        s = json.load(open(stats))
        s.pop("elapsed_seconds")
        out[scatter] = (open(img, "rb").read(), s, dict(launches.COUNTS))
    (ia, sa, ca), (ib, sb, cb) = out["auto"], out["bigtiles"]
    assert ia == ib and sa == sb and sb["on_canvas_points"] > 0
    if mh:
        assert ca == cb and cb["mh_deposit_plain"] == 2
    else:
        assert ca["replay_deposit_plain"] == 2 and "replay_ids_plain" not in ca
        assert cb["replay_ids_plain"] == cb["bigtiles_deposit_plain"] == 2
        assert "replay_deposit_plain" not in cb


# -- the CUDA sources' id writer and run-length deposit, built with g++ ----


def _host_deposit(harness, ids, nbins, chunk, hist0):  # noqa: F811
    hist = hist0.astype(np.uint32).copy()
    ids = np.ascontiguousarray(ids, np.int32)
    vp = ctypes.c_void_p
    harness.cbh_bigtiles_deposit.argtypes = [vp, ctypes.c_longlong,
                                             ctypes.c_int, vp, ctypes.c_int]
    assert harness.cbh_bigtiles_deposit(ids.ctypes.data, ids.size, chunk,
                                        hist.ctypes.data, nbins) == 0
    return hist


@pytest.mark.parametrize("chunk", [1, 256, 300, 8192])
def test_header_bigtiles_deposit_bitwise(harness, chunk):  # noqa: F811
    """The kernel's per-thread run logic (bigtiles.cuh), run in the
    kernel's thread order with its scan carried on the CPU, against
    bigtiles_deposit_plain on the sorted JAX cases and on streams with
    ids below zero and beyond the sentinel, at chunks that split runs
    at every id, at block boundaries, and not at all."""
    rng = np.random.default_rng(chunk)
    extra = [rng.integers(-3, NBINS + 3, 20000),
             np.full(8192 * 2 + 5, 77), np.asarray([5])]
    for ids in [*CASES, *extra]:
        ids = np.sort(np.asarray(ids, np.int32))
        hist0 = rng.integers(0, 5, NBINS).astype(np.uint32)
        got = _host_deposit(harness, ids, NBINS, chunk, hist0)
        want = torch.from_numpy(hist0.view(np.int32).copy())
        binning.bigtiles_deposit_plain(want, torch.from_numpy(ids))
        np.testing.assert_array_equal(got.view(np.int32), want.numpy())


def _host_ids(harness, cr, ci, it, canvas, fractal, shift=0,  # noqa: F811
              guard=-7):
    """The f32 id stream of replay_ids' staged warps (the g++ emulation of
    csrc/deposit.cu's kernel, tile filled with a poison word first), written
    ``shift`` words into a buffer of ``guard`` words, and its hit count.
    Returns (stream, hits, the buffer's words outside the stream)."""
    off, n = _offsets(torch.from_numpy(it))
    buf = np.full(n + shift + 3, guard, np.int32)
    hits = ctypes.c_ulonglong(0)
    vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    harness.cbh_replay_ids.argtypes = [
        i, vp, vp, vp, vp, i, vp, f, f, f, f, i, i, i, i, i, vp]
    offs = off.numpy()
    assert harness.cbh_replay_ids(
        fractal.kernel_id, cr.ctypes.data, ci.ctypes.data, it.ctypes.data,
        offs.ctypes.data, it.size, buf.ctypes.data + 4 * shift,
        canvas.min_real, canvas.min_imag, canvas.delta_real,
        canvas.delta_imag, canvas.width, canvas.height, 0, canvas.height,
        -99,
        ctypes.addressof(hits)) == 0
    outside = np.concatenate([buf[:shift], buf[shift + n:]])
    return buf[shift:shift + n], hits.value, outside


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_header_replay_ids_bitwise(harness, name):  # noqa: F811
    """The f32 replay_ids kernel's warps (the queue's groups of 32, the
    orbit loop of orbit.cuh replay_span and its staged tile) against
    replay_ids_plain: every slot and the hit count."""
    canvas = tcfg.Canvas(width=48, height=40)
    rng = np.random.default_rng(7)
    k = 400
    cr = rng.uniform(-2, 1, k).astype(np.float32)
    ci = rng.uniform(-1.5, 1.5, k).astype(np.float32)
    it = np.sort(rng.integers(-1, 90, k).astype(np.int32))[::-1].copy()
    off, n = _offsets(torch.from_numpy(it))
    want, hits_p = binning.replay_ids_plain(
        *map(torch.from_numpy, (cr, ci, it)), off, n, canvas=canvas,
        fractal=FRACTALS[name])
    ids, hits, outside = _host_ids(harness, cr, ci, it, canvas,
                                   FRACTALS[name])
    np.testing.assert_array_equal(ids, want.numpy())
    assert hits == int(hits_p) > 0
    assert (outside == -7).all()


@settings(max_examples=40, deadline=None, database=None)
@given(lens=st.lists(st.one_of(st.integers(-1, 3), st.integers(28, 100)),
                     min_size=1, max_size=80),
       order=st.sampled_from(["descending", "as drawn"]),
       shift=st.integers(0, 3), seed=st.integers(0, 2**16),
       name=st.sampled_from(sorted(FRACTALS)))
def test_header_staged_ids_property(harness, lens, order, shift, seed,  # noqa: F811
                                    name):
    """The staged id write over drawn orbit lengths: inactive emissions
    (iters -1), orbits of one point, orbits that cross 32-step tiles, a
    last group of fewer than 32, a stream that starts off a 16-byte
    boundary (``shift``), and points off the canvas (c drawn over a window
    larger than the canvas). Every slot equals replay_ids_plain's, the hit
    count too, and no word outside the stream is written."""
    canvas = tcfg.Canvas(width=24, height=20, min_real=-1.5, max_real=0.5,
                         min_imag=-1.0, max_imag=1.0)
    rng = np.random.default_rng(seed)
    it = np.asarray(lens, np.int32) - 1
    if order == "descending":
        it = np.sort(it)[::-1].copy()
    cr = rng.uniform(-2.2, 1.0, it.size).astype(np.float32)
    ci = rng.uniform(-1.4, 1.4, it.size).astype(np.float32)
    ids, hits, outside = _host_ids(harness, cr, ci, it, canvas,
                                   FRACTALS[name], shift)
    off, n = _offsets(torch.from_numpy(it))
    want, hits_p = binning.replay_ids_plain(
        *map(torch.from_numpy, (cr, ci, it)), off, n, canvas=canvas,
        fractal=FRACTALS[name])
    np.testing.assert_array_equal(ids, want.numpy())
    assert hits == int(hits_p)
    assert (outside == -7).all()


def _host_ids_ext(harness, fn, name, prefill):  # noqa: F811
    """A df32 id stream of the harness's writer ``fn`` over 300 emissions
    (ids filled with ``prefill`` first), its hit count, and the plain
    version's stream and count."""
    canvas = tcfg.Canvas(width=48, height=40)
    rng = np.random.default_rng(8)
    k = 300
    kr = rng.integers(0, 1 << 24, k).astype(np.float32)
    ki = rng.integers(0, 1 << 24, k).astype(np.float32)
    it = np.sort(rng.integers(-1, 70, k).astype(np.int32))[::-1].copy()
    off, n = _offsets(torch.from_numpy(it))
    want, hits_p = binning.replay_ids_ext_plain(
        *map(torch.from_numpy, (kr, ki, it)), off, n, canvas=canvas,
        fractal=FRACTALS[name], sample_domain=FAST)
    ids = np.full(n, prefill, np.int32)
    hits = ctypes.c_ulonglong(0)
    c0r, c0i, step_r, step_i = cx.grid_params(FAST)
    iargs = (ctypes.c_int * 7)(FRACTALS[name].kernel_id, k, canvas.width,
                               canvas.height, 0, 0, canvas.height)
    fargs = (ctypes.c_float * 12)(
        *c0r, *c0i, step_r, step_i, *df32.from_float(canvas.min_real),
        *df32.from_float(canvas.min_imag),
        np.float32(1.0 / canvas.delta_real),
        np.float32(1.0 / canvas.delta_imag))
    vp = ctypes.c_void_p
    fn = getattr(harness, fn)
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int), FP, vp]
    offs = off.numpy()
    assert fn(kr.ctypes.data, ki.ctypes.data, it.ctypes.data,
              offs.ctypes.data, ids.ctypes.data, iargs, fargs,
              ctypes.addressof(hits)) == 0
    return ids, hits.value, want.numpy(), int(hits_p), canvas.num_pixels


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_header_replay_ids_ext_bitwise(harness, name):  # noqa: F811
    """The df32 replay's emission function with the id sink
    (classify_ext.cuh replay_ext_one) against replay_ids_ext_plain."""
    ids, hits, want, hits_p, _ = _host_ids_ext(
        harness, "cbh_replay_ids_ext", name, -7)
    np.testing.assert_array_equal(ids, want)
    assert hits == hits_p > 0


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_header_canvas_id_sink_equals_id_sink(harness, name):  # noqa: F811
    """The replay_ids_ext kernel's sink (orbit.cuh CanvasIdSink) writes
    only on-canvas ids into a stream filled with the sentinel: that gives
    the stream of a store per point (IdSink) word for word, and the plain
    version's, with the same hit count."""
    nbins = tcfg.Canvas(width=48, height=40).num_pixels
    ids, hits, want, hits_p, _ = _host_ids_ext(
        harness, "cbh_replay_ids_ext_canvas", name, nbins)
    every, hits_e, _, _, _ = _host_ids_ext(
        harness, "cbh_replay_ids_ext", name, -7)
    np.testing.assert_array_equal(ids, every)
    np.testing.assert_array_equal(ids, want)
    assert hits == hits_e == hits_p == int((ids < nbins).sum()) > 0


def test_memory_estimate_counts_the_sort():
    """The bigtiles route adds one group's id stream and torch.sort's
    buffers (36 bytes an id) to the fused route's estimate."""
    base = CudaEngine(_cfg(tcfg, False), device="cpu")
    big = CudaEngine(_cfg(tcfg, False, scatter="bigtiles"), device="cpu")
    ids = min(binning.BIGTILES_ID_BUDGET, (1 << 14) * 50)
    assert big.memory_estimate()[0] == base.memory_estimate()[0] + 36 * ids
    assert big.memory_estimate()[1] == base.memory_estimate()[1]
