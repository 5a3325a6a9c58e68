"""The JAX package's id-stream deposit routes in cudabrot_tpu_torch on the
CPU: ``--scatter pallas`` (the ``replay_ids`` stream counted as written by
``deposit_ids``, the function of the JAX Mosaic scatter) and ``--scatter
sorted`` (the JAX ``scatter_sorted``'s sort and run-length add, which is
the port's bigtiles route), against the JAX package and against the
port's own routes.

The deposits are exact integer additions, so they agree bitwise: the
port's id deposit equals JAX ``scatter_pallas`` (interpret mode, with and
without ``skip_chunks``) and ``scatter_xla`` on ``tests/test_binning.py``'s
cases, and the ``sorted`` route's deposit equals JAX ``scatter_sorted``.
The replays
are held to the JAX device replays within the bounds the port's replay
tests state, each with its cause: the f32 route against
``_batched_replay``/``_blocked_replay`` (Mosaic scatter, interpret mode)
within ``test_torch_binning``'s bound, histogram mass within 0.5% and at
most 5% of the mass in differing bins (XLA's CPU backend contracts the
jitted orbit update into fused multiply-adds, so chaotic orbits drift in
the low bits and a few points land in other bins); the df32 route against
``_blocked_replay_ext`` within ``test_torch_binning_ext``'s bound, equal
mass and a histogram L1 difference of at most max(2, 2%) (XLA contracts
the df32 error sums: positions differ by ~2^-48). Within the port every
route renders the fused route's histogram and stats bit for bit, on one
engine, two data-parallel replicas and two uneven row shards.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.config import Canvas as JCanvas
from cudabrot_tpu.engines.pallas_engine import (
    _batched_replay,
    _blocked_replay,
    _blocked_replay_ext,
)
from cudabrot_tpu.models import fractals as jfr
from cudabrot_tpu.ops import binning as jb
from cudabrot_tpu.ops import df32 as jdf
from cudabrot_tpu.ops import pallas_kernels_ext as pke
from cudabrot_tpu_torch import cli
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.engines import make_engine
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import binning, launches
from tests.test_torch_binning_ext import FAST, _short_escapers

torch.set_num_threads(1)

#: The id routes of --scatter pallas and sorted, and the two the port had.
ROUTES = ("auto", "pallas", "sorted", "bigtiles")


def _ids(nbins, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, nbins + 1, size=n).astype(np.int32)  # + sentinel


def _port_ids(nbins, ids):
    """The port's --scatter pallas deposit on a non-zero start histogram,
    as unsigned counts; it must run the plain version on the CPU."""
    hist = torch.arange(nbins, dtype=torch.int32)
    launches.reset()
    out = binning.ID_ROUTES[binning.select_scatter_backend("pallas")](
        hist, torch.from_numpy(ids))
    assert out is hist
    assert launches.COUNTS["deposit_ids_plain"] == 1
    assert launches.COUNTS["deposit_ids"] == 0
    return hist.numpy().view(np.uint32)


@pytest.mark.parametrize("nbins,n,slots,seed", [
    (16 * 12, 2048, 1, 0),    # tail row (192 = 1.5 * 128)
    (777, 2000, 2, 2),        # odd nbins, odd n (padding path)
])
def test_ids_deposit_matches_scatter_pallas(nbins, n, slots, seed):
    """test_binning's scatter_pallas cases: the port's id deposit ==
    scatter_pallas (interpret mode) == scatter_xla, bitwise."""
    ids = _ids(nbins, n, seed)
    hist0 = jnp.arange(nbins, dtype=jnp.uint32)
    want = np.asarray(jb.scatter_xla(hist0, jnp.asarray(ids)))
    pallas = np.asarray(jb.scatter_pallas(hist0, jnp.asarray(ids),
                                          slots=slots, interpret=True))
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(_port_ids(nbins, ids), want)


@pytest.mark.parametrize("nbins,n,seed", [
    (16 * 12, 4096, 0),
    (777, 5000, 2),       # padding path: the pad chunk is all-sentinel
    (256, 2048, None),    # every chunk all-sentinel
])
def test_ids_deposit_matches_skip_chunks(nbins, n, seed):
    """test_binning's skip_chunks cases (contiguous sentinel runs over
    whole 1024-id chunks): the port's id deposit, which has no chunks to
    skip, == scatter_pallas(skip_chunks=True) == scatter_xla, bitwise."""
    if seed is None:
        ids = np.full(n, nbins, np.int32)
    else:
        ids = _ids(nbins, n, seed)
        ids[1024:2048] = nbins
        ids[-1024:] = nbins
    hist0 = jnp.arange(nbins, dtype=jnp.uint32)
    want = np.asarray(jb.scatter_xla(hist0, jnp.asarray(ids)))
    pallas = np.asarray(jb.scatter_pallas(hist0, jnp.asarray(ids),
                                          chunk=1024, interpret=True,
                                          skip_chunks=True))
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(_port_ids(nbins, ids), want)


@pytest.mark.parametrize("nbins,n,seed", [
    (16 * 12, 2048, 0),
    (1024, 4096, 1),
    (777, 2000, 2),     # odd nbins, odd n
    (50, 4096, 3),      # collision-heavy: the collapse does real work
    (64, 512, None),    # all sentinels: nothing deposited
])
def test_scatter_sorted_matches_jax(nbins, n, seed):
    """test_binning's scatter_sorted cases: the port's --scatter sorted
    deposit (the bigtiles route's sort and run-length add, its plain
    version on the CPU) == JAX scatter_sorted bitwise, on a non-zero start
    histogram."""
    ids = (np.full(n, nbins, np.int32) if seed is None
           else _ids(nbins, n, seed))
    hist0 = jnp.arange(nbins, dtype=jnp.uint32)
    want = np.asarray(jb.scatter_sorted(hist0, jnp.asarray(ids)))
    hist = torch.arange(nbins, dtype=torch.int32)
    launches.reset()
    deposit = binning.ID_ROUTES[binning.select_scatter_backend("sorted")]
    assert deposit(hist, torch.from_numpy(ids)) is hist
    assert {k: v for k, v in launches.COUNTS.items() if v} == {
        "bigtiles_deposit_plain": 1}
    np.testing.assert_array_equal(hist.numpy().view(np.uint32), want)
    if seed is None:
        np.testing.assert_array_equal(want, np.arange(nbins))


def _pallas_engine_batch():
    """test_pallas_engine's batched-vs-blocked inputs: 1024 emissions on a
    64x48 canvas, 30% inactive, sorted by descending length."""
    rng = np.random.default_rng(11)
    k = 1024
    cr = rng.uniform(-2.0, 1.0, k).astype(np.float32)
    ci = rng.uniform(-1.5, 1.5, k).astype(np.float32)
    it = rng.integers(0, 60, size=k).astype(np.int32)
    it[rng.uniform(size=k) < 0.3] = -1
    return cr, ci, np.sort(it)[::-1].copy()


@pytest.mark.parametrize("jax_replay", ["batched", "blocked"])
def test_f32_pallas_route_matches_jax_replay(jax_replay):
    """The f32 --scatter pallas route (replay_ids, then deposit_ids) on
    one batch against the JAX device replay through its Mosaic scatter
    (interpret mode), within test_torch_binning's replay-vs-JAX bound;
    and bitwise equal to the port's fused replay."""
    canvas, fr = JCanvas(width=64, height=48), jfr.get_fractal("buddhabrot")
    cr, ci, it = _pallas_engine_batch()
    hist0 = jnp.zeros(canvas.num_pixels, jnp.uint32)
    args = (hist0, jnp.asarray(cr), jnp.asarray(ci), jnp.asarray(it))
    if jax_replay == "batched":
        ref, ref_hits = _batched_replay(
            *args, fractal=fr, canvas=canvas, steps_cap=64, block=256,
            backend="pallas", interpret=True)
    else:
        ref, ref_hits = _blocked_replay(
            *args, fractal=fr, canvas=canvas, chunk=32, block=256,
            backend="pallas", interpret=True)
    ref = np.asarray(ref).astype(np.int64)
    assert int(ref_hits[0]) + (int(ref_hits[1]) << 32) == ref.sum() > 0

    tcanvas, tfrac = tcfg.Canvas(width=64, height=48), tfr.get_fractal(
        "buddhabrot")
    xs = [torch.from_numpy(a) for a in (cr, ci, it)]
    hist = torch.zeros(tcanvas.num_pixels, dtype=torch.int32)
    launches.reset()
    hits = binning.replay_id_stream(hist, *xs, route="ids", canvas=tcanvas,
                                    fractal=tfrac, max_len=64)
    assert launches.COUNTS["replay_ids_plain"] == 1
    assert launches.COUNTS["deposit_ids_plain"] == 1
    got = hist.numpy().astype(np.int64)
    assert int(hits) == got.sum()
    assert abs(got.sum() - ref.sum()) <= 0.005 * ref.sum()
    assert np.abs(got - ref).sum() <= 0.05 * ref.sum()
    fused = torch.zeros_like(hist)
    assert int(binning.replay_deposit_plain(
        fused, *xs, canvas=tcanvas, fractal=tfrac)) == int(hits)
    assert torch.equal(fused, hist)


def test_df32_pallas_route_matches_jax_blocked_replay_ext():
    """The df32 --scatter pallas route (replay_ids_ext, then deposit_ids)
    against _blocked_replay_ext through the Mosaic scatter (interpret
    mode), within test_torch_binning_ext's bound; and bitwise equal to the
    port's fused df32 replay."""
    cv = dict(width=64, height=64)
    kr, ki, it = _short_escapers(FAST, False)
    c0r, c0i, step_r, step_i = pke.grid_params(FAST)
    canvas = JCanvas(**cv)
    dfc = jnp.asarray(
        [*c0r, *c0i, *jdf.from_float(canvas.min_real),
         *jdf.from_float(canvas.min_imag), 0.0], jnp.float32)
    ref, ref_hits = jax.jit(
        lambda h, a, b, c, d: _blocked_replay_ext(
            h, a, b, c, fractal=jfr.FRACTALS["buddhabrot"], canvas=canvas,
            chunk=32, block=64, backend="pallas", dfc=d, step_r=step_r,
            step_i=step_i, interpret=True)
    )(jnp.zeros(canvas.num_pixels, jnp.uint32), jnp.asarray(kr),
      jnp.asarray(ki), jnp.asarray(it), dfc)
    ref = np.asarray(ref).astype(np.int64)
    assert int(ref_hits[0]) + (int(ref_hits[1]) << 32) == ref.sum() > 0

    tcanvas = tcfg.Canvas(**cv)
    kw = dict(canvas=tcanvas, fractal=tfr.FRACTALS["buddhabrot"],
              sample_domain=FAST)
    xs = [torch.from_numpy(a) for a in (kr, ki, it)]
    hist = torch.zeros(tcanvas.num_pixels, dtype=torch.int32)
    launches.reset()
    hits = binning.replay_id_stream_ext(hist, *xs, route="ids",
                                        max_len=int(it.max()) + 1, **kw)
    assert launches.COUNTS["replay_ids_ext_plain"] == 1
    assert launches.COUNTS["deposit_ids_plain"] == 1
    got = hist.numpy().astype(np.int64)
    assert int(hits) == got.sum() == ref.sum()
    assert np.abs(got - ref).sum() <= max(2, 0.02 * ref.sum())
    fused = torch.zeros_like(hist)
    assert int(binning.replay_deposit_ext_plain(fused, *xs, **kw)) == int(
        hits)
    assert torch.equal(fused, hist)


def _cfg(extended, scatter, **opt):
    """A small render: 32x31 at f32 (band [3, 50)), 48x47 at extended
    precision over FAST (band [20, 400)); odd heights, so two row shards
    hold unequal rows."""
    if extended:
        o = dict(precision="extended", lane_rows=8, steps_per_pass=512,
                 steps_per_flush=32, replay_capacity=1 << 14)
        canvas, band, top = (48, 47), (400, 20), dict(sample_domain=FAST)
    else:
        o = dict(lane_rows=8, steps_per_pass=256, steps_per_flush=16,
                 replay_capacity=1 << 14)
        canvas, band, top = (32, 31), (50, 3), {}
    o.update(scatter=scatter, **opt)
    return tcfg.RenderConfig(
        canvas=tcfg.Canvas(width=canvas[0], height=canvas[1]),
        band=tcfg.IterationBand(max_escape_iterations=band[0],
                                min_escape_iterations=band[1]),
        options=tcfg.EngineOptions(**o), **top)


def _render(cfg, passes=2):
    eng = make_engine(cfg, device="cpu")
    state = eng.init_state(None)
    for p in range(passes):
        state = eng.run_pass(state, p)
    return eng.histogram(state), eng.stats(state)


#: The plain versions each route runs on the CPU (f32 names; _ext ones at
#: extended precision), and those it must not.
ROUTE_PLAIN = {
    "auto": ({"replay_deposit"},
             {"replay_ids", "deposit_ids", "bigtiles_deposit"}),
    "pallas": ({"replay_ids", "deposit_ids"},
               {"replay_deposit", "bigtiles_deposit"}),
    "sorted": ({"replay_ids", "bigtiles_deposit"},
               {"replay_deposit", "deposit_ids"}),
    "bigtiles": ({"replay_ids", "bigtiles_deposit"},
                 {"replay_deposit", "deposit_ids"}),
}


def _plain(name, extended):
    if extended and name in ("replay_deposit", "replay_ids"):
        name += "_ext"
    return f"{name}_plain"


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("layout", [
    dict(), dict(num_devices=2), dict(num_devices=2,
                                      histogram_sharding="rows")])
def test_every_route_renders_the_same(extended, layout):
    """Two passes through --scatter auto, pallas, sorted and bigtiles: the
    histogram and every stat bit for bit, each route through its own
    plain versions; on one engine, on two data-parallel replicas, and on
    two row shards of an odd height."""
    runs = {}
    for scatter in ROUTES:
        launches.reset()
        runs[scatter] = _render(_cfg(extended, scatter, **layout))
        counts = {k: v for k, v in launches.COUNTS.items() if v}
        ran, never = ROUTE_PLAIN[scatter]
        for k in ran:
            assert counts.get(_plain(k, extended), 0) > 0, (scatter, k)
        for k in never:
            assert _plain(k, extended) not in counts, (scatter, k)
        assert not any(k in counts for k in launches.KERNELS)
    ha, sa = runs["auto"]
    assert ha.sum() == sa["on_canvas_points"] > 0
    for scatter in ROUTES[1:]:
        h, s = runs[scatter]
        np.testing.assert_array_equal(h, ha)
        assert s == sa, scatter


SMALL = ["-w", "40", "-h", "30", "-m", "60", "-c", "5", "--lane-rows", "4",
         "--steps-per-pass", "128", "--steps-per-flush", "16",
         "--replay-capacity", "8192", "-t", "-1"]
DEEP = ["-w", "32", "-h", "32", "-m", "2000", "-c", "50", "--center",
        "-0.743643887037151,0.131825904205330", "--span", "1e-5",
        "--precision", "extended", "--lane-rows", "4", "--steps-per-pass",
        "1024", "--steps-per-flush", "64", "--replay-capacity", "4096",
        "-t", "-1"]


@pytest.mark.parametrize("argv", [SMALL, DEEP], ids=["float32", "extended"])
def test_cli_routes_render_as_auto(tmp_path, argv):
    """cli.main on the CPU with --scatter pallas and sorted writes the PGM
    bytes and stats of --scatter auto."""
    out = {}
    for scatter in ("auto", "pallas", "sorted"):
        img, stats = (str(tmp_path / f"{scatter}.{e}") for e in ("pgm", "json"))
        assert cli.main([*argv, "--scatter", scatter, "--passes", "2", "-o",
                         img, "--stats-json", stats], device="cpu") == 0
        s = json.load(open(stats))
        s.pop("elapsed_seconds")
        out[scatter] = (open(img, "rb").read(), s)
    assert out["auto"][1]["on_canvas_points"] > 0
    assert out["pallas"] == out["auto"] == out["sorted"]


HOST_ONLY = ("replay", "replay_fetch_seconds", "replay_busy_seconds",
             "on_canvas_points")


@pytest.mark.parametrize("scatter", ["pallas", "sorted"])
def test_hybrid_share_through_the_routes(scatter):
    """--replay host at device share 0.3 with the route: the device's share
    goes through it, and every count but on_canvas_points equals the
    device-mode --scatter auto render's (the host bins the rest by a
    float32 reciprocal of the pitch); the histogram's sum is
    on_canvas_points."""
    _, sd = _render(_cfg(False, "auto"), passes=3)
    launches.reset()
    hh, sh = _render(_cfg(False, scatter, replay="host",
                          replay_device_share=0.3), passes=3)
    assert sh["replay"] == "hybrid"
    assert launches.COUNTS["replay_ids_plain"] == 3
    assert launches.COUNTS["deposit_ids_plain"] == (
        3 if scatter == "pallas" else 0)
    assert int(hh.sum()) == sh["on_canvas_points"] > 0
    assert ({k: v for k, v in sh.items() if k not in HOST_ONLY}
            == {k: v for k, v in sd.items() if k not in HOST_ONLY})


def test_route_share_and_memory():
    """The hybrid's auto share on a small canvas is the fused route's
    alone; each id-stream route's memory estimate adds its bytes an id."""
    fused = CudaEngine(_cfg(False, "auto"), device="cpu")
    assert fused.tuning.auto_device_share(1 << 20, "ids") == 0.0
    assert fused.tuning.auto_device_share(1 << 20, "bigtiles") == 0.0
    dev = {s: CudaEngine(_cfg(False, s), device="cpu").memory_estimate()[0]
           for s in ROUTES}
    ids = min(binning.BIGTILES_ID_BUDGET,
              fused.replay_capacity * fused.tuning.max_it)
    assert dev["pallas"] - dev["auto"] == 4 * ids
    assert dev["auto"] < dev["pallas"] < dev["bigtiles"] == dev["sorted"]
    with pytest.raises(tcfg.ConfigError, match="sort backend was removed"):
        dataclasses.replace(_cfg(False, "pallas").options,
                            scatter="sort").validate()
