"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (the kernels build at first
use) and skips elsewhere; run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a CUDA machine
need not have; this file needs only PyTorch.)

Both sides round every operation once and add integers exactly, so every
comparison is bitwise — including a whole engine pass on the card against
the same pass on the CPU.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch import cli, config, driver
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine, compact
from cudabrot_tpu_torch.models.fractals import FRACTALS
from cudabrot_tpu_torch.ops import binning, launches, prng
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.ops import classify_ext as cx
from cudabrot_tpu_torch.ops import classify_mh as cmh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize(
    "name,thin,visit,use_bits",
    [(n, t, v, b) for n, t, v, b in itertools.product(
        sorted(FRACTALS), (True, False), (False, True), (False, True))
     if t or not v],
)
def test_classify_kernel_matches_plain(cuda, name, thin, visit, use_bits):
    rows, steps, flush, unroll = 16, 128, 32, 4
    kw = dict(fractal=FRACTALS[name], min_it=10, max_it=300,
              steps_per_pass=steps, steps_per_flush=flush,
              inner_unroll=unroll, thin_tracking=thin,
              visit_window=(-1.5, 0.5, -1.0, 1.0) if visit else None)
    state = cls.init_lane_state(rows, cuda)
    cls.classify_pass(state, (5, 6), **kw)  # carried, mid-flight state
    a = cls.LaneState(*(t.clone() for t in state))
    b = cls.LaneState(*(t.clone() for t in state))
    bits = None
    if use_bits:
        shape = (steps // flush, flush // unroll, 2, rows, 128)
        bits = torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=cuda)
    launches.reset()
    ra = cls.classify_pass(a, (7, 8), bits, **kw)
    assert launches.COUNTS["classify"] == 1
    rb = cls.classify_pass_plain(
        b, 7, 8, bits, fractal=kw["fractal"], min_it=10, max_it=300,
        chunks=steps // flush, windows=flush // unroll, unroll=unroll,
        thin=thin, detect=FRACTALS[name].cycle_detect,
        sample_domain=config.SAMPLE_DOMAIN, visit_window=kw["visit_window"])
    for x, y in zip(ra.state, rb.state):
        assert _same(x, y)
    assert _same(ra.emit_c, rb.emit_c)
    assert _same(ra.emit_it, rb.emit_it)
    assert _same(ra.stats, rb.stats)


#: The classify kernel's variants for the unrolled-window cases: fractal,
#: thin tracking, band, visit window.
CLASSIFY_VARIANTS = {
    "buddhabrot-thin": ("buddhabrot", True, (20, 100), None),
    "step-tracking": ("buddhabrot", False, (5, 200), None),
    "burning-ship": ("burning-ship", True, (5, 200), None),
    "anti-buddhabrot": ("anti-buddhabrot", True, (0, 64), None),
    "visit-window": ("buddhabrot", True, (5, 200), (-1.5, 0.5, -1.0, 1.0)),
}


@pytest.mark.parametrize("variant", sorted(CLASSIFY_VARIANTS))
@pytest.mark.parametrize("unroll", [1, 8])
def test_classify_kernel_unrolled_windows_match_plain(cuda, variant, unroll):
    """The compacted-refill kernel with an unrolled window of 1 and 8, on
    640 lanes, against the plain version bitwise."""
    name, thin, band, visit = CLASSIFY_VARIANTS[variant]
    rows, flush = 5, 16 * unroll
    kw = dict(fractal=FRACTALS[name], min_it=band[0], max_it=band[1],
              steps_per_pass=4 * flush, steps_per_flush=flush,
              inner_unroll=unroll, thin_tracking=thin, visit_window=visit)
    state = cls.init_lane_state(rows, cuda)
    cls.classify_pass(state, (5, 6), **kw)  # carried, mid-flight state
    a = cls.LaneState(*(t.clone() for t in state))
    b = cls.LaneState(*(t.clone() for t in state))
    launches.reset()
    ra = cls.classify_pass(a, (7, 8), **kw)
    assert launches.COUNTS["classify"] == 1
    rb = cls.classify_pass_plain(
        b, 7, 8, None, fractal=kw["fractal"], min_it=band[0],
        max_it=band[1], chunks=4, windows=16, unroll=unroll, thin=thin,
        detect=FRACTALS[name].cycle_detect,
        sample_domain=config.SAMPLE_DOMAIN, visit_window=visit)
    for x, y in zip(ra.state, rb.state):
        assert _same(x, y)
    assert _same(ra.emit_c, rb.emit_c)
    assert _same(ra.emit_it, rb.emit_it)
    assert _same(ra.stats, rb.stats)
    assert int(ra.stats[cls.STAT_DRAWN].sum()) > 0


#: The f32 cells' bands (BENCHMARK.json) and the plan the engine picks for
#: each at 262,144 lanes (steps a pass, flush, unroll), which the canvas
#: does not change; canvas1k.dp4 runs canvas1k.default's on each card.
F32_CELLS = {
    "canvas1k.default": ([], (4096, 128, 1)),
    "canvas1k.cutoff2000": (["-m", "20000", "-c", "2000"], (4096, 4096, 8)),
    "hires15k.medium": (["-m", "8000", "-c", "1000"], (4096, 4096, 8)),
    "hires15k.fine": (["-m", "60000", "-c", "45000"], (65536, 65536, 8)),
    "hires15k.coarse": (["-m", "500", "-c", "20"], (4096, 128, 1)),
}
HIRES = ["-w", "20000", "-h", "15000", "--min-imag", "-1.5",
         "--max-imag", "1.5"]


def _classify_spec(eng):
    """classify_pass's keywords for an engine's uniform f32 pass (as
    ``CudaEngine.classify`` passes them)."""
    cfg, tn = eng.cfg, eng.tuning
    return dict(fractal=eng.fractal, min_it=tn.min_it, max_it=tn.max_it,
                steps_per_pass=tn.steps_per_pass,
                steps_per_flush=tn.steps_per_flush,
                cycle_detection=cfg.options.cycle_detection,
                inner_unroll=tn.inner_unroll, thin_tracking=tn.thin_tracking,
                sample_domain=cfg.sample_domain,
                visit_window=eng.visit_window)


def _plain_pass(state, seed, spec):
    fr = spec["fractal"]
    return cls.classify_pass_plain(
        state, *seed, None, fractal=fr, min_it=spec["min_it"],
        max_it=spec["max_it"],
        chunks=spec["steps_per_pass"] // spec["steps_per_flush"],
        windows=spec["steps_per_flush"] // spec["inner_unroll"],
        unroll=spec["inner_unroll"], thin=spec["thin_tracking"],
        detect=spec["cycle_detection"] and fr.cycle_detect,
        sample_domain=spec["sample_domain"],
        visit_window=spec["visit_window"])


def _assert_same_result(ra, rb):
    for x, y in zip(ra.state, rb.state):
        assert _same(x, y)
    assert _same(ra.emit_c, rb.emit_c)
    assert _same(ra.emit_it, rb.emit_it)
    assert _same(ra.stats, rb.stats)


@pytest.mark.parametrize("cell", sorted(F32_CELLS))
def test_classify_slices_match_plain_at_the_f32_cells(cuda, cell):
    """The kernel's slice queue at each f32 cell's band and plan (64
    slices of 64 windows at default's and coarse's, cutting their chunks
    in two, 64 of 128 inside the one chunk of fine's, cutoff2000's and
    medium's 512 windows whole), on 16,384 of the cell's 262,144 lanes
    carried 2 passes, against the plain version bitwise."""
    argv, plan = F32_CELLS[cell]
    eng = CudaEngine(_cell(["-w", "1000", "-h", "1000", *argv]), device=cuda)
    tn = eng.tuning
    assert (tn.steps_per_pass, tn.steps_per_flush, tn.inner_unroll) == plan
    assert eng.lanes == 262144
    state = eng.init_state(None)
    for p in range(2):
        state = eng.run_pass(state, p)
    eng.synchronize()
    spec, seed = _classify_spec(eng), (0x5EED, 2 ** 31 + len(cell))
    # The plain version draws a chunk's words for every lane at once: 256
    # groups of the carried lanes keep fine's 8,192-window chunk in memory.
    a = cls.LaneState(*(t[:128].clone() for t in state["lanes"]))
    b = cls.LaneState(*(t[:128].clone() for t in state["lanes"]))
    launches.reset()
    ra = cls.classify_pass(a, seed, **spec)
    assert launches.COUNTS["classify"] == 1
    _assert_same_result(ra, _plain_pass(b, seed, spec))
    assert int(ra.stats[cls.STAT_DRAWN].sum()) > 0


def test_classify_slices_match_plain_behind_the_replay(cuda):
    """hires15k.coarse: the kernel launched right behind a pass whose
    replay (the fused replay on a high-priority side stream, ~10 ms into
    the 1.2 GB histogram) holds the SMs' registers, so part of its grid
    becomes resident late. The late warps are counted (tracing on: some,
    taking part of the items or none), and the pass equals the plain
    version bitwise."""
    from cudabrot_tpu_torch.utils import trace

    eng = CudaEngine(_cell([*HIRES, *F32_CELLS["hires15k.coarse"][0]]),
                     device=cuda)
    state = eng.init_state(None)
    for p in range(4):
        state = eng.run_pass(state, p)
    # Pass 3's replay runs on: the clones and the kernel queue behind pass
    # 3's main-stream work only.
    assert eng.replay_streams and not all(s.query()
                                          for s in eng.replay_streams)
    a = cls.LaneState(*(t.clone() for t in state["lanes"]))
    b = cls.LaneState(*(t.clone() for t in state["lanes"]))
    spec, seed = _classify_spec(eng), (77, 2 ** 32 - 5)
    trace.start()
    try:
        ra = cls.classify_pass(a, seed, **spec)
    finally:
        counts = trace.stop()
    eng.synchronize()
    assert counts["classify_late_warps"] > 0
    # 4,096 lane groups, 64 slices each at coarse's plan.
    assert 0 <= counts["classify_late_items"] < 4096 * 64
    _assert_same_result(ra, _plain_pass(b, seed, spec))


def test_classify_slices_repeat_bit_for_bit(cuda):
    """One pass at canvas1k.default's plan, 262,144 lanes, run 8 times on
    clones of one state, its outputs and their margins poisoned with
    another byte each run (chip_smoke.Guard, as its phase 12 does), and on
    one stream: every run equals the first bitwise, and the queue's words
    carried from launch to launch give the same pass each time."""
    import chip_smoke as cs

    eng = CudaEngine(_cell(["-w", "1000", "-h", "1000"]), device=cuda)
    state = eng.init_state(None)
    for p in range(2):
        state = eng.run_pass(state, p)
    eng.synchronize()
    spec, lanes = _classify_spec(eng), state["lanes"]

    def run(g):
        return cls.classify_pass(cs.tree_map(g.clone, lanes), (9, 10),
                                 **spec)

    first = cs.repeat_call("classify", run, 8, cuda, lanes=eng.lanes,
                           per_thread=2)
    b = cls.LaneState(*(t.clone() for t in lanes))
    want = cs.tree_leaves(_plain_pass(b, (9, 10), spec))
    assert cs.leaves_equal(first, want)


def test_classify_late_counts_only_under_tracing(cuda):
    """Untraced, the kernel counts nothing and its pass makes no host
    synchronisation (CUDA's sync debug mode raises on one); a traced
    render reports the late warps and their items in stats["trace"], an
    untraced one has no trace."""
    from torch.profiler import ProfilerActivity, profile

    from cudabrot_tpu_torch.utils import trace

    argv = ["-w", "64", "-h", "48", "--lane-rows", "64",
            "--steps-per-pass", "512", "--steps-per-flush", "64",
            "--passes", "4", "-t", "-1"]
    cfg = _cell(argv)
    eng = CudaEngine(cfg, device=cuda)
    state = eng.init_state(None)
    eng.run_pass(state, 0)
    eng.synchronize()
    spec = _classify_spec(eng)
    assert trace.device_counts("classify_late", cuda, cls.LATE_FIELDS) is None
    torch.cuda.set_sync_debug_mode("error")
    try:
        cls.classify_pass(state["lanes"], (1, 2), **spec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng.synchronize()
    plain = driver.run_render(cfg, engine=CudaEngine(cfg, device=cuda),
                              log=lambda msg: None)
    assert "trace" not in plain.stats
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = driver.run_render(cfg, engine=CudaEngine(cfg, device=cuda),
                                   log=lambda msg: None)
    t = traced.stats["trace"]
    assert set(cls.LATE_FIELDS) <= set(t)
    assert 0 <= t["classify_late_warps"] <= 64 * 128 // 64
    assert t["classify_late_items"] >= 0


@pytest.mark.parametrize("n", [1, 1000, 1 << 23])
def test_threefry_bits_kernel_matches_plain(cuda, n):
    key = prng.fold_in(prng.key(1337), 0x7711)
    assert torch.equal(prng.bits(key, n, cuda), prng.bits_plain(key, n, cuda))


@pytest.mark.parametrize("w,h", [(1000, 1000), (6000, 4500)])
def test_deposit_ids_kernel_matches_plain(cuda, w, h):
    nbins = w * h
    ids = torch.randint(0, nbins + 1, (1 << 22,), dtype=torch.int32,
                        device=cuda)
    hk = torch.zeros(nbins, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    binning.deposit_ids(hk, ids)
    binning.deposit_ids_plain(hp, ids)
    assert torch.equal(hk, hp)


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 4, 7, 1000, 100_003])
def test_deposit_ids_kernel_unaligned_views(cuda, off, n):
    """The kernel's 16-byte loads on views that start 0..3 ids past a
    16-byte boundary and end anywhere (its head and tail ids)."""
    nbins = 4099
    base = torch.randint(-2, nbins + 2, (n + 8,), dtype=torch.int32,
                         device=cuda)
    ids = base[off:off + n]
    hk = torch.arange(nbins, dtype=torch.int32, device=cuda)
    hp = hk.clone()
    binning.deposit_ids(hk, ids)
    binning.deposit_ids_plain(hp, ids)
    assert torch.equal(hk, hp)


@pytest.mark.parametrize("scatter", ["pallas", "sorted"])
@pytest.mark.parametrize("precision", ["float32", "extended"])
def test_id_routes_equal_the_fused_route_on_card(cuda, scatter, precision):
    """Two engine passes through an id-stream route render the fused
    route's histogram and stats bitwise, through the route's kernels."""
    win = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)
    out = {}
    for route in ("auto", scatter):
        cfg = config.RenderConfig(
            canvas=config.Canvas(width=64, height=48),
            band=config.IterationBand(max_escape_iterations=400,
                                      min_escape_iterations=20),
            sample_domain=win if precision == "extended" else
            config.SAMPLE_DOMAIN,
            options=config.EngineOptions(
                precision=precision, lane_rows=16, steps_per_pass=512,
                steps_per_flush=32, replay_capacity=1 << 14, scatter=route))
        eng = CudaEngine(cfg, device=cuda)
        state = eng.init_state(None)
        launches.reset()
        for p in range(2):
            eng.run_pass(state, p)
        out[route] = (eng.histogram(state), eng.stats(state),
                      launches.snapshot())
    (ha, sa, _), (hr, sr, counts) = out["auto"], out[scatter]
    assert np.array_equal(ha, hr) and sa == sr and sr["on_canvas_points"] > 0
    ids = "replay_ids_ext" if precision == "extended" else "replay_ids"
    assert counts[ids] == 2
    assert counts["deposit_ids"] == (2 if scatter == "pallas" else 0)
    assert counts["bigtiles_deposit"] == (0 if scatter == "pallas" else 2)
    assert not any(v for k, v in counts.items() if k.endswith("_plain"))


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_replay_deposit_kernel_matches_plain(cuda, name):
    canvas = config.Canvas(width=300, height=200, min_real=-2.0,
                           max_real=1.0, min_imag=-1.2, max_imag=1.2)
    g = torch.Generator(device=cuda).manual_seed(3)
    k = 1 << 16
    cr = torch.rand(k, generator=g, device=cuda) * 3.0 - 2.0
    ci = torch.rand(k, generator=g, device=cuda) * 3.0 - 1.5
    it = torch.randint(-1, 200, (k,), generator=g, device=cuda,
                       dtype=torch.int32)
    it = torch.sort(it, descending=True).values
    hk = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    hits_k = binning.replay_deposit(hk, cr, ci, it, canvas=canvas,
                                    fractal=FRACTALS[name])
    hits_p = binning.replay_deposit_plain(hp, cr, ci, it, canvas=canvas,
                                          fractal=FRACTALS[name])
    assert torch.equal(hk, hp)
    assert int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum())


def _replay_batch(cuda, kind):
    """A replay batch, sorted by descending length as compacted: 'ragged'
    (1000 emissions, not a multiple of 32), 'short' (40, fewer groups than
    any launch has resident warps), 'empty' (no emission, and 64 inactive
    ones), 'long' (one 19,999-step orbit at the head of 64), 'many'
    (100,000: at one resident warp per SM each warp takes two groups at
    once)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    k = {"ragged": 1000, "short": 40, "empty": 64, "long": 64,
         "many": 100_000}[kind]
    cr = torch.rand(k, generator=g, device=cuda) * 3.0 - 2.0
    ci = torch.rand(k, generator=g, device=cuda) * 3.0 - 1.5
    it = torch.randint(-1, 200, (k,), generator=g, device=cuda,
                       dtype=torch.int32)
    if kind == "empty":
        it.fill_(-1)
    if kind == "long":
        # c = -1 cycles through 0 and -1: all 19,999 points are on the
        # canvas.
        cr[0], ci[0] = -1.0, 0.0
        it[0] = 19_998
    return cr, ci, torch.sort(it, descending=True).values


@pytest.mark.parametrize("kind", ["ragged", "short", "empty", "long",
                                  "many"])
@pytest.mark.parametrize("warps", [4, 32, 1])
def test_replay_deposit_queue_matches_plain(cuda, monkeypatch, kind, warps):
    """The replay's queue at `warps` resident warps per SM against the
    plain version, bitwise."""
    monkeypatch.setattr(binning, "REPLAY_WARPS_PER_SM", warps)
    canvas = config.Canvas(width=300, height=200, min_real=-2.0,
                           max_real=1.0, min_imag=-1.2, max_imag=1.2)
    cr, ci, it = _replay_batch(cuda, kind)
    fr = FRACTALS["buddhabrot"]
    for n in ((0, cr.numel()) if kind == "empty" else (cr.numel(),)):
        hk = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=cuda)
        hp = torch.zeros_like(hk)
        hits_k = binning.replay_deposit(hk, cr[:n], ci[:n], it[:n],
                                        canvas=canvas, fractal=fr)
        hits_p = binning.replay_deposit_plain(hp, cr[:n], ci[:n], it[:n],
                                              canvas=canvas, fractal=fr)
        assert torch.equal(hk, hp)
        assert int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum())
        assert (int(hits_k) == 0) == (kind == "empty")
    if kind == "long":
        assert int(hits_k) >= 19_999
    if kind == "many" and warps == 1:
        assert binning.replay_launch(cr.numel(), cuda)[1] >= 2


#: Windows of the extended tests: a seahorse-valley deep zoom (orbits of
#: ~1000 steps), one just outside the set (~56 steps), a burning-ship crop.
DEEP = (-0.743643887037151 - 1e-7, -0.743643887037151 + 1e-7,
        0.131825904205330 - 1e-7, 0.131825904205330 + 1e-7)
FAST = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)
SHIP = (-1.7548 - 5e-7, -1.7548 + 5e-7, -0.0338 - 5e-7, -0.0338 + 5e-7)


@pytest.mark.parametrize("name,domain,band,visit,use_bits", [
    ("buddhabrot", DEEP, (50, 3000), False, False),
    ("buddhabrot", FAST, (20, 400), True, True),
    ("buddhabrot", config.SAMPLE_DOMAIN, (5, 200), True, False),
    ("burning-ship", SHIP, (5, 500), False, False),
    ("burning-ship", config.SAMPLE_DOMAIN, (5, 200), True, True),
    ("anti-buddhabrot", config.SAMPLE_DOMAIN, (0, 64), False, True),
    ("anti-buddhabrot", config.SAMPLE_DOMAIN, (0, 64), True, False),
])
def test_classify_ext_kernel_matches_plain(cuda, name, domain, band, visit,
                                           use_bits):
    rows, steps, flush, unroll = 16, 512, 64, 4
    kw = dict(fractal=FRACTALS[name], min_it=band[0], max_it=band[1],
              steps_per_pass=steps, steps_per_flush=flush,
              inner_unroll=unroll, sample_domain=domain,
              visit_window=(-1.5, 0.5, -1.0, 1.0) if visit else None)
    state = cx.init_ext_lane_state(rows, cuda)
    cx.classify_pass_ext(state, (5, 6), **kw)  # carried, mid-flight state
    a = cx.ExtLaneState(*(t.clone() for t in state))
    b = cx.ExtLaneState(*(t.clone() for t in state))
    bits = None
    if use_bits:
        shape = (steps // flush, flush // unroll, 2, rows, 128)
        bits = torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=cuda)
    launches.reset()
    ra = cx.classify_pass_ext(a, (7, 8), bits, **kw)
    assert launches.COUNTS["classify_ext"] == 1
    rb = cx.classify_pass_ext_plain(
        b, 7, 8, bits, fractal=kw["fractal"], min_it=band[0],
        max_it=band[1], chunks=steps // flush, windows=flush // unroll,
        unroll=unroll, detect=FRACTALS[name].cycle_detect,
        sample_domain=domain, visit_window=kw["visit_window"])
    for x, y in zip(ra.state, rb.state):
        assert _same(x, y)
    assert _same(ra.emit_c, rb.emit_c)
    assert _same(ra.emit_it, rb.emit_it)
    assert _same(ra.stats, rb.stats)
    assert int((ra.emit_it >= 0).sum()) > 0


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_replay_deposit_ext_kernel_matches_plain(cuda, name):
    canvas = config.Canvas(width=300, height=200, min_real=-2.0,
                           max_real=1.0, min_imag=-1.2, max_imag=1.2)
    g = torch.Generator(device=cuda).manual_seed(3)
    k = 1 << 14
    kr = torch.randint(0, 1 << 24, (k,), generator=g, device=cuda).float()
    ki = torch.randint(0, 1 << 24, (k,), generator=g, device=cuda).float()
    it = torch.randint(-1, 200, (k,), generator=g, device=cuda,
                       dtype=torch.int32)
    it = torch.sort(it, descending=True).values
    hk = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    kw = dict(canvas=canvas, fractal=FRACTALS[name], sample_domain=FAST)
    launches.reset()
    hits_k = binning.replay_deposit_ext(hk, kr, ki, it, **kw)
    assert launches.COUNTS["replay_deposit_ext"] == 1
    hits_p = binning.replay_deposit_ext_plain(hp, kr, ki, it, **kw)
    assert torch.equal(hk, hp)
    assert int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum()) > 0


@pytest.mark.parametrize("extended", [False, True])
def test_engine_pass_on_card_matches_cpu(cuda, extended):
    """Three engine passes on the card equal the same passes on the CPU
    bitwise: histogram, lane state and every counter, at float32 and at
    extended precision."""
    cfg = config.RenderConfig(
        canvas=config.Canvas(width=64, height=48),
        options=config.EngineOptions(lane_rows=8, steps_per_pass=256,
                                     steps_per_flush=32,
                                     replay_capacity=1 << 14),
    )
    if extended:
        cfg = config.RenderConfig(
            canvas=config.Canvas(width=64, height=48),
            band=config.IterationBand(max_escape_iterations=400,
                                      min_escape_iterations=20),
            sample_domain=FAST,
            options=config.EngineOptions(
                precision="extended", lane_rows=8, steps_per_pass=512,
                steps_per_flush=32, replay_capacity=1 << 12),
        )
    runs = []
    for dev in (cuda, "cpu"):
        eng = CudaEngine(cfg, device=dev)
        st = eng.init_state(None)
        for p in range(3):
            st = eng.run_pass(st, p)
        runs.append((eng.histogram(st), eng.stats(st), st["lanes"]))
    (hg, sg, lg), (hc, sc, lc) = runs
    np.testing.assert_array_equal(hg, hc)
    assert hg.sum() > 0
    assert sg == sc
    for x, y in zip(lg, lc):
        assert _same(x, y)


@pytest.mark.parametrize("name,domain,band,visit", [
    ("buddhabrot", DEEP, (50, 3000), False),
    ("buddhabrot", FAST, (20, 400), True),
    ("burning-ship", SHIP, (5, 500), False),
    ("anti-buddhabrot", config.SAMPLE_DOMAIN, (0, 64), True),
])
@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_classify_ext_kernel_unrolled_windows_match_plain(cuda, unroll, name,
                                                          domain, band,
                                                          visit):
    """classify_ext with its window unrolled at U = 1, 2, 4 and 8 against
    the plain version, bitwise, on 640 lanes, from a carried state."""
    rows, flush = 5, 16 * unroll
    kw = dict(fractal=FRACTALS[name], min_it=band[0], max_it=band[1],
              steps_per_pass=4 * flush, steps_per_flush=flush,
              inner_unroll=unroll, sample_domain=domain,
              visit_window=(-1.5, 0.5, -1.0, 1.0) if visit else None)
    state = cx.init_ext_lane_state(rows, cuda)
    # A carried, mid-flight state, beyond the band's cap: at the deep zoom
    # lanes live ~1000 steps.
    cx.classify_pass_ext(state, (5, 6), **dict(
        kw, steps_per_pass=-(-3200 // flush) * flush))
    a = cx.ExtLaneState(*(t.clone() for t in state))
    b = cx.ExtLaneState(*(t.clone() for t in state))
    launches.reset()
    ra = cx.classify_pass_ext(a, (7, 8), **kw)
    assert launches.COUNTS["classify_ext"] == 1
    rb = cx.classify_pass_ext_plain(
        b, 7, 8, None, fractal=kw["fractal"], min_it=band[0],
        max_it=band[1], chunks=4, windows=16, unroll=unroll,
        detect=FRACTALS[name].cycle_detect, sample_domain=domain,
        visit_window=kw["visit_window"])
    for f, x, y in zip(cx.ExtLaneState._fields, ra.state, rb.state):
        assert _same(x, y), f
    assert _same(ra.emit_c, rb.emit_c)
    assert _same(ra.emit_it, rb.emit_it)
    assert _same(ra.stats, rb.stats)
    assert int(ra.stats[cls.STAT_DRAWN].sum()) > 0


_SEA = (-0.743643887, 0.131825904)


def _deep_mh(span):
    """(sample domain 4x the window, centre-relative window) at the
    seahorse valley."""
    cx_, cy_ = _SEA
    dom = (cx_ - 2 * span, cx_ + 2 * span, cy_ - 2 * span, cy_ + 2 * span)
    return dom, (-span / 2, span / 2, -span / 2, span / 2)


@pytest.mark.parametrize("ext,name,domain,window,band,slots,use_bits", [
    (False, "buddhabrot", config.SAMPLE_DOMAIN, (-0.78, -0.72, 0.05, 0.11),
     (20, 300), 8, False),
    (False, "buddhabrot", config.SAMPLE_DOMAIN, config.SAMPLE_DOMAIN,
     (5, 200), 2, True),
    (False, "buddhabrot", config.SAMPLE_DOMAIN, (-1.5, 0.5, -1.0, 1.0),
     (5, 200), 32, False),
    (False, "burning-ship", config.SAMPLE_DOMAIN, (-1.8, -1.6, -0.1, 0.1),
     (20, 300), 4, False),
    (False, "anti-buddhabrot", config.SAMPLE_DOMAIN, (-0.6, 0.1, -0.4, 0.3),
     (0, 64), 16, True),
    (True, "buddhabrot", *_deep_mh(2e-5), (100, 3000), 8, False),
    (True, "buddhabrot", *_deep_mh(1e-3), (50, 1000), 4, True),
    (True, "buddhabrot", *_deep_mh(1e-2), (20, 300), 32, False),
    (True, "burning-ship", (-1.7648, -1.7448, -0.0438, -0.0238),
     (-0.005, 0.005, -0.005, 0.005), (5, 500), 2, False),
    (True, "anti-buddhabrot", config.SAMPLE_DOMAIN, (-0.6, 0.1, -0.4, 0.3),
     (0, 64), 16, True),
])
def test_classify_mh_kernels_match_plain(cuda, ext, name, domain, window,
                                         band, slots, use_bits):
    """classify_mh and classify_ext_mh against the plain version, bitwise,
    for every fractal and reservoir width, from a carried state."""
    rows, steps, flush, unroll = 16, 1024, 128, 4
    chunks, windows = steps // flush, flush // unroll
    fr = FRACTALS[name]
    kw = dict(fractal=fr, min_it=band[0], max_it=band[1],
              steps_per_pass=steps, steps_per_flush=flush,
              inner_unroll=unroll, sample_domain=domain, window=window,
              restart256=16, rep_cap=24, canvas_wh=(40, 37))
    init = cmh.init_ext_mh_lane_state if ext else cmh.init_mh_lane_state
    fn = cmh.classify_pass_ext_mh if ext else cmh.classify_pass_mh
    kernel = "classify_ext_mh" if ext else "classify_mh"
    state = init(rows, slots, cuda)
    fn(state, (5, 6), **kw)  # carried, mid-flight state
    a = type(state)(*(t.clone() for t in state))
    b = type(state)(*(t.clone() for t in state))
    bits = None
    if use_bits:
        bits = torch.randint(-2**31, 2**31, (chunks, windows, 4, rows, 128),
                             dtype=torch.int32, device=cuda)
    launches.reset()
    ra = fn(a, (7, 8), bits, **kw)
    assert launches.COUNTS[kernel] == 1
    assert launches.COUNTS[f"{kernel}_plain"] == 0
    wx0, wx1, wy0, wy1 = window
    rb = cmh.classify_pass_mh_plain(
        ext, b, 7, 8, bits, fractal=fr, min_it=band[0], max_it=band[1],
        chunks=chunks, windows=windows, unroll=unroll,
        detect=fr.cycle_detect, sample_domain=domain,
        window=(wx0, wx1, wy0, wy1, 40 / (wx1 - wx0), 37 / (wy1 - wy0)),
        restart256=16, rep_cap=24, canvas_wh=(40, 37))
    for f, x, y in zip(state._fields, ra.state, rb.state):
        assert _same(x, y), f
    for f in ("emit_it", "emit_rep", "emit_v", "emit_bins", "stats"):
        assert _same(getattr(ra, f), getattr(rb, f)), f
    assert int((ra.emit_it >= 0).sum()) > 0
    assert int(ra.stats[cmh.STAT_MH_ACCEPT].sum()) > 0


@pytest.mark.parametrize("slots", [2, 4, 8, 16, 32])
def test_classify_ext_mh_kernel_at_every_width_matches_plain(cuda, slots):
    """classify_ext_mh at every reservoir width against the plain version,
    bitwise, on 640 lanes from a carried state at a seahorse-valley zoom
    (U = 16, as at the mhzoom cell)."""
    domain, window = _deep_mh(1e-3)
    rows, steps, flush, unroll = 5, 2048, 256, 16
    fr = FRACTALS["buddhabrot"]
    kw = dict(fractal=fr, min_it=50, max_it=1000, steps_per_pass=steps,
              steps_per_flush=flush, inner_unroll=unroll,
              sample_domain=domain, window=window, restart256=16,
              rep_cap=24, canvas_wh=(40, 37))
    state = cmh.init_ext_mh_lane_state(rows, slots, cuda)
    cmh.classify_pass_ext_mh(state, (5, 6), **kw)
    a = type(state)(*(t.clone() for t in state))
    b = type(state)(*(t.clone() for t in state))
    launches.reset()
    ra = cmh.classify_pass_ext_mh(a, (7, 8), **kw)
    assert launches.COUNTS["classify_ext_mh"] == 1
    wx0, wx1, wy0, wy1 = window
    rb = cmh.classify_pass_mh_plain(
        True, b, 7, 8, None, fractal=fr, min_it=50, max_it=1000,
        chunks=steps // flush, windows=flush // unroll, unroll=unroll,
        detect=True, sample_domain=domain,
        window=(wx0, wx1, wy0, wy1, 40 / (wx1 - wx0), 37 / (wy1 - wy0)),
        restart256=16, rep_cap=24, canvas_wh=(40, 37))
    for f, x, y in zip(state._fields, ra.state, rb.state):
        assert _same(x, y), f
    for f in ("emit_it", "emit_rep", "emit_v", "emit_bins", "stats"):
        assert _same(getattr(ra, f), getattr(rb, f)), f
    assert int((ra.emit_it >= 0).sum()) > 0
    assert int(ra.stats[cmh.STAT_MH_ACCEPT].sum()) > 0


@pytest.mark.parametrize("chunks,slots", [(1, 2), (4, 8), (3, 32)])
def test_mh_deposit_kernel_matches_plain(cuda, chunks, slots):
    """mh_deposit against mh_scatter's plain version over the documented
    extremes (t <= 1, v at the 32767 cap, rep at 98303), out-of-range bins
    included: histogram and both totals."""
    lanes, nbins = 4096, 1000 * 1000
    g = torch.Generator(device=cuda).manual_seed(slots)
    n = chunks * lanes
    v = torch.randint(1, 32768, (n,), generator=g, device=cuda)
    v[:4] = torch.tensor([1, 32767, 32767, 9], device=cuda)
    rep = torch.randint(1, 98304, (n,), generator=g, device=cuda)
    rep[:4] = torch.tensor([98303, 98303, 1, 4096], device=cuda)
    t = (256 * v + 1).to(torch.int32)
    t[torch.rand(n, generator=g, device=cuda) < 0.3] = 0
    t[4:8] = torch.tensor([1, -3, 0, 1], dtype=torch.int32, device=cuda)
    rep = rep.to(torch.int32)
    bins = torch.randint(0, nbins, (chunks, slots, lanes), generator=g,
                         device=cuda, dtype=torch.int32)
    bins[0, 0, :3] = torch.tensor([-1, nbins, nbins + 7], dtype=torch.int32,
                                  device=cuda)
    hk = torch.zeros(nbins, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    launches.reset()
    dep_k, mass_k = binning.mh_deposit(
        hk, bins, t.view(chunks, lanes), rep.view(chunks, lanes),
        chunked=True)
    assert launches.COUNTS["mh_deposit"] == 1
    assert launches.COUNTS["mh_deposit_plain"] == 0
    flat = bins.transpose(0, 1).reshape(slots, n)
    _, dep_p, mass_p = binning.mh_scatter(hp, flat, t, rep)
    assert torch.equal(hk, hp)
    assert int(dep_k) == int(dep_p.sum()) > 0
    assert int(mass_k) == int(mass_p.sum()) > 0
    # The flat (V, S) layout is the one-chunk case.
    hk2 = torch.zeros_like(hk)
    dep2, mass2 = binning.mh_deposit(hk2, flat.contiguous(), t, rep)
    assert torch.equal(hk2, hp)
    assert (int(dep2), int(mass2)) == (int(dep_k), int(mass_k))
    # A gate the kernel reads itself, and totals it adds into.
    gate = torch.randint(-2, 3, (chunks, lanes), generator=g, device=cuda,
                         dtype=torch.int32)
    hk3, hp3 = torch.zeros_like(hk), torch.zeros_like(hk)
    totals = (torch.full((), 11, dtype=torch.int64, device=cuda),
              torch.full((), 13, dtype=torch.int64, device=cuda))
    binning.mh_deposit(hk3, bins, t.view(chunks, lanes),
                       rep.view(chunks, lanes), chunked=True, gate=gate,
                       gate_min=1, totals=totals)
    _, dep3, mass3 = binning.mh_scatter(
        hp3, flat, torch.where(gate.reshape(-1) >= 1, t, 0), rep)
    assert torch.equal(hk3, hp3)
    assert (int(totals[0]), int(totals[1])) == (int(dep3.sum()) + 11,
                                                int(mass3.sum()) + 13)


def _mh_cell_buffers(cuda, cell, passes=3):
    """A cell's engine and the emission buffers of one main-path pass
    from a state carried ``passes`` passes."""
    argv = (MHCROP if cell == "mhcrop"
            else ["-w", "1000", "-h", "1000", *ZOOM, "--sampler", "mh"])
    eng = CudaEngine(cli.parse_args(argv)[0], device=cuda)
    state = eng.init_state(None)
    for p in range(passes):
        eng.run_pass(state, p)
    fn = (cmh.classify_pass_ext_mh if eng.extended
          else cmh.classify_pass_mh)
    return eng, state, fn(state["lanes"], (77, 78), **eng.mh_pass_spec())


@pytest.mark.parametrize("cell", ["mhcrop", "mhzoom"])
def test_mh_deposit_at_the_mh_cells_matches_plain(cuda, cell):
    """mh_deposit on a main-path pass's emission buffers at mhcrop and
    mhzoom, gated by emit_it as the engine calls it, and on the tail
    flush's flat (V, lanes) batch gated by rep: histogram and totals
    against mh_scatter, bitwise."""
    eng, state, res = _mh_cell_buffers(cuda, cell)
    nbins = eng.cfg.canvas.num_pixels
    lanes = state["lanes"]
    slots = eng.visit_slots
    cases = (
        (res.emit_bins, res.emit_v, res.emit_rep, res.emit_it, 0,
         res.emit_bins.shape[0], True),
        (lanes.xb, lanes.xv, lanes.rep, lanes.rep, 1, 1, False),
    )
    for bins, t, rep, gate, gate_min, chunks, chunked in cases:
        hk, hp = (torch.zeros(nbins, dtype=torch.int32, device=cuda)
                  for _ in range(2))
        dk, mk = (torch.zeros((), dtype=torch.int64, device=cuda)
                  for _ in range(2))
        binning.mh_deposit(hk, bins, t, rep, chunked=chunked, gate=gate,
                           gate_min=gate_min, totals=(dk, mk))
        flat = bins.reshape(chunks, slots, -1).transpose(0, 1).reshape(
            slots, -1)
        _, dp, mp = binning.mh_scatter(
            hp, flat, torch.where(gate >= gate_min, t, 0).reshape(-1),
            rep.reshape(-1))
        assert torch.equal(hk, hp)
        assert int(dk) == int(dp.sum()) > 0
        assert int(mk) == int(mp.sum()) == int(hp.to(torch.int64).sum()) > 0


def test_mh_deposit_hot_bins_match_plain(cuda):
    """A stream whose pairs crowd a few bins (every bin one of 3, and one
    chunk all one bin): the histogram equals mh_scatter's bitwise, wrapped
    sums included."""
    g = torch.Generator(device=cuda).manual_seed(3)
    chunks, slots, lanes, nbins = 4, 8, 8192, 1000
    n = chunks * lanes
    v = torch.randint(1, 64, (n,), generator=g, device=cuda)
    t = (256 * v + 1).to(torch.int32)
    rep = torch.randint(1, 98304, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    bins = torch.randint(0, 3, (chunks, slots, lanes), generator=g,
                         device=cuda, dtype=torch.int32) * 7
    bins[1] = 500
    hist0 = torch.randint(-(1 << 31), 1 << 31, (nbins,), generator=g,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    hk, hp = hist0.clone(), hist0.clone()
    dk, mk = (torch.zeros((), dtype=torch.int64, device=cuda)
              for _ in range(2))
    binning.mh_deposit(hk, bins, t.view(chunks, lanes),
                       rep.view(chunks, lanes), chunked=True, totals=(dk, mk))
    _, dp, mp = binning.mh_scatter(
        hp, bins.transpose(0, 1).reshape(slots, n), t, rep)
    assert torch.equal(hk, hp)
    assert (int(dk), int(mk)) == (int(dp.sum()), int(mp.sum()))


def test_mh_engine_pass_counts_equal_the_histogram(cuda):
    """Engine passes at mhcrop, then the tail flush: one mh_deposit launch
    a pass, and points == mh_deposited == the histogram's sum."""
    eng = CudaEngine(cli.parse_args(MHCROP)[0], device=cuda)
    state = eng.init_state(None)
    launches.reset()
    for p in range(3):
        eng.run_pass(state, p)
    assert launches.COUNTS["mh_deposit"] == 3 - eng.cfg.options.mh_burnin_passes
    hist = eng.histogram(state)
    st = eng.stats(state)
    assert launches.COUNTS["mh_deposit"] == 4 - eng.cfg.options.mh_burnin_passes
    assert int(hist.sum(dtype=np.uint64)) == st["mh_deposited"] > 0
    assert st["orbit_points"] > 0


@pytest.mark.parametrize("extended", [False, True])
def test_mh_engine_pass_on_card_matches_cpu(cuda, extended):
    """Three MH engine passes and the tail flush on the card equal the same
    on the CPU bitwise: histogram, lane state and every counter, at float32
    and at extended precision. The card run goes through the kernels."""
    if extended:
        cx_, cy_ = _SEA
        span = 1e-3
        cfg = config.RenderConfig(
            canvas=config.Canvas(
                width=32, height=32, min_real=cx_ - span / 2,
                max_real=cx_ + span / 2, min_imag=cy_ - span / 2,
                max_imag=cy_ + span / 2),
            band=config.IterationBand(max_escape_iterations=1000,
                                      min_escape_iterations=50),
            sample_domain=_deep_mh(span)[0],
            options=config.EngineOptions(
                sampler="mh", precision="extended", lane_rows=8,
                steps_per_pass=1024, steps_per_flush=256, inner_unroll=4,
                mh_burnin_passes=1))
    else:
        cfg = config.RenderConfig(
            canvas=config.Canvas(width=40, height=40, min_real=-0.78,
                                 max_real=-0.72, min_imag=0.05,
                                 max_imag=0.11),
            band=config.IterationBand(max_escape_iterations=300,
                                      min_escape_iterations=20),
            options=config.EngineOptions(
                sampler="mh", lane_rows=8, steps_per_pass=1024,
                steps_per_flush=128, mh_burnin_passes=1))
    runs = []
    for dev in (cuda, "cpu"):
        launches.reset()
        eng = CudaEngine(cfg, device=dev)
        st = eng.init_state(None)
        for p in range(3):
            st = eng.run_pass(st, p)
        runs.append((eng.histogram(st), eng.stats(st), st["lanes"]))
        kernel = "classify_ext_mh" if extended else "classify_mh"
        suffix = "" if dev == cuda else "_plain"
        assert launches.COUNTS[kernel + suffix] == 3
        assert launches.COUNTS["mh_deposit" + suffix] == 3
    (hg, sg, lg), (hc, sc, lc) = runs
    np.testing.assert_array_equal(hg, hc)
    assert int(hg.sum()) == sg["mh_deposited"] > 0
    assert sg == sc
    for f, x, y in zip(lg._fields, lg, lc):
        assert _same(x, y), f


def _sorted_streams(nbins, n, device):
    """Sorted id streams of the bigtiles deposit's cases: random with 10%
    sentinels, clustered in 1/50 of the bins, one id repeated across
    several chunks, and ids beyond the sentinel and below zero."""
    g = torch.Generator(device=device).manual_seed(nbins % 1000)
    rnd = torch.randint(0, nbins, (n,), generator=g, device=device,
                        dtype=torch.int32)
    rnd[torch.rand(n, generator=g, device=device) < 0.1] = nbins
    clustered = torch.randint(0, max(nbins // 50, 1), (n,), generator=g,
                              device=device, dtype=torch.int32)
    repeated = torch.full((3 * 8192 + 17,), nbins // 3, dtype=torch.int32,
                          device=device)
    edges = torch.tensor([-5, 0, 0, nbins - 1, nbins, nbins + 9, 2**31 - 1],
                         dtype=torch.int32, device=device)
    return [torch.sort(x).values for x in (rnd, clustered, repeated, edges)]


@pytest.mark.parametrize("w,h", [(1000, 1000), (6000, 4500), (20000, 20000)])
def test_bigtiles_deposit_kernel_matches_plain(cuda, w, h):
    nbins = w * h
    for ids in _sorted_streams(nbins, 1 << 22, cuda):
        for chunk in (0, 256):
            hk = torch.zeros(nbins, dtype=torch.int32, device=cuda)
            hp = torch.zeros_like(hk)
            launches.reset()
            binning.bigtiles_deposit(hk, ids, chunk=chunk)
            assert launches.COUNTS["bigtiles_deposit"] == 1
            assert launches.COUNTS["bigtiles_deposit_plain"] == 0
            binning.bigtiles_deposit_plain(hp, ids)
            assert torch.equal(hk, hp)
            want = int(((ids >= 0) & (ids < nbins)).sum())
            assert int(hk.to(torch.int64).sum()) == want
        del hk, hp


def _offsets(it):
    off, ends = binning.id_offsets(it)
    return off, int(ends[-1])


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_replay_ids_kernel_matches_plain(cuda, name):
    canvas = config.Canvas(width=300, height=200, min_real=-2.0,
                           max_real=1.0, min_imag=-1.2, max_imag=1.2)
    g = torch.Generator(device=cuda).manual_seed(4)
    k = 1 << 16
    cr = torch.rand(k, generator=g, device=cuda) * 3.0 - 2.0
    ci = torch.rand(k, generator=g, device=cuda) * 3.0 - 1.5
    it = torch.randint(-1, 200, (k,), generator=g, device=cuda,
                       dtype=torch.int32)
    it = torch.sort(it, descending=True).values
    off, n = _offsets(it)
    kw = dict(canvas=canvas, fractal=FRACTALS[name])
    launches.reset()
    ids_k, hits_k = binning.replay_ids(cr, ci, it, off, n, **kw)
    assert launches.COUNTS["replay_ids"] == 1
    ids_p, hits_p = binning.replay_ids_plain(cr, ci, it, off, n, **kw)
    assert torch.equal(ids_k, ids_p)
    assert int(hits_k) == int(hits_p) == int((ids_k < canvas.num_pixels).sum())
    # The ids count into the fused kernel's histogram.
    hf = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=cuda)
    binning.replay_deposit(hf, cr, ci, it, **kw)
    hb = binning.bigtiles_deposit(torch.zeros_like(hf),
                                  torch.sort(ids_k).values)
    assert torch.equal(hb, hf)


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_replay_ids_ext_kernel_matches_plain(cuda, name):
    canvas = config.Canvas(width=300, height=200, min_real=-2.0,
                           max_real=1.0, min_imag=-1.2, max_imag=1.2)
    g = torch.Generator(device=cuda).manual_seed(5)
    k = 1 << 14
    kr = torch.randint(0, 1 << 24, (k,), generator=g, device=cuda).float()
    ki = torch.randint(0, 1 << 24, (k,), generator=g, device=cuda).float()
    it = torch.randint(-1, 200, (k,), generator=g, device=cuda,
                       dtype=torch.int32)
    it = torch.sort(it, descending=True).values
    off, n = _offsets(it)
    kw = dict(canvas=canvas, fractal=FRACTALS[name], sample_domain=FAST)
    launches.reset()
    ids_k, hits_k = binning.replay_ids_ext(kr, ki, it, off, n, **kw)
    assert launches.COUNTS["replay_ids_ext"] == 1
    ids_p, hits_p = binning.replay_ids_ext_plain(kr, ki, it, off, n, **kw)
    assert torch.equal(ids_k, ids_p)
    assert int(hits_k) == int(hits_p) > 0
    hf = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=cuda)
    binning.replay_deposit_ext(hf, kr, ki, it, **kw)
    hb = binning.bigtiles_deposit(torch.zeros_like(hf),
                                  torch.sort(ids_k).values)
    assert torch.equal(hb, hf)


@pytest.mark.parametrize("extended", [False, True])
def test_bigtiles_engine_pass_on_card_matches_fused(cuda, extended,
                                                   monkeypatch):
    """Three engine passes with --scatter bigtiles on the card equal the
    fused route's passes on the card and the bigtiles passes on the CPU,
    bitwise: histogram and every counter. A small id budget splits each
    pass into several groups."""
    cfg = config.RenderConfig(
        canvas=config.Canvas(width=64, height=48),
        options=config.EngineOptions(lane_rows=8, steps_per_pass=256,
                                     steps_per_flush=32,
                                     replay_capacity=1 << 14),
    )
    if extended:
        cfg = config.RenderConfig(
            canvas=config.Canvas(width=64, height=48),
            band=config.IterationBand(max_escape_iterations=400,
                                      min_escape_iterations=20),
            sample_domain=FAST,
            options=config.EngineOptions(
                precision="extended", lane_rows=8, steps_per_pass=512,
                steps_per_flush=32, replay_capacity=1 << 12),
        )
    monkeypatch.setattr(binning, "BIGTILES_ID_BUDGET", 1 << 12)
    runs = []
    for dev, scatter in ((cuda, "bigtiles"), (cuda, "auto"),
                         ("cpu", "bigtiles")):
        opts = dataclasses.replace(cfg.options, scatter=scatter)
        eng = CudaEngine(dataclasses.replace(cfg, options=opts), device=dev)
        st = eng.init_state(None)
        launches.reset()
        for p in range(3):
            st = eng.run_pass(st, p)
        if dev == cuda and scatter == "bigtiles":
            kernel = "replay_ids_ext" if extended else "replay_ids"
            assert launches.COUNTS[kernel] > 3
            assert launches.COUNTS["bigtiles_deposit"] > 3
            assert launches.COUNTS[kernel + "_plain"] == 0
        runs.append((eng.histogram(st), eng.stats(st)))
    (hb, sb), (hf, sf), (hc, sc) = runs
    assert hb.sum() > 0
    np.testing.assert_array_equal(hb, hf)
    np.testing.assert_array_equal(hb, hc)
    assert sb == sf == sc


#: The deep-zoom cell (the JAX package's deep-zoom configuration, at
#: 1000x1000) and the cells whose passes the overlap test runs.
ZOOM = ["-m", "20000", "-c", "500", "--precision", "extended", "--center",
        "-0.743643887037151,0.131825904205330", "--span", "1e-5"]
CELLS = {"default": ["-w", "1000", "-h", "1000"],
         "deep": ["-w", "1000", "-h", "1000", "-m", "20000", "-c", "2000"],
         "zoom": ["-w", "1000", "-h", "1000", *ZOOM]}
BIG_CELLS = {
    "bigcanvas": ["-w", "6000", "-h", "4500", "--min-imag", "-1.5",
                  "--max-imag", "1.5"],
    "northstar": ["-w", "20000", "-h", "20000", "-m", "20000", "-c", "2000"],
    "bigzoom": ["-w", "6000", "-h", "4500", *ZOOM]}


def _cell(argv, scatter="auto"):
    return cli.parse_args([*argv, "--scatter", scatter])[0]


@pytest.fixture(scope="module")
def zoom_batch():
    """One pass's kept batch of the zoom cell at full lane width, from a
    state carried 8 passes, with its longest orbit set to 19,999 steps:
    (kr, ki, iters), descending orbit length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    cfg = _cell(CELLS["zoom"])
    eng = CudaEngine(cfg, device="cuda")
    tn = eng.tuning
    state = eng.init_state(None)
    for p in range(8):
        eng.run_pass(state, p)
    key = prng.pass_key(cfg.seed, 0, 9)
    res = cx.classify_pass_ext(
        state["lanes"], prng.bits_host(key, 2), fractal=eng.fractal,
        min_it=tn.min_it, max_it=tn.max_it, steps_per_pass=tn.steps_per_pass,
        steps_per_flush=tn.steps_per_flush, inner_unroll=tn.inner_unroll,
        sample_domain=cfg.sample_domain)
    kr, ki, it, _ = compact(res.emit_c, res.emit_it, key, tn.replay_capacity,
                            tn.max_it)
    it = it.clone()
    it[0] = 19_998
    return kr, ki, it


@pytest.mark.parametrize("cell", ["zoom", "bigzoom"])
def test_replay_ext_kernels_match_plain_on_the_zoom_batch(cuda, zoom_batch,
                                                          cell):
    """Both df32 replay kernels against their plain versions, bitwise, on
    the zoom cell's whole kept batch with a 19,999-step orbit at its head,
    at the zoom canvas and at the bigzoom canvas (6000x4500)."""
    kr, ki, it = zoom_batch
    cfg = _cell(CELLS["zoom"] if cell == "zoom" else BIG_CELLS[cell])
    kw = dict(canvas=cfg.canvas, fractal=FRACTALS["buddhabrot"],
              sample_domain=cfg.sample_domain)
    nbins = cfg.canvas.num_pixels
    hk = torch.zeros(nbins, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    launches.reset()
    hits_k = binning.replay_deposit_ext(hk, kr, ki, it, **kw)
    assert launches.COUNTS["replay_deposit_ext"] == 1
    hits_p = binning.replay_deposit_ext_plain(hp, kr, ki, it, **kw)
    assert torch.equal(hk, hp)
    assert int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum()) > 0
    off, n = _offsets(it)
    ids_k, ids_hits = binning.replay_ids_ext(kr, ki, it, off, n, **kw)
    assert launches.COUNTS["replay_ids_ext"] == 1
    ids_p, ids_hits_p = binning.replay_ids_ext_plain(kr, ki, it, off, n, **kw)
    assert torch.equal(ids_k, ids_p)
    assert int(ids_hits) == int(ids_hits_p) == int(hits_k)
    assert int((ids_k == nbins).sum()) > 0  # the sentinel fill shows


def test_replay_ext_kernels_match_plain_on_a_lone_long_orbit(cuda,
                                                             zoom_batch):
    """A batch of one 19,999-step orbit (one thread of one warp) and the
    batch's first 33 orbits (a second group of one), both kernels."""
    kr, ki, it = zoom_batch
    cfg = _cell(CELLS["zoom"])
    kw = dict(canvas=cfg.canvas, fractal=FRACTALS["buddhabrot"],
              sample_domain=cfg.sample_domain)
    for k in (1, 33):
        hk = torch.zeros(cfg.canvas.num_pixels, dtype=torch.int32,
                         device=cuda)
        hp = torch.zeros_like(hk)
        hits = binning.replay_deposit_ext(hk, kr[:k], ki[:k], it[:k], **kw)
        hits_p = binning.replay_deposit_ext_plain(hp, kr[:k], ki[:k], it[:k],
                                                  **kw)
        assert torch.equal(hk, hp) and int(hits) == int(hits_p)
        off, n = _offsets(it[:k])
        ids_k, _ = binning.replay_ids_ext(kr[:k], ki[:k], it[:k], off, n,
                                          **kw)
        ids_p, _ = binning.replay_ids_ext_plain(kr[:k], ki[:k], it[:k], off,
                                                n, **kw)
        assert torch.equal(ids_k, ids_p)


def _passes(cfg, n, mode):
    """n engine passes of ``cfg`` on the card: "overlap" as the driver runs
    them (the fused replay on its side streams, no synchronization),
    "serial" with a synchronize() after each, "main" with the replay on the
    main stream. Returns (histogram, stats)."""
    eng = CudaEngine(cfg, device="cuda")
    if mode == "main":
        eng.replay_streams = []
    state = eng.init_state(None)
    for p in range(n):
        eng.run_pass(state, p)
        if mode == "serial":
            eng.synchronize()
    return eng.histogram(state), eng.stats(state)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_overlapped_passes_equal_serial_passes(cuda, cell):
    """Engine passes with the fused replay overlapping the next pass equal
    the same passes run one after another, bitwise: histogram and every
    stat, at the default, deep and zoom cells."""
    cfg = _cell(CELLS[cell])
    runs = {mode: _passes(cfg, 6, mode)
            for mode in ("overlap", "serial", "main")}
    (ho, so), (hs, ss), (hm, sm) = (runs[m] for m in
                                    ("overlap", "serial", "main"))
    assert CudaEngine(cfg, device="cuda").replay_streams
    np.testing.assert_array_equal(ho, hs)
    np.testing.assert_array_equal(ho, hm)
    assert int(ho.sum(dtype=np.uint64)) == so["on_canvas_points"] > 0
    assert so == ss == sm


#: The bands of the group-wait tests: the default, and the cutoff example's
#: [2000, 20000) (the "deep" cell).
GROUP_CELLS = {"default": CELLS["default"], "cutoff2000": CELLS["deep"]}


def _fixed(cfg, passes, depth):
    """``cfg`` as ``passes`` passes, ``depth`` a group, no time box."""
    opts = dataclasses.replace(cfg.options, pipeline_depth=depth)
    return dataclasses.replace(cfg, seconds_to_run=-1.0, max_passes=passes,
                               options=opts)


@pytest.mark.parametrize("cell", sorted(GROUP_CELLS))
def test_group_wait_render_equals_a_synchronize_every_pass(cuda, cell):
    """A render whose group ends wait for the main stream only (the last
    replays run on into the next group) equals one that synchronizes the
    device after every pass, bitwise: histogram and every stat."""
    cfg = _fixed(_cell(GROUP_CELLS[cell]), 20, 4)
    runs = []
    for serial in (False, True):
        eng = CudaEngine(cfg, device="cuda")
        assert eng.replay_streams
        if serial:
            eng.run_pass = lambda state, p, run=eng.run_pass, e=eng: (
                run(state, p), e.synchronize())[0]
        res = driver.run_render(cfg, engine=eng, log=lambda s: None)
        assert res.passes == 20
        runs.append((res.histogram, res.stats))
    (hg, sg), (hs, ss) = runs
    np.testing.assert_array_equal(hg, hs)
    assert sg == ss
    assert int(hg.sum(dtype=np.uint64)) == sg["on_canvas_points"] > 0


@pytest.mark.parametrize("cell", sorted(GROUP_CELLS))
def test_group_wait_keeps_at_most_one_group_of_replays_behind(cuda, cell):
    """At each group end the main stream has drained, and every event
    recorded on a side stream before the previous group end has
    completed: at most one group of replays trails the main stream."""
    cfg = _fixed(_cell(GROUP_CELLS[cell]), 20, 4)
    eng = CudaEngine(cfg, device="cuda")
    run, group = eng.run_pass, eng.sync_group
    recorded, before_previous_end = [], []
    ends = [0]

    def run_pass(state, p):
        state = run(state, p)
        recorded.extend(s.record_event() for s in eng.replay_streams)
        return state

    def sync_group():
        group()
        ends[0] += 1
        assert torch.cuda.current_stream(eng.device).query()
        assert all(ev.query() for ev in before_previous_end)
        before_previous_end[:] = recorded

    eng.run_pass, eng.sync_group = run_pass, sync_group
    res = driver.run_render(cfg, engine=eng, log=lambda s: None)
    assert res.passes == 20 and ends[0] == 5
    assert all(ev.query() for ev in recorded)


@pytest.mark.parametrize("cell", sorted(BIG_CELLS))
def test_bigtiles_route_equals_fused_route_at_the_big_cells(cuda, cell):
    """--scatter bigtiles against --scatter auto (whose replay overlaps the
    next pass) at the three canvases beyond the L2: two passes each,
    histogram and every stat bitwise."""
    out = {}
    for scatter in ("bigtiles", "auto"):
        eng = CudaEngine(_cell(BIG_CELLS[cell], scatter), device="cuda")
        assert bool(eng.replay_streams) == (scatter == "auto")
        state = eng.init_state(None)
        launches.reset()
        for p in range(2):
            eng.run_pass(state, p)
        out[scatter] = (eng.histogram(state), eng.stats(state),
                        dict(launches.COUNTS))
        del eng, state
        torch.cuda.empty_cache()
    (hb, sb, cb), (ha, sa, _) = out["bigtiles"], out["auto"]
    assert cb["bigtiles_deposit"] >= 2
    np.testing.assert_array_equal(hb, ha)
    assert sb == sa and sb["on_canvas_points"] > 0


@pytest.fixture(scope="module")
def big_batches():
    """One pass's kept batch at the bigcanvas and northstar cells, from a
    state carried 2 passes: {cell: (cr, ci, iters)}, descending orbit
    length, cut to the bigtiles route's id budget as its groups are."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    out = {}
    for cell in ("bigcanvas", "northstar"):
        cfg = _cell(BIG_CELLS[cell], "bigtiles")
        eng = CudaEngine(cfg, device="cuda")
        tn = eng.tuning
        state = eng.init_state(None)
        for p in range(2):
            eng.run_pass(state, p)
        key = prng.pass_key(cfg.seed, 0, 3)
        res = cls.classify_pass(
            state["lanes"], prng.bits_host(key, 2), fractal=eng.fractal,
            min_it=tn.min_it, max_it=tn.max_it,
            steps_per_pass=tn.steps_per_pass,
            steps_per_flush=tn.steps_per_flush, cycle_detection=True,
            inner_unroll=tn.inner_unroll, thin_tracking=tn.thin_tracking)
        cr, ci, it, _ = compact(res.emit_c, res.emit_it, key,
                                tn.replay_capacity, tn.max_it)
        ends = torch.cumsum(torch.clamp(it.to(torch.int64) + 1, min=0), 0)
        k = int(torch.searchsorted(
            ends, torch.tensor(binning.BIGTILES_ID_BUDGET, device="cuda"),
            right=True))
        out[cell] = (cr[:k], ci[:k], it[:k], cfg.canvas)
        del eng, state, res
        torch.cuda.empty_cache()
    return out


@pytest.mark.parametrize("take", ["default", "one"])
@pytest.mark.parametrize("cell", ["bigcanvas", "northstar"])
def test_replay_ids_at_the_big_cells_matches_plain(cuda, monkeypatch,
                                                   big_batches, cell, take):
    """replay_ids on a pass's kept batch of the bigcanvas (~3e6 orbits of
    ~40 points) and northstar (~6,000 of ~5,000) cells, at the queue's
    default take and at one group a take, against replay_ids_plain word for
    word, and its hit count."""
    if take == "one":
        monkeypatch.setattr(binning, "REPLAY_TAKES_PER_WARP", 1 << 30)
    cr, ci, it, canvas = big_batches[cell]
    k = cr.numel()
    groups_a_take = binning.replay_launch(k, cuda)[1]
    assert (groups_a_take == 1) == (take == "one" or cell == "northstar")
    off, n = _offsets(it)
    kw = dict(canvas=canvas, fractal=FRACTALS["buddhabrot"])
    launches.reset()
    ids_k, hits_k = binning.replay_ids(cr, ci, it, off, n, **kw)
    assert launches.COUNTS["replay_ids"] == 1
    ids_p, hits_p = binning.replay_ids_plain(cr, ci, it, off, n, **kw)
    assert torch.equal(ids_k, ids_p)
    assert int(hits_k) == int(hits_p) > 0


MHCROP = ["-w", "1000", "-h", "1000", "--sampler", "mh", "--center",
          "-0.7436,0.1319", "--span", "6e-3", "-m", "500", "-c", "50"]


@pytest.mark.parametrize("cell,slots", [("mhcrop", 8), ("mhcrop", 32),
                                        ("mhzoom", 8)])
def test_mh_classify_at_the_mh_cells_matches_plain(cuda, cell, slots):
    """classify_mh at the mhcrop cell (V = 8, the default, and V = 32, the
    widest) and classify_ext_mh at mhzoom: one main-path pass at full lane
    width from a state carried 2 passes, against classify_pass_mh_plain,
    bitwise."""
    argv = (MHCROP if cell == "mhcrop"
            else ["-w", "1000", "-h", "1000", *ZOOM, "--sampler", "mh"])
    cfg = cli.parse_args([*argv, "--mh-visit-slots", str(slots)])[0]
    eng = CudaEngine(cfg, device=cuda)
    spec = eng.mh_pass_spec()
    ext = eng.extended
    fn = cmh.classify_pass_ext_mh if ext else cmh.classify_pass_mh
    state = eng.init_state(None)["lanes"]
    assert state.vb.shape[0] == slots
    for p in range(2):
        fn(state, (1337, p), **spec)
    a = type(state)(*(t.clone() for t in state))
    b = type(state)(*(t.clone() for t in state))
    ra = fn(a, (0xC0FFEE, 0xBADF00D), **spec)
    wx0, wx1, wy0, wy1 = spec["window"]
    cw, ch = spec["canvas_wh"]
    rb = cmh.classify_pass_mh_plain(
        ext, b, 0xC0FFEE, 0xBADF00D, None, fractal=spec["fractal"],
        min_it=spec["min_it"], max_it=spec["max_it"],
        chunks=spec["steps_per_pass"] // spec["steps_per_flush"],
        windows=spec["steps_per_flush"] // spec["inner_unroll"],
        unroll=spec["inner_unroll"], detect=True,
        sample_domain=spec["sample_domain"],
        window=(wx0, wx1, wy0, wy1, cw / (wx1 - wx0), ch / (wy1 - wy0)),
        restart256=spec["restart256"], rep_cap=spec["rep_cap"],
        canvas_wh=spec["canvas_wh"])
    for f, x, y in zip(state._fields, ra.state, rb.state):
        assert _same(x, y), f
    for f in ("emit_it", "emit_rep", "emit_v", "emit_bins", "stats"):
        assert _same(getattr(ra, f), getattr(rb, f)), f
    assert int((ra.emit_it >= 0).sum()) > 0


# -- the replay kernels' row window, and the multi-device engines -----------

WINDOWS = [None, (0, 200), (0, 100), (100, 100), (67, 67), (134, 67),
           (199, 1), (150, 80), (250, 10), (0, 0)]


def _window_batch(cuda, ext, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    k = 1 << 14
    if ext:
        xr = torch.randint(0, 1 << 24, (k,), generator=g, device=cuda).float()
        xi = torch.randint(0, 1 << 24, (k,), generator=g, device=cuda).float()
    else:
        xr = torch.rand(k, generator=g, device=cuda) * 3.0 - 2.0
        xi = torch.rand(k, generator=g, device=cuda) * 3.0 - 1.5
    it = torch.randint(-1, 200, (k,), generator=g, device=cuda,
                       dtype=torch.int32)
    return xr, xi, torch.sort(it, descending=True).values


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("rows", WINDOWS)
def test_replay_kernels_with_a_row_window_match_plain(cuda, ext, rows):
    """The four replay kernels binning into a row window (the row-sharded
    engine's shards, uneven and past the canvas too) equal their plain
    versions bitwise: the fused histogram, the id stream and the count; the
    window (0, height) equals the whole canvas's plain replay (the
    replicated output, rows=None)."""
    canvas = config.Canvas(width=300, height=200, min_real=-2.0,
                           max_real=1.0, min_imag=-1.2, max_imag=1.2)
    xr, xi, it = _window_batch(cuda, ext, 6)
    kw = dict(canvas=canvas, fractal=FRACTALS["buddhabrot"], rows=rows)
    if ext:
        kw["sample_domain"] = FAST
        fused, fused_p = (binning.replay_deposit_ext,
                          binning.replay_deposit_ext_plain)
        ids_fn, ids_p_fn = binning.replay_ids_ext, binning.replay_ids_ext_plain
    else:
        fused, fused_p = binning.replay_deposit, binning.replay_deposit_plain
        ids_fn, ids_p_fn = binning.replay_ids, binning.replay_ids_plain
    cells = (canvas.height if rows is None else rows[1]) * canvas.width
    hk = torch.zeros(cells, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    launches.reset()
    hits_k = fused(hk, xr, xi, it, **kw)
    hits_p = fused_p(hp, xr, xi, it, **kw)
    assert torch.equal(hk, hp)
    assert int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum())
    off, n = _offsets(it)
    ids_k, ids_hits = ids_fn(xr, xi, it, off, n, **kw)
    ids_p, _ = ids_p_fn(xr, xi, it, off, n, **kw)
    assert torch.equal(ids_k, ids_p)
    assert int(ids_hits) == int(hits_p) == int((ids_k < cells).sum())
    counts = launches.snapshot()
    name = "replay_deposit_ext" if ext else "replay_deposit"
    assert counts[name] == 1 and counts[name.replace("deposit", "ids")] == 1
    if rows == (0, canvas.height):
        whole = torch.zeros_like(hk)
        fused_p(whole, xr, xi, it, **{**kw, "rows": None})
        assert torch.equal(hk, whole)


@pytest.mark.parametrize("extended", [False, True])
def test_row_shards_equal_the_replicas_on_the_card(cuda, extended):
    """On cuda:0: the data-parallel engine over two replicas equals two
    single engines at ordinals 0 and 1 summed, and three row shards equal
    three replicas, histogram and stats bitwise (chip_smoke.py phase 10 at
    a small geometry)."""
    import numpy as np

    from cudabrot_tpu_torch.parallel.data_parallel import (
        DataParallelEngine,
        sum_stats,
    )
    from cudabrot_tpu_torch.parallel.sharded_hist import (
        ShardedHistogramEngine,
    )

    opts = dict(lane_rows=16, steps_per_pass=256, steps_per_flush=32,
                replay_capacity=1 << 14)
    cfg = config.RenderConfig(
        canvas=config.Canvas(width=200, height=100),
        band=config.IterationBand(max_escape_iterations=200,
                                  min_escape_iterations=5),
        options=config.EngineOptions(**opts))
    if extended:
        cfg = cfg.replace(sample_domain=FAST, options=config.EngineOptions(
            precision="extended", **opts))

    def run(eng, passes=3):
        state = eng.init_state(None)
        for p in range(passes):
            eng.run_pass(state, p)
        return eng.histogram(state), eng.stats(state)

    h2, s2 = run(DataParallelEngine(cfg, devices=[cuda, cuda]))
    singles, stats = np.zeros(h2.shape, np.uint32), []
    for ordinal in (0, 1):
        eng = CudaEngine(cfg, device=cuda)
        state = eng.init_state(None)
        for p in range(3):
            eng.core(state, p, ordinal)
        singles += eng.histogram(state)
        stats.append(eng.stats(state))
    assert np.array_equal(h2, singles) and s2 == sum_stats(stats)
    hd, sd = run(DataParallelEngine(cfg, devices=[cuda] * 3))
    hr, sr = run(ShardedHistogramEngine(cfg, devices=[cuda] * 3))
    assert sr.pop("histogram_sharding") == "rows"
    assert np.array_equal(hr, hd) and sr == sd
    assert sd["on_canvas_points"] == int(hd.sum()) > 0


def test_row_shards_allocate_no_canvas_on_the_card(cuda):
    """Building four row shards of an 8000x8000 canvas (256 MB) on cuda:0
    raises the allocator's peak by the four shards and the engines' lane
    states, not by a whole canvas more: no shard's state passes through a
    canvas-sized histogram."""
    from cudabrot_tpu_torch.parallel.sharded_hist import (
        ShardedHistogramEngine,
    )

    cfg = config.RenderConfig(
        canvas=config.Canvas(width=8000, height=8000),
        options=config.EngineOptions(lane_rows=16, steps_per_pass=256,
                                     steps_per_flush=32,
                                     replay_capacity=1 << 14))
    eng = ShardedHistogramEngine(cfg, devices=[cuda] * 4)
    torch.cuda.synchronize(cuda)
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    state = eng.init_state(None)
    torch.cuda.synchronize(cuda)
    peak = torch.cuda.max_memory_allocated(cuda) - base
    canvas = cfg.canvas.num_pixels * 4
    assert [tuple(st["hist"].shape) for st in state] == [(2000, 8000)] * 4
    assert canvas <= peak < canvas + canvas // 8


# -- the host orbit replay --------------------------------------------------


def _host_render(device, **opts):
    """A small host-replay render: its histogram and stats without the
    worker's seconds."""
    kw = dict(lane_rows=16, steps_per_pass=256, steps_per_flush=32,
              replay_capacity=1 << 15)
    kw.update(opts)
    win = {}
    if kw.get("sampler") == "mh":
        kw.update(steps_per_pass=2048, steps_per_flush=256,
                  replay_capacity=0, mh_burnin_passes=1)
        win = dict(sample_domain=(-0.7676, -0.7196, 0.1079, 0.1559))
        canvas = config.Canvas(width=48, height=48, min_real=-0.7466,
                               max_real=-0.7406, min_imag=0.1289,
                               max_imag=0.1349)
        band = config.IterationBand(max_escape_iterations=500,
                                    min_escape_iterations=50)
    else:
        canvas = config.Canvas(width=64, height=48)
        band = config.IterationBand(max_escape_iterations=80,
                                    min_escape_iterations=4)
    cfg = config.RenderConfig(canvas=canvas, band=band,
                              options=config.EngineOptions(**kw), **win)
    eng = CudaEngine(cfg, device=device)
    state = eng.init_state(None)
    for p in range(4):
        eng.run_pass(state, p)
    stats = {k: v for k, v in eng.stats(state).items()
             if k not in ("replay_fetch_seconds", "replay_busy_seconds")}
    return eng.histogram(state), stats


@pytest.mark.parametrize("opts", [
    dict(replay="host", replay_device_share=0.0),
    dict(replay="host", replay_device_share=0.5),
    dict(sampler="mh", hist_dtype="uint64"),
])
def test_host_render_on_the_card_equals_the_cpu(cuda, opts):
    """A host-mode render on cuda:0 equals the same render on the CPU
    bitwise: the classify streams are bitwise equal, the payload crosses
    through the pinned ring, and both replays run the same strict native
    code (the hybrid's device share through replay_deposit, MH's deposit
    in numpy)."""
    launches.reset()
    h_gpu, s_gpu = _host_render(cuda, **opts)
    counts = launches.snapshot()
    h_cpu, s_cpu = _host_render("cpu", **opts)
    assert h_gpu.dtype == h_cpu.dtype
    np.testing.assert_array_equal(h_gpu, h_cpu)
    assert s_gpu == s_cpu and s_gpu["on_canvas_points"] > 0
    assert s_gpu["replay"] == ("hybrid" if opts.get("replay_device_share")
                               else "host")
    kernel = "classify_mh" if "sampler" in opts else "classify"
    assert counts[kernel] == 4 and counts[f"{kernel}_plain"] == 0
    if s_gpu["replay"] == "hybrid":
        assert counts["replay_deposit"] == 4


def test_df32_passes_on_card_equal_the_benchmark_reference(cuda):
    """At a tiny deep zoom (the benchmark cell zoom1e5.df32's window at
    64x48, 512 lanes, band [500, 2000)) passes 0 and 2 of a traced render
    on the card equal h100bench's plain df32 reference bit for bit (lanes,
    histogram change, counters), and the render's cb.classify and
    cb.deposit spans record device time around the df32 kernels."""
    import sys
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    bench = Path(__file__).resolve().parents[1] / "h100bench"
    if str(bench) not in sys.path:
        sys.path.append(str(bench))
    from hb import check
    from reference import extended_df32 as ref

    cfg, _ = cli.parse_args([
        "-w", "64", "-h", "48", "-m", "2000", "-c", "500",
        "--precision", "extended",
        "--center", "-0.743643887037151,0.131825904205330", "--span", "1e-5",
        "--lane-rows", "4", "--steps-per-pass", "512",
        "--steps-per-flush", "128", "--inner-unroll", "4",
        "--replay-capacity", "4096", "--seed", str(2 ** 33 + 7),
        "--passes", "3", "-t", "-1"])
    eng = CudaEngine(cfg, device=cuda)
    capture = check.PassCapture(eng, (0, 2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = driver.run_render(cfg, engine=eng, log=lambda msg: None)
    capture.to_host()
    cv = cfg.canvas
    scene = ref.Scene(width=cv.width, height=cv.height,
                      min_real=cv.min_real, max_real=cv.max_real,
                      min_imag=cv.min_imag, max_imag=cv.max_imag,
                      min_it=500, max_it=2000)
    got = check.run_checks(ref, capture, cfg.seed, ref.plan_of(eng), scene,
                           cuda)
    assert len(capture.taken) == 2
    assert {k: v["value"] for k, v in got.items()} == dict.fromkeys(got, 0)
    assert capture.taken[(2, 0)]["counters"]["dev_hits"] > 0
    spans = result.stats["trace"]["spans"]
    assert spans["cb.classify"]["device_ms"] > 0
    assert spans["cb.deposit"]["device_ms"] > 0
    kernels = {e.key for e in prof.key_averages()}
    assert any("classify_ext_kernel" in k for k in kernels)
    assert any("replay_deposit_ext" in k for k in kernels)


def test_mh_df32_passes_on_card_equal_the_benchmark_reference(cuda):
    """At a tiny MH zoom (the benchmark cell mhzoom1e5.mh's window at 64x64
    and its 8x sample domain, 512 lanes, band [500, 2000)) passes 0 (the
    burn-in) and 2 of a traced render on the card equal h100bench's plain
    MH df32 reference bit for bit (lanes, histogram change, counters), and
    the render's cb.classify and cb.deposit spans record device time
    around the MH kernels."""
    import sys
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    bench = Path(__file__).resolve().parents[1] / "h100bench"
    if str(bench) not in sys.path:
        sys.path.append(str(bench))
    from hb import check
    from reference import mh_df32 as ref

    cfg, _ = cli.parse_args([
        "-w", "64", "-h", "64", "-m", "2000", "-c", "500",
        "--precision", "extended", "--sampler", "mh",
        "--center", "-0.743643887037151,0.131825904205330", "--span", "1e-5",
        "--lane-rows", "4", "--steps-per-pass", "2048",
        "--steps-per-flush", "512", "--inner-unroll", "16",
        "--seed", str(2 ** 33 + 7), "--passes", "3", "-t", "-1"])
    eng = CudaEngine(cfg, device=cuda)
    capture = check.PassCapture(eng, (0, 2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = driver.run_render(cfg, engine=eng, log=lambda msg: None)
    capture.to_host()
    cv = cfg.canvas
    scene = ref.Scene(width=cv.width, height=cv.height,
                      min_real=cv.min_real, max_real=cv.max_real,
                      min_imag=cv.min_imag, max_imag=cv.max_imag,
                      min_it=500, max_it=2000)
    got = check.run_checks(ref, capture, cfg.seed, ref.plan_of(eng), scene,
                           cuda)
    assert len(capture.taken) == 2
    assert {k: v["value"] for k, v in got.items()} == dict.fromkeys(got, 0)
    assert capture.taken[(2, 0)]["counters"]["points"] > 0
    trace = result.stats["trace"]
    assert (trace["mh_passes"], trace["mh_burnin_passes"]) == (3, 1)
    assert trace["spans"]["cb.classify"]["device_ms"] > 0
    assert trace["spans"]["cb.deposit"]["device_ms"] > 0
    assert trace["spans"]["cb.mh_tail"]["count"] == 1
    kernels = {e.key for e in prof.key_averages()}
    assert any("classify_ext_mh_kernel" in k for k in kernels)
    assert any("mh_deposit_kernel" in k for k in kernels)


#: The length sort's cells: canvas1k.default's plan, hires15k.coarse's
#: band (its plan does not depend on the canvas) and zoom1e5.df32's.
SORT_CELLS = {
    "default": ["-w", "1000", "-h", "1000"],
    "coarse": ["-w", "1000", "-h", "1000", "-m", "500", "-c", "20"],
    "zoom": ["-w", "1600", "-h", "1200", *ZOOM]}


def _cell_emissions(argv, passes=4):
    """A classify pass's emission buffers at a cell's plan, from lanes
    carried ``passes`` passes, and the engine."""
    eng = CudaEngine(_cell(argv), device="cuda")
    state = eng.init_state(None)
    for p in range(passes):
        eng.run_pass(state, p)
    return eng.classify(state, passes), eng


@pytest.mark.parametrize("cell", sorted(SORT_CELLS))
def test_length_sort_kernel_matches_plain_at_the_cells(cuda, cell):
    """The length sort's kernels against the plain version, bitwise, on a
    pass's emission buffers at canvas1k.default's, hires15k.coarse's and
    zoom1e5.df32's slot counts and bands (8,388,608 slots in 80 and 480
    buckets, 2,097,152 in 19,500), and the plan's route is the length
    sort's."""
    from cudabrot_tpu_torch.ops import length_sort as ls

    res, eng = _cell_emissions(SORT_CELLS[cell])
    tn = eng.tuning
    assert eng.compact_route == "length"
    launches.reset()
    got = ls.length_sort(res.emit_c, res.emit_it, tn.min_it, tn.max_it)
    assert launches.COUNTS["length_sort"] == 1
    want = ls.length_sort_plain(res.emit_c, res.emit_it, tn.min_it,
                                tn.max_it)
    for a, b in zip(got, want):
        assert a.shape == b.shape and _same(a, b)
    assert 0 < int(got[3]) < res.emit_it.numel()


@pytest.mark.parametrize("lb", [5, 9, 13, 14])
@pytest.mark.parametrize("share", [0.0, 0.07, 0.5, 1.0])
def test_length_sort_kernel_tiles_match_plain(cuda, lb, share):
    """Any tile size, on random buffers of 3 windows of 2,304 lanes with a
    ragged last tile, every slot valid or none, the default band and the
    zoom's."""
    from cudabrot_tpu_torch.ops import length_sort as ls

    gen = torch.Generator(device=cuda).manual_seed(lb)
    for lo, hi in ((20, 100), (500, 20000)):
        it = torch.randint(lo, hi, (3, 18, 128), generator=gen, device=cuda,
                           dtype=torch.int32)
        it[torch.rand(it.shape, generator=gen, device=cuda) >= share] = -1
        c = torch.randint(-2**31, 2**31, (3, 2, 18, 128), generator=gen,
                          device=cuda, dtype=torch.int64).to(torch.int32)
        c = c.view(torch.float32)
        got = ls.launch(c, it, lo, hi, lb)
        want = ls.length_sort_plain(c, it, lo, hi)
        for a, b in zip(got, want):
            assert _same(a, b)


@pytest.mark.parametrize("cell", ["default", "zoom"])
def test_length_sort_route_renders_as_the_selection(cuda, monkeypatch, cell):
    """16 engine passes at a cell's plan through the length sort, and
    through the JAX selection (``compact_route`` patched to "select"):
    the histogram, the lanes and every counter bit for bit."""
    from cudabrot_tpu_torch.engines import cuda_engine as ce

    cfg = _cell(SORT_CELLS[cell])
    runs = {}
    for route in ("length", "select"):
        if route == "select":
            monkeypatch.setattr(ce, "compact_route", lambda tn: "select")
        eng = CudaEngine(cfg, device=cuda)
        assert eng.compact_route == route
        launches.reset()
        state = eng.init_state(None)
        for p in range(16):
            eng.run_pass(state, p)
        ran = launches.snapshot()
        assert ran["length_sort"] == (16 if route == "length" else 0)
        assert ran["threefry_bits"] == (16 if route == "select" else 0)
        runs[route] = (eng.histogram(state), eng.stats(state), state["lanes"])
    (hl, sl, ll), (hs, ss, lsel) = runs["length"], runs["select"]
    np.testing.assert_array_equal(hl, hs)
    assert int(hl.sum(dtype=np.uint64)) == sl["on_canvas_points"] > 0
    assert sl == ss
    for x, y in zip(ll, lsel):
        assert _same(x, y)


#: (lanes, batch slots, kept, layout, capacity, offset of the views, large
#: values): valid-first batches as each compaction route leaves them, the
#: hybrid split's holes inside the kept prefix, emissions past the
#: capacity, no batch, an empty one, unaligned views and totals past 2^32.
COUNTER_CASES = {
    "length": (262144, 1 << 20, 400_000, "first", 1 << 20, 0, False),
    "select": (262144, 1 << 16, 1 << 16, "first", 1 << 16, 0, False),
    "holes": (262144, 1 << 20, 400_000, "holes", 1 << 20, 0, False),
    "over-capacity": (4096, 8192, 8192, "first", 8192, 0, False),
    "no-batch": (262144, 0, 5000, None, 1 << 20, 0, False),
    "empty": (262144, 0, 0, "first", 1 << 20, 0, False),
    "unaligned": (262143, 100_003, 50_001, "first", 1 << 20, 3, False),
    "past-2^32": (262144, 1 << 20, 400_000, "first", 1 << 20, 1, True),
}


@pytest.mark.parametrize("case", sorted(COUNTER_CASES))
def test_pass_counters_kernel_matches_plain(cuda, case):
    """The counters' kernel against the plain version, bitwise, on random
    stat rows and batches, in one launch, and against the expression the
    engine ran before the kernel, which reads the whole batch."""
    from cudabrot_tpu_torch.ops import pass_counters as pc
    from cudabrot_tpu_torch.utils import counters
    from tests.test_torch_pass_counters import _old_expression

    lanes, n, kept, layout, capacity, off, large = COUNTER_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    high = (1 << 31) - 1 if large else 1 << 16
    flat = torch.randint(0, high, (cls.STATS_ROWS * lanes + off,),
                         generator=gen, device=cuda, dtype=torch.int32)
    stats = flat[off:].view(cls.STATS_ROWS, lanes)
    iters = None
    if layout is not None:
        it = torch.full((n + off,), -1, dtype=torch.int32, device=cuda)
        lo = (1 << 31) - 70_000 if large else 20
        it[off:off + min(kept, n)] = torch.randint(
            lo, lo + 60_000, (min(kept, n),), generator=gen, device=cuda,
            dtype=torch.int32)
        if layout == "holes":
            holes = torch.rand((n + off,), generator=gen, device=cuda) < 0.3
            it[holes] = -1
            assert (it[off + min(kept, n):] == -1).all()
        iters = it[off:]
    n_valid = torch.tensor(kept + (5000 if case == "over-capacity" else 0),
                           dtype=torch.int64, device=cuda)
    start = (1 << 34) if large else 0
    runs = []
    for fn in (pc.pass_counters, pc.pass_counters_plain):
        tot = {k: v + start for k, v in counters.zeros(cuda).items()}
        launches.reset()
        fn(stats, n_valid, iters, tot, steps_per_pass=4096 * lanes,
           capacity=capacity)
        runs.append({k: int(tot[k]) for k in pc.TOTALS})
        if fn is pc.pass_counters:
            assert launches.COUNTS["pass_counters"] == 1
            assert launches.COUNTS["pass_counters_plain"] == 0
    assert runs[0] == runs[1]
    old = {k: v + start for k, v in counters.zeros(cuda).items()}
    _old_expression(old, stats, n_valid, iters, 4096 * lanes, capacity)
    assert runs[0] == {k: int(old[k]) for k in pc.TOTALS}
    if large:
        assert runs[0]["samples"] - start > 1 << 32
        assert runs[0]["points"] - start > 1 << 32
    if case == "over-capacity":
        assert runs[0]["replay_dropped"] == 5000


def test_pass_counters_at_the_default_plan(cuda):
    """canvas1k.default's plan: an engine pass launches the counters'
    kernel once and no plain version, and a pass's counters through the
    kernel (the kept prefix of the length sort's batch) equal the
    expression the engine ran before the kernel over the whole batch, bit
    for bit."""
    from cudabrot_tpu_torch.ops import pass_counters as pc
    from tests.test_torch_pass_counters import _old_expression

    eng = CudaEngine(_cell(SORT_CELLS["default"]), device=cuda)
    state = eng.init_state(None)
    for p in range(2):
        eng.run_pass(state, p)
    launches.reset()
    eng.run_pass(state, 2)
    eng.synchronize()
    assert launches.COUNTS["pass_counters"] == 1
    assert launches.COUNTS["pass_counters_plain"] == 0
    batch, result, n_valid = eng.classify_and_compact(state, 3)
    assert 0 < int(n_valid) < batch[2].numel()
    got = {k: state[k].clone() for k in pc.TOTALS}
    want = {k: state[k].clone() for k in pc.TOTALS}
    pc.pass_counters(result.stats, n_valid, batch[2], got,
                     steps_per_pass=eng.steps_per_pass,
                     capacity=eng.replay_capacity)
    _old_expression(want, result.stats, n_valid, batch[2],
                    eng.steps_per_pass, eng.replay_capacity)
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()}
