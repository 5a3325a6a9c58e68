"""The benchmark's plain Metropolis-Hastings df32 reference against the
port's MH deep zoom.

``h100bench/reference/mh_df32.py`` decides ``correct`` in the benchmark's
cell ``mhzoom1e5.mh``: it redoes passes of the renderer's ``--sampler mh
--precision extended`` path in plain PyTorch, sharing no code with the
port. Here, on the CPU at a tiny MH zoom (64x64 over the cell's 1e-5
window, the 8x sample domain of the CLI's shorthand, band [500, 2000),
512 lanes, short passes and flush windows), and at a small crop where
tenures reach a short rep cap and merge in their pending slots, the
port's passes through ``make_engine``/``run_pass`` equal the reference
bit for bit (lanes, histogram change, counters) on the burn-in pass and a
later pass, at RNG ordinals 0 and 1; float32 orbits in df32's place fail
the same comparison; the reference refuses the engines it does not model;
and its deposit conserves each tenure's mass. The cell's files, the
three MH readers and their costs are checked too. The harness
(``h100bench/hb``) and the reference are imported from ``h100bench`` on
``sys.path``.
"""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1] / "h100bench"
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

from hb import cells, check  # noqa: E402
from reference import mh_df32 as ref  # noqa: E402

from cudabrot_tpu_torch import engines  # noqa: E402
from cudabrot_tpu_torch.cli import parse_args  # noqa: E402
from cudabrot_tpu_torch.engines.cuda_engine import Tuning  # noqa: E402

SEED = 2 ** 33 + 7
CENTER = "-0.743643887037151,0.131825904205330"
#: The tiny zoom: the cell's window at 64x64, the CLI's 8x MH domain.
ZOOM = ["-w", "64", "-h", "64", "-m", "2000", "-c", "500",
        "--center", CENTER, "--span", "1e-5", "--steps-per-pass", "2048",
        "--steps-per-flush", "512", "--inner-unroll", "16"]
#: A small crop whose chains visit often: tenures reach the rep cap and
#: merge in their pending slots.
CROP = ["-w", "32", "-h", "32", "-m", "500", "-c", "50",
        "--center", "-0.7436,0.1319", "--span", "6e-3",
        "--steps-per-pass", "1024", "--steps-per-flush", "256",
        "--inner-unroll", "8", "--mh-rep-cap", "8"]
COMMON = ["--precision", "extended", "--sampler", "mh", "--lane-rows", "4",
          "--mh-burnin", "1", "--seed", str(SEED), "-t", "-1"]
CHECKED = (0, 2)
MH_METRICS = {"classify_ext_mh_roofline", "mh_deposit_roofline",
              "mh.iters_per_mass"}


def _engine(geometry, *extra):
    cfg, _ = parse_args([*geometry, *COMMON, *extra])
    return cfg, engines.make_engine(cfg, device="cpu")


def _scene(cfg):
    cv, band = cfg.canvas, cfg.band
    return ref.Scene(width=cv.width, height=cv.height,
                     min_real=cv.min_real, max_real=cv.max_real,
                     min_imag=cv.min_imag, max_imag=cv.max_imag,
                     min_it=band.min_escape_iterations,
                     max_it=band.max_escape_iterations)


@pytest.fixture(scope="module", params=["zoom", "crop"])
def render(request):
    """Three passes over two CPU devices (RNG ordinals 0 and 1), passes 0
    (the burn-in) and 2 of each kept by the harness's capture."""
    geometry = ZOOM if request.param == "zoom" else CROP
    cfg, eng = _engine(geometry, "--devices", "2")
    capture = check.PassCapture(eng, CHECKED)
    state = eng.init_state(None)
    for p in range(3):
        state = eng.run_pass(state, p)
    capture.to_host()
    stats = eng.stats(state)
    return request.param, ref.plan_of(eng), _scene(cfg), capture, stats


@pytest.mark.parametrize("pass_index", CHECKED)
@pytest.mark.parametrize("ordinal", [0, 1])
def test_program_pass_equals_the_reference_bitwise(render, pass_index,
                                                   ordinal):
    setup, plan, scene, capture, _ = render
    taken = capture.taken[(pass_index, ordinal)]
    if pass_index == 0:
        lanes = ref.init_lanes(plan.lanes, "cpu")
        assert check.lanes_differ(taken["before"], lanes) == 0
    else:
        lanes = taken["before"]
    expected = ref.run_pass(lanes, SEED, pass_index, plan, scene,
                            ordinal=ordinal)
    got = check.compare((taken["after"], taken["hist"], taken["counters"]),
                        expected)
    assert got == {"bins": 0, "counters": 0, "lanes": 0}
    counters = taken["counters"]
    if pass_index == 0:
        # The burn-in pass deposits nothing and zeroes every tenure.
        assert int(expected[1].abs().sum()) == 0 == counters["points"]
        assert int(expected[0]["rep"].abs().sum()) == 0
    else:
        assert counters["emitted"] > 0
        assert int(expected[1].sum()) > 0 and counters["points"] > 0
    assert counters["replay_dropped"] == counters["dev_hits"] == 0


def test_the_crop_reaches_the_cap_and_merges(render):
    setup, _, _, _, stats = render
    if setup == "crop":
        assert stats["mh_merges"] > 0 and stats["mh_merged_rep"] > 0
    assert stats["mh_accepts"] > 0
    assert stats["on_canvas_points"] == stats["mh_deposited"] > 0


def test_ordinals_draw_their_own_streams(render):
    capture = render[3]
    a, b = (capture.taken[(2, o)]["after"] for o in (0, 1))
    assert check.lanes_differ(a, b) > 0


@pytest.mark.parametrize("pass_index", [0, 1])
@pytest.mark.parametrize("seed", [SEED, 3_000_000_019])
def test_float32_in_place_of_df32_fails_the_check(seed, pass_index):
    cfg, eng = _engine(ZOOM)
    plan, scene = ref.plan_of(eng), _scene(cfg)
    got = check.control_checks(ref, seed, pass_index, plan, scene, "cpu",
                               dtype=torch.float32)
    assert got["lanes"] > check.LIMIT
    same = check.control_checks(ref, seed, pass_index, plan, scene, "cpu",
                                dtype=ref.DF32)
    assert same == {"bins": 0, "counters": 0, "lanes": 0}


def test_other_dtypes_are_refused():
    with pytest.raises(ValueError, match="df32"):
        ref.init_lanes(4, "cpu", torch.bfloat16)


def _host_mode(eng):
    eng.replay_mode = "host"
    return eng


@pytest.mark.parametrize("what,extra,patch", [
    ("float32 orbits", ["--precision", "float32"], None),
    ("uniform sampler", ["--sampler", "uniform"], None),
    ("host replay", [], _host_mode),
    ("maps other than the Buddhabrot", ["--fractal", "burning-ship"], None),
    ("4 visit slots", ["--mh-visit-slots", "4"], None),
])
def test_plan_of_refuses_what_it_does_not_model(what, extra, patch):
    _, eng = _engine(ZOOM, *extra)
    if patch is not None:
        eng = patch(eng)
    with pytest.raises(ValueError, match=what):
        ref.plan_of(eng)


@pytest.mark.parametrize("name, what", [
    ("DataParallelHostReplayEngine", "host replay"),
    ("ShardedHistogramEngine", "row shards"),
])
def test_plan_of_refuses_engines_by_name(name, what):
    with pytest.raises(ValueError, match=what):
        ref.plan_of(type(name, (), {})())


def test_plan_of_reads_the_data_parallel_engines_first_replica():
    _, one = _engine(ZOOM)
    _, two = _engine(ZOOM, "--devices", "2")
    assert ref.plan_of(two) == ref.plan_of(one)
    plan = ref.plan_of(one)
    assert (plan.lanes, plan.unroll, plan.burnin) == (512, 16, 1)
    assert (plan.restart256, plan.rep_cap) == (16, 4096)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_deposit_conserves_each_tenures_mass(seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, ref.VISIT_CAP + 1, 4000)
    t = torch.from_numpy(np.where(rng.random(4000) < 0.1,
                                  rng.integers(-2, 2, 4000),
                                  v * ref.TARGET_VISIT + 1)).to(torch.int32)
    rep = torch.from_numpy(rng.integers(0, 1 << 17, 4000)).to(torch.int32)
    d, n, q = ref.shares(t, rep)
    ok = t > 1
    assert torch.equal(d.sum(0), q)
    assert bool((d >= 0).all())
    k = torch.arange(ref.VISIT_SLOTS)[:, None]
    assert bool((d[k >= n[None]] == 0).all())
    assert bool((n[~ok] == 0).all()) and bool((q[~ok] == 0).all())
    for i in range(0, 4000, 97):
        ti, ri = int(t[i]), int(rep[i])
        if ti > 1:
            vi = (ti - 1) // 256
            assert int(q[i]) == vi * ri * 65536 // ti
            assert int(n[i]) == min(max(vi, 1), ref.VISIT_SLOTS)
            # The shares differ by at most one.
            shares = d[:int(n[i]), i]
            assert int(shares.max() - shares.min()) <= 1


def test_deposit_adds_each_share_to_its_bin():
    scene = ref.Scene(width=4, height=2, min_real=0.0, max_real=1.0,
                      min_imag=0.0, max_imag=1.0, min_it=1, max_it=2)
    v = ref.VISIT_SLOTS
    bins = torch.zeros((1, v, 3), dtype=torch.int32)
    bins[0, :, 0] = torch.tensor([7, 7, 1, 2, 3, 4, 5, 6])
    bins[0, :3, 1] = torch.tensor([0, 0, 0])
    emit = {"it": torch.tensor([[600, 700, -1]], dtype=torch.int32),
            "v": torch.tensor([[10 * 256 + 1, 3 * 256 + 1, 9 * 256 + 1]],
                              dtype=torch.int32),
            "rep": torch.tensor([[5, 2, 9]], dtype=torch.int32),
            "bins": bins}
    hist, points = ref.deposit(emit, scene)
    q0 = 10 * 5 * 65536 // (10 * 256 + 1)
    q1 = 3 * 2 * 65536 // (3 * 256 + 1)
    assert points == v + 3
    assert int(hist.sum()) == q0 + q1
    assert int(hist[0]) == q1
    assert int(hist[7]) == q0 * 2 // 8
    assert int(hist[1]) == q0 * 3 // 8 - q0 * 2 // 8


def test_the_cell_is_bench_pys_mh_zoom():
    cell = cells.load_cell("mhzoom1e5.mh")
    assert cell.chips == 1
    cfg, _ = parse_args(cell.argv(SEED, 20))
    shorthand, _ = parse_args(["-w", "1000", "-h", "1000", "-m", "20000",
                               "-c", "500", "--precision", "extended",
                               "--sampler", "mh", "--center", CENTER,
                               "--span", "1e-5"])
    assert cfg.canvas == shorthand.canvas
    assert cfg.sample_domain == shorthand.sample_domain
    assert cfg.band == shorthand.band
    cv = cfg.canvas
    assert (cv.width, cv.height) == (1000, 1000)
    assert cv.max_real - cv.min_real == pytest.approx(1e-5, rel=1e-9)
    assert cv.max_imag - cv.min_imag == pytest.approx(1e-5, rel=1e-9)
    r0, r1, i0, i1 = cfg.sample_domain
    assert r1 - r0 == pytest.approx(8e-5, rel=1e-9)
    assert i1 - i0 == pytest.approx(8e-5, rel=1e-9)
    o = cfg.options
    assert (o.precision, o.sampler) == ("extended", "mh")
    assert (o.mh_burnin_passes, o.mh_restart, o.mh_rep_cap,
            o.mh_visit_slots) == (1, 16, 4096, 8)
    assert (o.num_devices, o.hist_dtype) == (1, "uint32")
    tn = Tuning(cfg)
    assert (tn.lanes, tn.steps_per_pass, tn.steps_per_flush) == (
        262144, 16384, 16384)
    assert tn.emission_slots == tn.replay_capacity == 262144
    assert cells.reference(cell.config) is ref
    scene = ref.Scene.from_cell(cell.config["canvas"], cell.traffic["band"])
    assert (scene.min_it, scene.max_it) == (500, 20000)
    assert scene.pixels == 10 ** 6
    assert cell.config["reduced"] == ["seconds"]


def test_the_new_metrics_read_the_mh_cell_only():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        names = {m["name"] for m in cell.per_layer}
        assert (MH_METRICS <= names) == (w["name"] == "mhzoom1e5.mh")
        assert not (MH_METRICS & names) or w["name"] == "mhzoom1e5.mh"
        # An MH pass (of either precision) has no compaction, so no
        # cb.compact span to read.
        mh = cell.config.get("flags", {}).get("--sampler") == "mh"
        assert ("compact.span_ms" in names) == (not mh)


def _m(op_s, layer_s, **stats):
    costs = json.loads((BENCH_DIR / "costs.json").read_text())
    trace = types.SimpleNamespace(op_s=op_s, layer_s=layer_s)
    return types.SimpleNamespace(
        trace=trace, costs=costs, stats=stats, passes=2, replicas=1,
        geometry={"lanes": 128, "pixels": 100, "emission_slots": 256})


def test_mh_readers():
    mh = json.loads((BENCH_DIR / "costs_mh.json").read_text())
    classify = cells.reader("classify_ext_mh_roofline")
    deposit = cells.reader("mh_deposit_roofline")
    per_mass = cells.reader("mh.iters_per_mass")
    kernels = {"ns::classify_ext_mh_kernel": 1.0, "ns::mh_deposit_kernel": 1.0}
    layers = {"classify": 2.0, "deposit": 1e-6}
    # 67e12 / 83 useful steps and no proposal in 2 s: half the peak.
    m = _m(kernels, layers, classify_iters=67e12 / mh["chain_step"]["ops"],
           samples=0, emitted=1000, orbit_points=150, mh_deposited=1 << 20,
           weight_scale=256)
    assert classify(m) == pytest.approx(50.0)
    m.stats.update(samples=1e9)
    assert classify(m) == pytest.approx(
        50.0 + 100.0 * 1e9 * mh["proposal"]["ops"] / 67e12 / 2.0)
    # Bytes of 1000 emissions and 150 bins, at most 2 passes x 100 bins.
    assert deposit(m) == pytest.approx(
        100.0 * (1000 * 44 + 150 * 8) / 3.35e12 / 1e-6)
    m.stats.update(orbit_points=10 ** 6)
    assert deposit(m) == pytest.approx(
        100.0 * (1000 * 44 + 200 * 8) / 3.35e12 / 1e-6)
    assert per_mass(m) == pytest.approx(m.stats["classify_iters"] * 256
                                        / (1 << 20))
    # Lane and slot bytes bound a pass that hardly steps.
    m.stats.update(classify_iters=0, samples=0)
    assert classify(m) == pytest.approx(
        100.0 * 2 * (128 * 336 + 256 * 44) / 3.35e12 / 2.0)
    uniform = _m({"ns::classify_ext_kernel_0_4": 1.0,
                  "ns::replay_deposit_ext_kernel_0": 1.0},
                 layers, classify_iters=1, samples=1, emitted=1,
                 orbit_points=1, on_canvas_points=1)
    assert classify(uniform) is None and deposit(uniform) is None
    assert per_mass(uniform) is None
    m.trace = None
    assert classify(m) is None and deposit(m) is None
