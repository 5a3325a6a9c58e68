"""The benchmark's plain Metropolis-Hastings float32 reference against the
port's MH crop.

``h100bench/reference/mh_f32.py`` decides ``correct`` in the benchmark's
cell ``mhcrop6e3.mh5000``: it redoes passes of the renderer's ``--sampler
mh`` path at float32 in plain PyTorch, sharing no code with the port.
Here, on the CPU at a tiny crop (32x32 over the cell's 6e-3 window, the
8x sample domain of the CLI's shorthand, band [500, 2000), 512 lanes,
short passes and flush windows), and at a crop of band [50, 500) whose
tenures reach a short rep cap and merge in their pending slots, the
port's passes through ``make_engine``/``run_pass`` equal the reference
bit for bit (lanes, histogram change, counters) on the burn-in pass and a
later pass, at RNG ordinals 0 and 1; bfloat16 in float32's place fails
the same comparison; the reference refuses the engines it does not model;
and its deposit conserves each tenure's mass. The cell's files, its
reader and its costs are checked too. The harness (``h100bench/hb``) and
the reference are imported from ``h100bench`` on ``sys.path``.
"""

import json
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1] / "h100bench"
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

from hb import cells, check  # noqa: E402
from reference import mh_f32 as ref  # noqa: E402
from reference import threefry  # noqa: E402

from cudabrot_tpu_torch import engines  # noqa: E402
from cudabrot_tpu_torch.cli import parse_args  # noqa: E402
from cudabrot_tpu_torch.engines.cuda_engine import Tuning  # noqa: E402

SEED = 2 ** 33 + 7
CELL = "mhcrop6e3.mh5000"
CENTER, SPAN = "-0.7436,0.1319", "6e-3"
#: The tiny crop: the cell's window at 32x32, the CLI's 8x MH domain.
CROP = ["-w", "32", "-h", "32", "-m", "2000", "-c", "500",
        "--center", CENTER, "--span", SPAN, "--steps-per-pass", "2048",
        "--steps-per-flush", "512", "--inner-unroll", "16"]
#: The same window at a shorter band, whose chains visit often: tenures
#: reach the rep cap and merge in their pending slots.
MERGE = ["-w", "32", "-h", "32", "-m", "500", "-c", "50",
         "--center", CENTER, "--span", SPAN, "--steps-per-pass", "1024",
         "--steps-per-flush", "256", "--inner-unroll", "8",
         "--mh-rep-cap", "8"]
COMMON = ["--sampler", "mh", "--lane-rows", "4", "--mh-burnin", "1",
          "--seed", str(SEED), "-t", "-1"]
CHECKED = (0, 2)


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


@pytest.fixture(scope="module", params=["crop", "merge"])
def render(request):
    """Three passes over two CPU devices (RNG ordinals 0 and 1), passes 0
    (the burn-in) and 2 of each kept by the harness's capture."""
    geometry = CROP if request.param == "crop" else MERGE
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
    _, plan, scene, capture, _ = render
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


def test_the_merge_crop_reaches_the_cap_and_merges(render):
    setup, _, _, _, stats = render
    if setup == "merge":
        assert stats["mh_merges"] > 0 and stats["mh_merged_rep"] > 0
    assert stats["mh_accepts"] > 0
    assert stats["on_canvas_points"] == stats["mh_deposited"] > 0


def test_ordinals_draw_their_own_streams(render):
    capture = render[3]
    a, b = (capture.taken[(2, o)]["after"] for o in (0, 1))
    assert check.lanes_differ(a, b) > 0


@pytest.mark.parametrize("pass_index", [0, 1])
@pytest.mark.parametrize("seed", [SEED, 3_000_000_019])
def test_bfloat16_in_place_of_float32_fails_the_check(seed, pass_index):
    cfg, eng = _engine(CROP)
    plan, scene = ref.plan_of(eng), _scene(cfg)
    got = check.control_checks(ref, seed, pass_index, plan, scene, "cpu")
    assert got["lanes"] > check.LIMIT
    same = check.control_checks(ref, seed, pass_index, plan, scene, "cpu",
                                dtype=torch.float32)
    assert same == {"bins": 0, "counters": 0, "lanes": 0}


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_are_refused(dtype):
    with pytest.raises(ValueError, match="float32"):
        ref.init_lanes(4, "cpu", dtype)


def _host_mode(eng):
    eng.replay_mode = "host"
    return eng


@pytest.mark.parametrize("what,extra,patch", [
    ("df32 orbits", ["--precision", "extended"], None),
    ("uniform sampler", ["--sampler", "uniform"], None),
    ("host replay", [], _host_mode),
    ("maps other than the Buddhabrot", ["--fractal", "burning-ship"], None),
    ("4 visit slots", ["--mh-visit-slots", "4"], None),
])
def test_plan_of_refuses_what_it_does_not_model(what, extra, patch):
    _, eng = _engine(CROP, *extra)
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
    _, one = _engine(CROP)
    _, two = _engine(CROP, "--devices", "2")
    assert ref.plan_of(two) == ref.plan_of(one)
    plan = ref.plan_of(one)
    assert (plan.lanes, plan.unroll, plan.burnin) == (512, 16, 1)
    assert (plan.restart256, plan.rep_cap) == (16, 4096)


@pytest.mark.parametrize("ordinal", [0, 1])
def test_deposit_conserves_each_tenures_mass(ordinal):
    """The emissions of a chain pass of the merge crop: each tenure's
    shares sum to its mass q = floor(v * rep * 65536 / t), over its
    min(v, 8) recorded bins, and the histogram change holds them all."""
    cfg, eng = _engine(MERGE)
    plan, scene = ref.plan_of(eng), _scene(cfg)
    lanes, _, _ = ref.run_pass(ref.init_lanes(plan.lanes, "cpu"), SEED, 0,
                               plan, scene, ordinal=ordinal)
    k0, k1 = threefry.bits_host(threefry.pass_key(SEED, ordinal, 1), 2)
    _, emit, _ = ref.chains(lanes, k0, k1, plan, scene)
    live = emit["it"] >= 0
    assert int(live.sum()) > 0
    t = torch.where(live, emit["v"], 0)
    d, n, q = ref.shares(t, emit["rep"])
    assert torch.equal(d.sum(0), q)
    assert bool((d >= 0).all()) and int(q.sum()) > 0
    k = torch.arange(ref.VISIT_SLOTS).view(-1, 1, 1)
    assert bool((d[k >= n[None]] == 0).all())
    ok = t > 1
    tt = torch.where(ok, t, 1).to(torch.int64)
    assert torch.equal(q[ok], ((tt - 1) // 256 * emit["rep"] * 65536
                               // tt)[ok])
    hist, points = ref.deposit(emit, scene)
    assert int(hist.sum()) == int(q.sum()) and points == int(n.sum())


def test_the_cell_is_the_readmes_mh_example():
    cell = cells.load_cell(CELL)
    assert cell.chips == 1
    cfg, _ = parse_args(cell.argv(SEED, 20))
    shorthand, _ = parse_args(["-w", "1000", "-h", "1000", "-m", "5000",
                               "-c", "500", "--sampler", "mh",
                               "--center", CENTER, "--span", SPAN])
    assert cfg.canvas == shorthand.canvas
    assert cfg.sample_domain == shorthand.sample_domain
    assert cfg.band == shorthand.band
    cv = cfg.canvas
    assert (cv.width, cv.height) == (1000, 1000)
    assert cv.max_real - cv.min_real == pytest.approx(6e-3, rel=1e-9)
    assert cv.max_imag - cv.min_imag == pytest.approx(6e-3, rel=1e-9)
    r0, r1, i0, i1 = cfg.sample_domain
    assert r1 - r0 == pytest.approx(4.8e-2, rel=1e-9)
    assert i1 - i0 == pytest.approx(4.8e-2, rel=1e-9)
    o = cfg.options
    assert (o.precision, o.sampler) == ("float32", "mh")
    assert (o.mh_burnin_passes, o.mh_restart, o.mh_rep_cap,
            o.mh_visit_slots) == (1, 16, 4096, 8)
    assert (o.num_devices, o.hist_dtype) == (1, "uint32")
    tn = Tuning(cfg)
    assert (tn.lanes, tn.steps_per_pass, tn.steps_per_flush,
            tn.inner_unroll) == (262144, 16384, 16384, 32)
    assert tn.emission_slots == tn.replay_capacity == 262144
    assert cells.reference(cell.config) is ref
    scene = ref.Scene.from_cell(cell.config["canvas"], cell.traffic["band"])
    assert (scene.min_it, scene.max_it) == (500, 5000)
    assert scene.pixels == 10 ** 6
    assert cell.config["reduced"] == ["seconds"]


def test_the_new_reader_reads_the_crop_cell_only():
    for w in cells.load_benchmark()["workloads"]:
        names = {m["name"] for m in cells.load_cell(w["name"]).per_layer}
        assert ("classify_mh_roofline" in names) == (w["name"] == CELL)
    names = {m["name"] for m in cells.load_cell(CELL).per_layer}
    # The df32 MH cell's readers are not listed for the crop.
    assert not names & {"classify_ext_mh_roofline", "mh_deposit_roofline",
                        "mh.iters_per_mass", "compact.span_ms"}


def _m(op_s, layer_s, trace=None, **stats):
    costs = json.loads((BENCH_DIR / "costs.json").read_text())
    reduced = types.SimpleNamespace(op_s=op_s, layer_s=layer_s)
    if trace is not None:
        stats["trace"] = trace
    return types.SimpleNamespace(
        trace=reduced, costs=costs, stats=stats, passes=2, replicas=1,
        geometry={"lanes": 128, "pixels": 100, "emission_slots": 256})


def test_classify_mh_roofline_reader():
    c = json.loads((BENCH_DIR / "costs_mh_f32.json").read_text())
    assert (c["chain_step"]["ops"], c["proposal"]["ops"]) == (19, 252)
    assert (c["lane_bytes"], c["slot_bytes"]) == ((18 + 2 * 8) * 8 + 32, 44)
    read = cells.reader("classify_mh_roofline")
    kernels = {"ns::classify_mh_kernel_0__8__32__": 1.0,
               "ns::mh_deposit_kernel": 1.0}
    layers = {"classify": 2.0, "deposit": 1e-6}
    traced = {"mh_passes": 2, "mh_f32_passes": 2}
    # 67e12 / 19 useful steps and no proposal in 2 s: half the peak.
    m = _m(kernels, layers, traced,
           classify_iters=67e12 / c["chain_step"]["ops"], samples=0)
    assert read(m) == pytest.approx(50.0)
    m.stats.update(samples=1e9)
    assert read(m) == pytest.approx(
        50.0 + 100.0 * 1e9 * c["proposal"]["ops"] / 67e12 / 2.0)
    # Lane and slot bytes bound a pass that hardly steps.
    m.stats.update(classify_iters=0, samples=0)
    assert read(m) == pytest.approx(
        100.0 * 2 * (128 * 304 + 256 * 44) / 3.35e12 / 2.0)
    # No float32 MH kernel, no float32 MH pass traced, no trace: None.
    df32 = _m({"ns::classify_ext_mh_kernel_0__8__16__": 1.0}, layers,
              {"mh_passes": 2, "mh_f32_passes": 0}, classify_iters=1,
              samples=1)
    assert read(df32) is None
    for trace in ({"mh_passes": 2, "mh_f32_passes": 0}, {"mh_passes": 2},
                  None):
        assert read(_m(kernels, layers, trace, classify_iters=1,
                       samples=1)) is None
    m.trace = None
    assert read(m) is None
