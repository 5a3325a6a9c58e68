"""The benchmark's plain df32 reference against the port's deep zoom.

``h100bench/reference/extended_df32.py`` decides ``correct`` in the
benchmark's cell ``zoom1e5.df32``: it redoes passes of the renderer's
``--precision extended`` path in plain PyTorch, sharing no code with the
port. Here, on the CPU at a tiny deep zoom (64x48 over a 1e-5 window at
the seahorse-valley point, 512 lanes, band [500, 2000)), the port's
passes through ``make_engine``/``run_pass`` equal the reference bit for
bit (lanes, histogram change, counters) at RNG ordinals 0 and 1; float32
orbits in df32's place fail the same comparison; the reference refuses
the engines it does not model; and its two-sum and two-product are exact.
The harness (``h100bench/hb``) and the reference are imported from
``h100bench`` on ``sys.path``.
"""

import json
import sys
import types
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1] / "h100bench"
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

from hb import cells, check  # noqa: E402
from reference import extended_df32 as ref  # noqa: E402
from reference import uniform_f32  # noqa: E402

from cudabrot_tpu_torch import engines  # noqa: E402
from cudabrot_tpu_torch.cli import parse_args  # noqa: E402

SEED = 2 ** 33 + 7
CENTER = "-0.743643887037151,0.131825904205330"
#: The tiny zoom: the cell's window at 64x48, three passes of 512 steps.
TINY = ["-w", "64", "-h", "48", "-m", "2000", "-c", "500",
        "--precision", "extended", "--center", CENTER, "--span", "1e-5",
        "--lane-rows", "4", "--steps-per-pass", "512",
        "--steps-per-flush", "128", "--inner-unroll", "4",
        "--replay-capacity", "4096", "--seed", str(SEED), "-t", "-1"]
CHECKED = (0, 2)


def _engine(*extra):
    cfg, _ = parse_args([*TINY, *extra])
    return cfg, engines.make_engine(cfg, device="cpu")


def _scene(cfg):
    cv, band = cfg.canvas, cfg.band
    return ref.Scene(width=cv.width, height=cv.height,
                     min_real=cv.min_real, max_real=cv.max_real,
                     min_imag=cv.min_imag, max_imag=cv.max_imag,
                     min_it=band.min_escape_iterations,
                     max_it=band.max_escape_iterations)


@pytest.fixture(scope="module")
def render():
    """Three passes of the tiny zoom over two CPU devices (RNG ordinals 0
    and 1), passes 0 and 2 of each kept by the harness's capture."""
    cfg, eng = _engine("--devices", "2")
    capture = check.PassCapture(eng, CHECKED)
    state = eng.init_state(None)
    for p in range(3):
        state = eng.run_pass(state, p)
    capture.to_host()
    return ref.plan_of(eng), _scene(cfg), capture


@pytest.mark.parametrize("pass_index", CHECKED)
@pytest.mark.parametrize("ordinal", [0, 1])
def test_program_pass_equals_the_reference_bitwise(render, pass_index,
                                                   ordinal):
    plan, scene, capture = render
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
    if pass_index > 0:
        # The later pass replays orbits of the band onto the canvas.
        assert taken["counters"]["emitted"] > 0
        assert int(expected[1].sum()) == taken["counters"]["dev_hits"] > 0


def test_ordinals_draw_their_own_streams(render):
    _, _, capture = render
    a, b = (capture.taken[(2, o)]["after"] for o in (0, 1))
    assert check.lanes_differ(a, b) > 0


@pytest.mark.parametrize("seed", [SEED, 3_000_000_019])
def test_float32_in_place_of_df32_fails_the_check(seed):
    cfg, _ = _engine()
    plan = ref.Plan(lanes=512, steps_per_pass=2048, steps_per_flush=256,
                    unroll=4, capacity=4096)
    got = check.control_checks(ref, seed, 0, plan, _scene(cfg), "cpu",
                               dtype=torch.float32)
    assert got["bins"] > check.LIMIT and got["lanes"] > check.LIMIT
    same = check.control_checks(ref, seed, 0, plan, _scene(cfg), "cpu",
                                dtype=ref.DF32)
    assert same == {"bins": 0, "counters": 0, "lanes": 0}


def test_other_dtypes_are_refused():
    with pytest.raises(ValueError, match="df32"):
        ref.init_lanes(4, "cpu", torch.bfloat16)


def _host_mode(eng):
    eng.replay_mode = "host"
    return eng


@pytest.mark.parametrize("what,extra,patch", [
    ("float32", ["--precision", "float32"], None),
    ("MH", ["--sampler", "mh"], None),
    ("emit filter", ["--emit-filter", "canvas"], None),
    ("row shards", ["--devices", "2", "--hist-sharding", "rows"], None),
    ("host replay", [], _host_mode),
    ("sample domain", ["--sample-domain",
                       "-0.74365,-0.74363,0.13182,0.13184"], None),
])
def test_plan_of_refuses_what_it_does_not_model(what, extra, patch):
    if what == "sample domain":
        # Bounds in place of the zoom shorthand, which sets the domain.
        extra = [*extra, "--min-real", "-0.74364", "--max-real", "-0.74363",
                 "--min-imag", "0.131825", "--max-imag", "0.1318325"]
        argv = [a for a in TINY if a not in ("--center", CENTER, "--span",
                                            "1e-5")]
        cfg, _ = parse_args([*argv, *extra])
        eng = engines.make_engine(cfg, device="cpu")
    else:
        _, eng = _engine(*extra)
    if patch is not None:
        eng = patch(eng)
    with pytest.raises(ValueError, match=what):
        ref.plan_of(eng)


def test_data_parallel_host_replay_is_refused_and_f32_refuses_df32():
    stub = type("DataParallelHostReplayEngine", (), {})()
    with pytest.raises(ValueError, match="host replay"):
        ref.plan_of(stub)
    _, eng = _engine()
    with pytest.raises(ValueError, match="thin-tracked"):
        uniform_f32.plan_of(eng)
    assert ref.plan_of(eng).unroll == 4


def _f32(rng, n, lo, hi):
    """``n`` float32 of random sign and magnitude in [2^lo, 2^hi)."""
    mag = np.exp2(rng.uniform(lo, hi, n)) * rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(mag.astype(np.float32))


def _exact(t):
    return [Fraction(float(v)) for v in t.tolist()]


@pytest.mark.parametrize("scale", [(0, 1, 0, 1), (-10, 10, -10, 10),
                                   (-3, 3, -30, -20), (20, 40, -40, -20)])
def test_two_sum_and_fast_two_sum_are_exact(scale):
    rng = np.random.default_rng(sum(scale) + 100)
    a = _f32(rng, 500, scale[0], scale[1])
    b = _f32(rng, 500, scale[2], scale[3])
    s, e = ref.two_sum(a, b)
    assert torch.equal(s, a + b)
    for x, y, u, v in zip(*map(_exact, (a, b, s, e))):
        assert u + v == x + y
    big = torch.where(a.abs() >= b.abs(), a, b)
    small = torch.where(a.abs() >= b.abs(), b, a)
    s2, e2 = ref.fast_two_sum(big, small)
    assert torch.equal(s2, s) and torch.equal(e2, e)


@pytest.mark.parametrize("scale", [(0, 1, 0, 1), (-20, 20, -20, 20),
                                   (-60, -40, 30, 50), (30, 60, 30, 60)])
def test_two_prod_is_exact(scale):
    rng = np.random.default_rng(sum(scale) + 200)
    a = _f32(rng, 500, scale[0], scale[1])
    b = _f32(rng, 500, scale[2], scale[3])
    p, e = ref.two_prod(a, b)
    assert torch.equal(p, a * b)
    for x, y, u, v in zip(*map(_exact, (a, b, p, e))):
        assert u + v == x * y
    # The float64 identity: p + e is the product, e at most half p's ulp.
    p64, e64 = p.double(), e.double()
    assert torch.equal(p64 + e64, a.double() * b.double())
    ulp = torch.from_numpy(np.spacing(np.abs(p.numpy())).astype(np.float64))
    assert bool((e64.abs() <= ulp / 2).all())


@pytest.mark.parametrize("op", ["add", "mul", "sqr"])
def test_df32_operations_keep_48_bits(op):
    rng = np.random.default_rng(7)
    x = rng.uniform(-2.0, 2.0, (2, 300))
    hi = torch.from_numpy(x.astype(np.float32))
    lo = torch.from_numpy((x - hi.double().numpy()).astype(np.float32))
    if op == "add":
        h, lo_ = ref.df_add(hi[0], lo[0], hi[1], lo[1])
    elif op == "mul":
        h, lo_ = ref.df_mul(hi[0], lo[0], hi[1], lo[1])
    else:
        h, lo_ = ref.df_sqr(hi[0], lo[0])
    a, b = (hi[i].double() + lo[i].double() for i in (0, 1))
    want = {"add": a + b, "mul": a * b, "sqr": a * a}[op]
    got = h.double() + lo_.double()
    assert bool(((got - want).abs() <= 2.0 ** -44 * want.abs()
                 + 2.0 ** -96).all())
    assert torch.equal(h, h + lo_)


def test_the_cell_is_the_readme_zoom():
    cell = cells.load_cell("zoom1e5.df32")
    cfg, _ = parse_args(cell.argv(SEED, 20))
    readme, _ = parse_args(["-w", "1600", "-h", "1200", "-m", "20000",
                            "-c", "500", "--precision", "extended",
                            "--center", CENTER, "--span", "1e-5"])
    assert cfg.canvas == readme.canvas
    assert cfg.sample_domain == readme.sample_domain
    assert cfg.band == readme.band
    cv = cfg.canvas
    assert cv.max_real - cv.min_real == pytest.approx(1e-5, rel=1e-9)
    assert cv.max_imag - cv.min_imag == pytest.approx(7.5e-6, rel=1e-9)
    assert cfg.options.precision == "extended"
    assert cells.reference(cell.config) is ref
    scene = ref.Scene.from_cell(cell.config["canvas"], cell.traffic["band"])
    assert scene.domain == tuple(cfg.sample_domain)
    assert (scene.min_it, scene.max_it) == (500, 20000)


def test_the_new_metrics_read_the_zoom_cell_only():
    new = {"classify_ext_roofline", "replay_deposit_ext_roofline"}
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        names = {m["name"] for m in cells.load_cell(w["name"]).per_layer}
        assert (new <= names) == (w["name"] == "zoom1e5.df32")
    coarse = cells.load_cell("hires15k.coarse")
    assert coarse.traffic["band"] == {"min_escape": 20, "max_escape": 500}
    assert coarse.config["reference"] == "uniform_f32"


def _m(op_s, layer_s, **stats):
    costs = json.loads((BENCH_DIR / "costs.json").read_text())
    trace = types.SimpleNamespace(op_s=op_s, layer_s=layer_s)
    return types.SimpleNamespace(
        trace=trace, costs=costs, stats=stats, passes=1, replicas=1,
        geometry={"lanes": 128, "pixels": 64, "emission_slots": 128})


def test_df32_roofline_readers():
    classify = cells.reader("classify_ext_roofline")
    deposit = cells.reader("replay_deposit_ext_roofline")
    # 5e11 useful df32 steps at 67 operations in 1 s: half of 67 TFLOP/s.
    m = _m({"ns::classify_ext_kernel_0_4": 1.0,
            "ns::replay_deposit_ext_kernel_0": 1.0},
           {"classify": 1.0, "deposit": 1.0}, classify_iters=5 * 10 ** 11,
           samples=0, orbit_points=5 * 10 ** 11, on_canvas_points=0,
           emitted=0)
    assert classify(m) == pytest.approx(50.0)
    assert deposit(m) == pytest.approx(100.0 * 5e11 * 94 / 67e12)
    f32 = _m({"ns::classify_kernel_0": 1.0, "ns::replay_deposit_kernel": 1.0},
             {"classify": 1.0, "deposit": 1.0}, classify_iters=1, samples=1,
             orbit_points=1, on_canvas_points=1, emitted=1)
    assert classify(f32) is None and deposit(f32) is None
    m.trace = None
    assert classify(m) is None and deposit(m) is None
