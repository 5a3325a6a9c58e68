"""cudabrot_tpu_torch.ops.df32 against the JAX module, and the CUDA
header's arithmetic (csrc/df32.cuh) against both.

Bitwise against eager JAX: un-jitted, JAX runs one XLA primitive per
operation, so nothing contracts and every product and sum rounds once, as
in eager PyTorch. The port drops the JAX module's runtime-zero product
seal (``p = a*b + zero``); the JAX functions are called with
``zero = -0.0``, an identity for every value (``x + -0.0 == x``, signed
zeros included), so the comparison holds the port to ``p = RN(a*b)``
exactly. Inputs mix orbit-range values, tiny residuals, signed zeros,
infinities and NaNs; NaNs compare as NaNs (their payload is the
hardware's), everything else bit for bit. Denormals are left out of the
JAX comparison only: XLA's CPU backend flushes them to zero, while eager
PyTorch and the CUDA kernels (no -ftz) keep IEEE gradual underflow; the
g++ build of the CUDA header below is held to the port on denormals too.

The properties of tests/test_df32.py (exact two_sum, narrow exact split,
f64 tracking, the ship fold, NaN counts as escaped) are restated for the
port. The last tests build csrc/host_harness.cpp with g++ (skipped without
it) and hold the header's functions, the classify_ext lane function and
the df32 replay to the plain PyTorch versions bitwise: the arithmetic the
CUDA kernels compile, run on the CPU.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.ops import df32 as jdf
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.models.fractals import FRACTALS
from cudabrot_tpu_torch.ops import binning
from cudabrot_tpu_torch.ops import classify_ext as cx
from cudabrot_tpu_torch.ops import df32

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)

NEG_ZERO = jnp.float32(-0.0)
N = 4096


SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e30, -1e30, 3.4e38,
           1.17549435e-38, 1.0, -1.0, 2.0]
DENORMAL = [1e-45, -1e-45, 1e-39, -3e-39]


def _rand(n, seed, special=SPECIAL):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    e = rng.integers(-24, 2, n).astype(np.float32)
    a = (m * np.float32(2.0) ** e).astype(np.float32)
    if special:
        a[: len(special)] = rng.permutation(np.array(special, np.float32))
    return a


def _rand_ieee(n, seed):
    return _rand(n, seed, SPECIAL + DENORMAL)


def _same(got, want):
    """Bit for bit, NaNs matching NaNs."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.int32)[~nan],
                                  want.view(np.int32)[~nan])


def _t(*arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


# name, port function, JAX function, number of f32 inputs, takes zero
FUNCTIONS = [
    ("two_sum", df32.two_sum, jdf.two_sum, 2, False),
    ("quick_two_sum", df32.quick_two_sum, jdf.quick_two_sum, 2, False),
    ("split", df32.split, jdf.split, 1, False),
    ("two_prod", df32.two_prod, jdf.two_prod, 2, True),
    ("two_prod_sqr", df32.two_prod_sqr, jdf.two_prod_sqr, 1, True),
    ("add", df32.add, jdf.add, 4, False),
    ("add_f", df32.add_f, jdf.add_f, 3, False),
    ("sub", df32.sub, jdf.sub, 4, False),
    ("mul", df32.mul, jdf.mul, 4, True),
    ("sqr", df32.sqr, jdf.sqr, 2, True),
    ("neg", df32.neg, jdf.neg, 2, False),
    ("abs_", df32.abs_, jdf.abs_, 2, False),
]


def _exact_error(a, b, p):
    """RN(a*b - p) in float32 from float64 arithmetic, where the product of
    two floats and its difference from p are exact (inf and NaN as IEEE
    gives them)."""
    with np.errstate(invalid="ignore", over="ignore"):
        return (a.astype(np.float64) * b.astype(np.float64)
                - p.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("name,fn,jfn,nargs,sealed", FUNCTIONS,
                         ids=[f[0] for f in FUNCTIONS])
def test_function_bitwise_vs_eager_jax(name, fn, jfn, nargs, sealed):
    args = [_rand(N, 100 + i) for i in range(nargs)]
    got = fn(*_t(*args))
    jargs = [jnp.asarray(a) for a in args]
    want = jfn(*jargs, NEG_ZERO) if sealed else jfn(*jargs)
    if name.startswith("two_prod"):
        # Where the product overflows, the JAX module's split partial
        # products overflow too and its error is inf - inf, NaN; the port's
        # is the exact error, an infinity (test_two_prod_edge_cases). Every
        # finite product's error is the JAX module's, bit for bit.
        a, b = (args * 2)[:2]
        p, e = (np.asarray(w) for w in want)
        assert (~np.isfinite(p)).sum() > 0
        want = (p, np.where(np.isfinite(p), e, _exact_error(a, b, p)))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("fold_abs", [False, True])
def test_complex_sqr_add_bitwise_vs_eager_jax(fold_abs):
    args = [_rand(N, 200 + i) for i in range(8)]
    got = df32.complex_sqr_add(*_t(*args), fold_abs=fold_abs)
    want = jdf.complex_sqr_add(*(jnp.asarray(a) for a in args), NEG_ZERO,
                               fold_abs=fold_abs)
    for g, w in zip(got, want):
        _same(g, w)


def test_from_float_and_to_float64_match_jax():
    for x in (-0.7436438870371587, 0.1318259042124784, 2.0, -1.9999999999,
              0.0):
        assert df32.from_float(x) == jdf.from_float(x)
        hi, lo = df32.from_float(x)
        assert abs((hi + lo) - x) <= abs(x) * 2.0**-47
    hi, lo = _rand(64, 5, special=None), _rand(64, 6, special=None)
    np.testing.assert_array_equal(df32.to_float64(*_t(hi, lo)),
                                  jdf.to_float64(hi, lo))


# -- the properties of tests/test_df32.py, for the port --------------------


def test_two_sum_exact():
    a, b = _rand(N, 1, special=None), _rand(N, 2, special=None)
    s, e = (t.numpy() for t in df32.two_sum(*_t(a, b)))
    np.testing.assert_array_equal(s, (a + b).astype(np.float32))
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(
        s.astype(np.float64) + e.astype(np.float64), exact)


def test_split_is_exact_and_narrow():
    a = _rand(N, 10, special=None)
    hi, lo = (t.numpy() for t in df32.split(*_t(a)))
    np.testing.assert_array_equal(hi + lo, a)
    for half in (hi, lo):
        sq32 = (half * half).astype(np.float32).astype(np.float64)
        np.testing.assert_array_equal(sq32, half.astype(np.float64) ** 2)


@pytest.mark.parametrize("square", [False, True])
def test_two_prod_error_is_the_exact_product_error(square):
    """On 10^6 seeded pairs with exponents in [-30, 30) (products and their
    errors in the normal range) the port's two-products, whose error is the
    exact RN(a*b - p) that one fused multiply-add, fmaf(a, b, -p), returns,
    equal the JAX package's eager Veltkamp-split two-products bit for bit:
    the same bits at fewer operations, which is what lets csrc/df32.cuh
    spend one FFMA on each product's error."""
    rng = np.random.default_rng(8 + square)
    n = 1_000_000

    def draw():
        m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
        return (m * 2.0 ** rng.integers(-30, 30, n)).astype(np.float32)

    a = draw()
    b = a if square else draw()
    p, e = (df32.two_prod_sqr(*_t(a)) if square
            else df32.two_prod(*_t(a, b)))
    jp, je = (jdf.two_prod_sqr(jnp.asarray(a), NEG_ZERO) if square
              else jdf.two_prod(jnp.asarray(a), jnp.asarray(b), NEG_ZERO))
    _same(p, np.asarray(jp))
    _same(e, np.asarray(je))
    assert int((e != 0).sum()) > n // 2


def _edge_pairs(square=False):
    """Two-product inputs at the edges of the FMA error: signed zeros,
    exact products, infinities and NaN, products that overflow, products
    whose error is subnormal or underflows to a signed zero, subnormal
    products; the last three also as 4096 seeded pairs each. ``square``:
    pairs (a, a) with the same ranges of products."""
    inf, nan = np.inf, np.nan
    fixed = [(0.0, 1.0), (-0.0, 1.0), (0.0, -1.0), (-0.0, -0.0), (0.0, inf),
             (inf, 2.0), (-inf, 2.0), (inf, -inf), (nan, 1.0), (1.0, nan),
             (1.5, 2.0), (-1.5, 2.0), (2.0**100, 1.5 * 2.0**30),
             (-(2.0**100), 1.5 * 2.0**30), (3.4e38, 1.0000001),
             (1e20, -1e20), (1e-30, 1e-15), (1.17549435e-38, 0.5),
             (1.17549435e-38, 1.0000001), (1e-45, 1.5), (-3e-39, 0.75)]
    rng = np.random.default_rng(77)
    n = 4096

    def mant():
        return rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)

    cols = [np.array([x for x, _ in fixed]), np.array([y for _, y in fixed])]
    if square:
        cols[1] = cols[0]
    for lo, hi in ((-150, -120), (-128, -100), (120, 135)):
        if square:
            x = mant() * 2.0 ** (rng.integers(lo, hi, n) / 2.0)
            cols = [np.concatenate([c, x]) for c in cols]
            continue
        ea = rng.integers(-60, 60, n)
        eb = rng.integers(lo, hi, n) - ea
        cols[0] = np.concatenate([cols[0], mant() * 2.0**ea])
        cols[1] = np.concatenate([cols[1], mant() * 2.0**eb])
    with np.errstate(over="ignore"):  # some overflow pairs hold an inf
        return cols[0].astype(np.float32), cols[1].astype(np.float32)


def _fraction_error(a, b):
    """(p, RN(a*b - p)) from exact rational arithmetic (fractions), one
    rounding to float32 at the end; IEEE's inf and NaN where an input or
    the product is not finite."""
    from fractions import Fraction

    with np.errstate(invalid="ignore", over="ignore"):
        p = (a * b).astype(np.float32)
    e = np.empty_like(p)
    for i, (x, y, q) in enumerate(zip(a.tolist(), b.tolist(), p.tolist())):
        if np.isfinite(q):
            exact = Fraction(x) * Fraction(y) - Fraction(q)
            e[i] = np.float32(float(exact)) if exact else np.float32(0.0)
        elif np.isnan(q) or not (np.isfinite(x) and np.isfinite(y)):
            e[i] = np.nan if np.isnan(q) or np.isinf(q) else q
        else:
            e[i] = -q  # overflow: a*b - inf is -inf
    return p, e


@pytest.mark.parametrize("square", [False, True])
def test_two_prod_edge_cases(square):
    """The plain two-products are p = RN(a*b) and the FMA error RN(a*b - p)
    everywhere: held against exact rational arithmetic at signed zeros,
    subnormal errors and products, overflow to +-inf, and NaN."""
    a, b = _edge_pairs(square)
    p, e = df32.two_prod_sqr(*_t(a)) if square else df32.two_prod(*_t(a, b))
    wp, we = _fraction_error(a, b)
    _same(p, wp)
    _same(e, we)
    fin = np.isfinite(wp)
    assert (we[fin] != 0).sum() > 0 and (np.abs(we[fin]) < 1.17549435e-38
                                         ).sum() > 1000
    assert np.isinf(we).sum() > 100 and np.isnan(we).sum() > 0
    assert (np.signbit(we) & (we == 0)).sum() > 0


def _df_from64(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def test_add_mul_sqr_track_float64():
    rng = np.random.default_rng(6)
    x64, y64 = rng.uniform(-2.0, 2.0, 65536), rng.uniform(-2.0, 2.0, 65536)
    x, y = _t(*_df_from64(x64)), _t(*_df_from64(y64))
    scale = np.abs(x64) + np.abs(y64)
    for op, ref in ((df32.add, x64 + y64), (df32.sub, x64 - y64)):
        err = np.abs(df32.to_float64(*op(*x, *y)) - ref) / scale
        assert err.max() < 2.0**-46, (op.__name__, err.max())
    ref = x64 * y64
    err = np.abs(df32.to_float64(*df32.mul(*x, *y)) - ref)
    assert (err / np.maximum(np.abs(ref), 1e-30)).max() < 2.0**-45
    err = np.abs(df32.to_float64(*df32.sqr(*x)) - x64**2)
    assert (err / np.maximum(x64**2, 1e-30)).max() < 2.0**-45
    # Results are renormalized: hi = RN(hi + lo).
    for h, lo in (df32.add(*x, *y), df32.mul(*x, *y)):
        assert torch.equal(h, h + lo)


def test_complex_sqr_add_tracks_float64_orbit():
    """200 df32 steps of a bounded orbit stay within 2^-30 of the f64
    orbit (the error grows with the orbit's derivative; plain f32 has lost
    all but ~3 digits by then)."""
    c = -0.7436438870371587 + 0.1318259042124784j
    cr, ci = df32.from_float(c.real), df32.from_float(c.imag)
    cd = complex(cr[0] + cr[1], ci[0] + ci[1])
    cpair = [torch.tensor(v, dtype=torch.float32) for v in (*cr, *ci)]
    z = list(cpair)
    z64, z32 = np.complex128(cd), np.complex64(cd)
    df_err = f32_err = 0.0
    for _ in range(200):
        *z, _ = df32.complex_sqr_add(*z, *cpair)
        z64 = z64 * z64 + cd
        z32 = z32 * z32 + np.complex64(cd)
        got = complex(float(df32.to_float64(z[0], z[1])),
                      float(df32.to_float64(z[2], z[3])))
        df_err = max(df_err, abs(got - complex(z64)))
        f32_err = max(f32_err, abs(complex(z32) - complex(z64)))
    assert abs(z64) < 2.0
    assert df_err < 2.0**-30, df_err
    assert f32_err > df_err * 1e4


def test_burning_ship_fold():
    rng = np.random.default_rng(9)
    x64, y64 = rng.uniform(-2.0, 2.0, 512), rng.uniform(-2.0, 2.0, 512)
    c = [torch.tensor(v, dtype=torch.float32) for v in (0.1, 0.0, 0.1, 0.0)]
    nzr, nzrl, nzi, nzil, _ = df32.complex_sqr_add(
        *_t(*_df_from64(x64)), *_t(*_df_from64(y64)), *c, fold_abs=True)
    ax, ay, c32 = np.abs(x64), np.abs(y64), np.float64(np.float32(0.1))
    assert np.abs(df32.to_float64(nzr, nzrl)
                  - (ax * ax - ay * ay + c32)).max() < 2.0**-44
    assert np.abs(df32.to_float64(nzi, nzil)
                  - (2 * ax * ay + c32)).max() < 2.0**-44


def test_nan_inf_count_as_escaped():
    big, zero = torch.tensor(1e30), torch.tensor(0.0)
    out = df32.complex_sqr_add(big, zero, big, zero, zero, zero, zero, zero)
    assert not bool(out[4] <= 4.0)
    out2 = df32.complex_sqr_add(*out[:4], zero, zero, zero, zero)
    assert not bool(out2[4] <= 4.0)


# -- csrc/df32.cuh and classify_ext.cuh, built for the CPU -----------------

CSRC = Path(df32.__file__).resolve().parent.parent / "csrc"
FP = ctypes.POINTER(ctypes.c_float)


@pytest.fixture(scope="session")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/host_harness.cpp")
    out = tmp_path_factory.mktemp("cb_host") / "libcb_host.so"
    # -ffp-contract=off: one rounding per operation, as __fmul_rn and
    # __fadd_rn give on the device.
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(CSRC / "host_harness.cpp")],
        check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(out))


def _p(a):
    return a.ctypes.data_as(FP)


def _outs(k, n=N):
    return [np.empty(n, np.float32) for _ in range(k)]


def test_header_elementary_functions_bitwise(harness):
    a, b = _rand_ieee(N, 31), _rand_ieee(N, 32)
    for cname, fn, two in (("cbh_two_sum", df32.two_sum, True),
                           ("cbh_quick_two_sum", df32.quick_two_sum, True),
                           ("cbh_two_prod", df32.two_prod, True),
                           ("cbh_split", df32.split, False),
                           ("cbh_two_prod_sqr", df32.two_prod_sqr, False)):
        x, y = _outs(2)
        ins = (a, b) if two else (a,)
        getattr(harness, cname)(*map(_p, ins), N, _p(x), _p(y))
        for g, w in zip((x, y), fn(*_t(*ins))):
            _same(g, w.numpy())


@pytest.mark.parametrize("square", [False, True])
def test_header_two_prod_edge_cases_bitwise(harness, square):
    """The header's FFMA two-products (g++, std::fmaf) against the plain
    ones at test_two_prod_edge_cases' inputs: signed zeros, subnormal
    errors, overflow to +-inf, NaN."""
    a, b = _edge_pairs(square)
    n = a.size
    p, e = _outs(2, n)
    if square:
        harness.cbh_two_prod_sqr(_p(a), n, _p(p), _p(e))
        want = df32.two_prod_sqr(*_t(a))
    else:
        harness.cbh_two_prod(_p(a), _p(b), n, _p(p), _p(e))
        want = df32.two_prod(*_t(a, b))
    _same(p, want[0].numpy())
    _same(e, want[1].numpy())


def test_header_df_functions_bitwise(harness):
    ah, al, bh, bl = (_rand_ieee(N, 40 + i) for i in range(4))
    for op, fn in enumerate((df32.add, df32.sub, df32.mul)):
        h, lo = _outs(2)
        harness.cbh_binary(op, _p(ah), _p(al), _p(bh), _p(bl), N, _p(h),
                           _p(lo))
        for g, w in zip((h, lo), fn(*_t(ah, al, bh, bl))):
            _same(g, w.numpy())
    for op, fn in enumerate((df32.sqr, df32.abs_)):
        h, lo = _outs(2)
        harness.cbh_unary(op, _p(ah), _p(al), _p(bh), N, _p(h), _p(lo))
        for g, w in zip((h, lo), fn(*_t(ah, al))):
            _same(g, w.numpy())
    h, lo = _outs(2)
    harness.cbh_unary(2, _p(ah), _p(al), _p(bh), N, _p(h), _p(lo))
    for g, w in zip((h, lo), df32.add_f(*_t(ah, al, bh))):
        _same(g, w.numpy())


@pytest.mark.parametrize("fold_abs", [False, True])
def test_header_complex_sqr_add_bitwise(harness, fold_abs):
    z = [_rand_ieee(N, 50 + i) for i in range(4)]
    c = [_rand_ieee(N, 60 + i) for i in range(4)]
    out = _outs(5)
    arr = FP * 4
    harness.cbh_complex_sqr_add(int(fold_abs), arr(*map(_p, z)),
                                arr(*map(_p, c)), N, (FP * 5)(*map(_p, out)))
    want = df32.complex_sqr_add(*_t(*z), *_t(*c), fold_abs=fold_abs)
    for g, w in zip(out, want):
        _same(g, w.numpy())


WINDOW = (-0.743643887037151 - 1e-7, -0.743643887037151 + 1e-7,
          0.131825904205330 - 1e-7, 0.131825904205330 + 1e-7)


@pytest.mark.parametrize("name,domain,band,visit", [
    ("buddhabrot", WINDOW, (50, 3000), None),
    ("buddhabrot", tcfg.SAMPLE_DOMAIN, (5, 200), (-1.5, 0.5, -1.0, 1.0)),
    ("burning-ship", (-1.7548 - 5e-7, -1.7548 + 5e-7, -0.0338 - 5e-7,
                      -0.0338 + 5e-7), (5, 500), None),
    ("anti-buddhabrot", tcfg.SAMPLE_DOMAIN, (0, 64), None),
])
def test_header_classify_ext_lane_bitwise(harness, name, domain, band, visit):
    """The lane function the CUDA kernel runs per thread, looped on the
    CPU, against classify_pass_ext_plain: lane state, emissions and stats
    bit for bit, from a carried mid-flight state."""
    rows, steps, flush, unroll = 2, 512, 64, 4
    fr = FRACTALS[name]
    kw = dict(fractal=fr, min_it=band[0], max_it=band[1],
              steps_per_pass=steps, steps_per_flush=flush,
              inner_unroll=unroll, sample_domain=domain, visit_window=visit)
    state = cx.init_ext_lane_state(rows)
    cx.classify_pass_ext(state, (5, 6), **kw)
    want = cx.classify_pass_ext(
        cx.ExtLaneState(*(t.clone() for t in state)), (7, 8), **kw)

    lanes, chunks = rows * 128, steps // flush
    arrays = [t.numpy().reshape(-1).copy() for t in state]
    emit_c = np.empty((chunks, 2, lanes), np.float32)
    emit_it = np.empty((chunks, lanes), np.int32)
    stats = np.empty((5, lanes), np.int32)
    ptrs = (ctypes.c_void_p * 20)(
        *(a.ctypes.data for a in (*arrays, emit_c, emit_it, stats)), None)
    c0r, c0i, step_r, step_i = cx.grid_params(domain)
    iargs = (ctypes.c_int * 9)(fr.kernel_id, int(visit is not None), lanes,
                               chunks, flush // unroll, unroll, band[0],
                               band[1], int(fr.cycle_detect))
    fargs = (ctypes.c_float * 10)(*c0r, *c0i, step_r, step_i,
                                  *(visit or (0.0,) * 4))
    harness.cbh_classify_ext.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), FP,
        ctypes.c_uint32, ctypes.c_uint32]
    assert harness.cbh_classify_ext(ptrs, iargs, fargs, 7, 8) == 0
    for f, a, w in zip(cx.ExtLaneState._fields, arrays, want.state):
        assert a.tobytes() == w.numpy().tobytes(), f
    assert emit_c.tobytes() == want.emit_c.numpy().tobytes()
    assert emit_it.tobytes() == want.emit_it.numpy().tobytes()
    assert stats.tobytes() == want.stats.numpy().tobytes()
    assert (emit_it >= 0).sum() > 0


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_header_replay_ext_bitwise(harness, name):
    """The per-emission replay function of the fused df32 replay-deposit
    kernel against replay_deposit_ext_plain: histogram and hit count."""
    domain = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)
    canvas = tcfg.Canvas(width=48, height=40)
    rng = np.random.default_rng(3)
    k = 300
    kr = rng.integers(0, 1 << 24, k).astype(np.float32)
    ki = rng.integers(0, 1 << 24, k).astype(np.float32)
    iters = rng.integers(-1, 70, k).astype(np.int32)
    hist_p = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    hits_p = binning.replay_deposit_ext(
        hist_p, *_t(kr, ki), torch.from_numpy(iters), canvas=canvas,
        fractal=FRACTALS[name], sample_domain=domain)

    hist = np.zeros(canvas.num_pixels, np.uint32)
    hits = ctypes.c_ulonglong(0)
    c0r, c0i, step_r, step_i = cx.grid_params(domain)
    iargs = (ctypes.c_int * 7)(FRACTALS[name].kernel_id, k, canvas.width,
                               canvas.height, 0, 0, canvas.height)
    fargs = (ctypes.c_float * 12)(
        *c0r, *c0i, step_r, step_i, *df32.from_float(canvas.min_real),
        *df32.from_float(canvas.min_imag),
        np.float32(1.0 / canvas.delta_real),
        np.float32(1.0 / canvas.delta_imag))
    vp = ctypes.c_void_p
    harness.cbh_replay_deposit_ext.argtypes = [
        vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int), FP, vp]
    rc = harness.cbh_replay_deposit_ext(
        kr.ctypes.data, ki.ctypes.data, iters.ctypes.data, hist.ctypes.data,
        iargs, fargs, ctypes.addressof(hits))
    assert rc == 0
    np.testing.assert_array_equal(hist.view(np.int32), hist_p.numpy())
    assert hits.value == int(hits_p) == int(hist.sum()) > 0


@pytest.mark.parametrize("rows", [(0, 40), (0, 17), (17, 17), (24, 17)])
def test_header_replay_ext_row_window_bitwise(harness, rows):
    """The df32 replay with a row window (classify_ext.cuh replay_ext_one,
    bin_id_df's window instantiation for a shard, the whole-canvas one for
    (0, height)) against replay_deposit_ext_plain with that window: the
    shard's histogram and its count."""
    domain = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)
    canvas = tcfg.Canvas(width=48, height=40)
    rng = np.random.default_rng(4)
    k = 300
    kr = rng.integers(0, 1 << 24, k).astype(np.float32)
    ki = rng.integers(0, 1 << 24, k).astype(np.float32)
    iters = rng.integers(-1, 70, k).astype(np.int32)
    cells = rows[1] * canvas.width
    hist_p = torch.zeros(cells, dtype=torch.int32)
    hits_p = binning.replay_deposit_ext_plain(
        hist_p, *_t(kr, ki), torch.from_numpy(iters), canvas=canvas,
        fractal=FRACTALS["buddhabrot"], sample_domain=domain, rows=rows)
    hist = np.zeros(cells, np.uint32)
    hits = ctypes.c_ulonglong(0)
    c0r, c0i, step_r, step_i = cx.grid_params(domain)
    iargs = (ctypes.c_int * 7)(FRACTALS["buddhabrot"].kernel_id, k,
                               canvas.width, canvas.height, 0, *rows)
    fargs = (ctypes.c_float * 12)(
        *c0r, *c0i, step_r, step_i, *df32.from_float(canvas.min_real),
        *df32.from_float(canvas.min_imag),
        np.float32(1.0 / canvas.delta_real),
        np.float32(1.0 / canvas.delta_imag))
    vp = ctypes.c_void_p
    harness.cbh_replay_deposit_ext.argtypes = [
        vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int), FP, vp]
    assert harness.cbh_replay_deposit_ext(
        kr.ctypes.data, ki.ctypes.data, iters.ctypes.data, hist.ctypes.data,
        iargs, fargs, ctypes.addressof(hits)) == 0
    np.testing.assert_array_equal(hist.view(np.int32), hist_p.numpy())
    assert hits.value == int(hits_p) == int(hist.sum()) > 0
