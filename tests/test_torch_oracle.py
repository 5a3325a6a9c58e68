"""The port's oracle (plain PyTorch, float32/float64) against the scalar
float64 ground truth and against the JAX oracle.

Eager PyTorch rounds every product and sum once, as the scalar Python
re-statement does, so at float64 the port's classification and a whole
pass equal ``tests/reference_impl.py`` exactly (the JAX oracle's own tests
allow one mismatch for XLA's fused multiply-adds; the port needs none).
The sample stream is ``jax.random``'s for the same key, bit for bit, on
the default domain (the span 4 scales exactly) and, at float64, on a
deep-zoom window; on a general domain XLA's CPU backend contracts ``u * span + lo`` into one
fused multiply-add and the port's two roundings differ in the last bit for
~20% of the samples (measured on (0.1, 0.7)), so such a domain is compared
to one float32 ulp of its larger bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.ops import oracle as joracle
from cudabrot_tpu_torch.config import (
    Canvas,
    ConfigError,
    EngineOptions,
    IterationBand,
    RenderConfig,
)
from cudabrot_tpu_torch.engines import make_engine
from cudabrot_tpu_torch.engines.oracle_engine import OracleEngine
from cudabrot_tpu_torch.models import fractals
from cudabrot_tpu_torch.ops import oracle, prng
from tests import reference_impl as ref

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)

_CX, _CY = -0.743643887037151, 0.131825904205330
DEEP = (_CX - 5e-6, _CX + 5e-6, _CY - 5e-6, _CY + 5e-6)


def _samples(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2.0, 2.0, n), rng.uniform(-2.0, 2.0, n)


@pytest.mark.parametrize("fractal_name", ["buddhabrot", "burning-ship"])
def test_classify_matches_scalar(fractal_name):
    cr, ci = _samples(512)
    max_it = 64
    iters, escaped, trip, vis = oracle.classify(
        fractals.get_fractal(fractal_name), torch.from_numpy(cr),
        torch.from_numpy(ci), max_it)
    assert vis is None and trip == max_it
    want = np.array([
        ref.classify_scalar(a, b, max_it,
                            burning_ship=(fractal_name == "burning-ship"))
        for a, b in zip(cr, ci)])
    np.testing.assert_array_equal(iters.numpy(), want)
    np.testing.assert_array_equal(escaped.numpy(), want < max_it)


@pytest.mark.parametrize("dtype,domain", [
    ("float32", (-2.0, 2.0, -2.0, 2.0)),
    ("float64", (-2.0, 2.0, -2.0, 2.0)),
    ("float64", DEEP),
], ids=["f32-default", "f64-default", "f64-deep"])
def test_sample_stream_bitwise_vs_jax(dtype, domain):
    jkey = jax.random.fold_in(jax.random.key(123), 5)
    tkey = prng.fold_in(prng.key(123), 5)
    want = joracle.draw_samples(jkey, 4096, jnp.dtype(dtype), domain)
    got = oracle.draw_samples(tkey, 4096, getattr(torch, dtype), domain)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype == np.dtype(dtype)
        assert g.numpy().tobytes() == w.tobytes()
        lo, hi = (np.dtype(dtype).type(v) for v in
                  (domain[:2] if g is got[0] else domain[2:]))
        assert lo <= g.numpy().min() and g.numpy().max() <= hi


@pytest.mark.parametrize("domain,equal", [
    ((0.1, 0.7, -1.3, 0.2), 0.5),  # measured 0.80 equal
    (DEEP, 0.999),  # float32 cannot resolve it; measured 1 of 4096 differs
], ids=["general", "deep"])
def test_sample_stream_float32_within_one_ulp_of_the_bounds(domain, equal):
    jkey, tkey = jax.random.key(9), prng.key(9)
    want = joracle.draw_samples(jkey, 4096, jnp.float32, domain)
    got = oracle.draw_samples(tkey, 4096, torch.float32, domain)
    for g, w in zip(got, want):
        lo, hi = domain[:2] if g is got[0] else domain[2:]
        d = np.abs(g.numpy().astype(np.float64) - np.asarray(w))
        assert d.max() <= 2.0**-23 * max(abs(lo), abs(hi))
        assert (d == 0).mean() > equal


def _pass_cfg(canvas, n, max_it, min_it, **opt):
    return RenderConfig(
        canvas=canvas,
        band=IterationBand(max_escape_iterations=max_it,
                           min_escape_iterations=min_it),
        options=EngineOptions(engine="oracle", oracle_samples_per_pass=n,
                              **opt),
    )


def test_render_pass_matches_scalar_histogram():
    """A whole float64 pass against the scalar ground truth on the same
    samples: histogram, in-band count and every other stat, exact."""
    canvas = Canvas(width=64, height=48, min_real=-2.0, max_real=2.0,
                    min_imag=-1.5, max_imag=1.5)
    n, max_it, min_it = 512, 60, 5
    cfg = _pass_cfg(canvas, n, max_it, min_it, precision="float64")
    key = prng.key(123)
    hist, stats = oracle.render_pass(
        torch.zeros(canvas.shape, dtype=torch.int32), key, cfg)
    cr, ci = oracle.draw_samples(key, n, torch.float64)
    want_hist, want_iters, want_band = ref.render_samples(
        cr.numpy(), ci.numpy(), canvas, max_it, min_it)
    np.testing.assert_array_equal(hist.numpy().view(np.uint32), want_hist)
    assert int(stats.samples) == n
    assert int(stats.in_band) == int(want_band.sum())
    assert int(stats.culled) == int((want_iters < 0).sum())
    assert int(stats.orbit_points) == int((want_iters[want_band] + 1).sum())
    assert int(stats.replay_dropped) == 0
    # The JAX oracle draws the same samples, so its pass agrees too (up to
    # its fused multiply-adds: measured identical here).
    jhist, jstats = joracle.render_pass(
        jnp.zeros(canvas.shape, jnp.uint32), jax.random.key(123),
        _jax_cfg(cfg))
    assert int(jstats.in_band) == int(stats.in_band)
    assert np.abs(np.asarray(jhist).astype(np.int64)
                  - want_hist.astype(np.int64)).sum() <= 0.001 * want_hist.sum()


def _jax_cfg(cfg):
    from cudabrot_tpu import config as jc

    o = cfg.options
    return jc.RenderConfig(
        canvas=jc.Canvas(**{f: getattr(cfg.canvas, f) for f in (
            "width", "height", "min_real", "max_real", "min_imag",
            "max_imag")}),
        band=jc.IterationBand(
            max_escape_iterations=cfg.band.max_escape_iterations,
            min_escape_iterations=cfg.band.min_escape_iterations),
        options=jc.EngineOptions(
            engine="oracle", precision=o.precision,
            oracle_samples_per_pass=o.oracle_samples_per_pass,
            oracle_replay_capacity=o.oracle_replay_capacity),
    )


def test_render_pass_band_filter_and_accumulation():
    empty = _pass_cfg(Canvas(width=16, height=16), 256, 30, 30,
                      precision="float64")
    hist, stats = oracle.render_pass(
        torch.zeros((16, 16), dtype=torch.int32), prng.key(0), empty)
    assert int(stats.in_band) == 0 and int(hist.sum()) == 0
    cfg = _pass_cfg(Canvas(width=16, height=16), 256, 40, 2,
                    precision="float64")
    h1, _ = oracle.render_pass(torch.zeros((16, 16), dtype=torch.int32),
                               prng.key(5), cfg)
    h1 = h1.clone()
    h2, _ = oracle.render_pass(h1.clone(), prng.key(5), cfg)
    assert torch.equal(h2, 2 * h1) and int(h1.sum()) > 0


def test_classify_iters_plus_wasted_equals_executed_lockstep_work():
    cfg = _pass_cfg(Canvas(width=16, height=16), 512, 40, 2)
    _, stats = oracle.render_pass(torch.zeros((16, 16), dtype=torch.int32),
                                  prng.key(3), cfg)
    useful, wasted = int(stats.classify_iters), int(stats.wasted_steps)
    assert useful + wasted == 512 * 40
    assert useful > 0 and wasted > 0


def test_compacted_replay_matches_full_replay():
    """Deep-band passes compact in-band samples before the replay; the
    histogram equals the uncompacted one exactly, and overflow is counted,
    never silently lost. The auto capacity is the JAX oracle's."""
    canvas = Canvas(width=64, height=64)

    def run(capacity):
        cfg = _pass_cfg(canvas, 4096, 3000, 50,
                        oracle_replay_capacity=capacity)
        h, s = oracle.render_pass(
            torch.zeros(canvas.shape, dtype=torch.int32), prng.key(11), cfg)
        return h, s, cfg

    h_auto, s_auto, cfg = run(0)
    h_full, s_full, _ = run(4096)
    cap = oracle._replay_capacity(cfg, 4096)
    assert cap < 4096
    assert cap == joracle._replay_capacity(_jax_cfg(cfg), 4096)
    assert torch.equal(h_auto, h_full)
    assert int(s_auto.replay_dropped) == 0
    assert int(s_auto.orbit_points) == int(s_full.orbit_points)
    h_tiny, s_tiny, _ = run(1)
    n_band = int(s_full.in_band)
    assert n_band > 1
    assert int(s_tiny.replay_dropped) == n_band - 1
    assert int(h_tiny.sum()) < int(h_full.sum())


def test_interior_and_emit_filter_modes():
    """Anti-Buddhabrot samples replay exactly max_it points each; the
    canvas emit filter leaves the histogram as it was."""
    canvas = Canvas(width=32, height=32)
    cfg = RenderConfig(
        canvas=canvas, fractal="anti-buddhabrot",
        band=IterationBand(max_escape_iterations=40,
                           min_escape_iterations=2),
        options=EngineOptions(engine="oracle", oracle_samples_per_pass=512))
    _, stats = oracle.render_pass(
        torch.zeros(canvas.shape, dtype=torch.int32), prng.key(2), cfg)
    assert int(stats.in_band) > 0
    assert int(stats.orbit_points) == 40 * int(stats.in_band)
    crop = Canvas(width=32, height=32, min_real=-0.8, max_real=-0.7,
                  min_imag=0.0, max_imag=0.1)
    hists = []
    for filt in ("any", "canvas"):
        c = _pass_cfg(crop, 2048, 200, 10, emit_filter=filt)
        h, s = oracle.render_pass(
            torch.zeros(crop.shape, dtype=torch.int32), prng.key(4), c)
        hists.append((h, int(s.in_band)))
    assert torch.equal(hists[0][0], hists[1][0])
    assert 0 < hists[1][1] < hists[0][1]


def test_engine_routes_precisions_and_accumulates():
    """make_engine: the oracle takes float32, float64 and extended (run
    as float64); the cuda engine refuses float64 by name. Stats keys are
    the JAX oracle engine's."""
    from cudabrot_tpu.engines import oracle_engine as joe

    win = (_CX - 1e-7, _CX + 1e-7, _CY - 1e-7, _CY + 1e-7)
    base = dict(
        canvas=Canvas(width=24, height=24, min_real=win[0], max_real=win[1],
                      min_imag=win[2], max_imag=win[3]),
        band=IterationBand(max_escape_iterations=300,
                           min_escape_iterations=10),
        sample_domain=win,
    )
    for precision in ("float32", "float64", "extended"):
        eng = make_engine(RenderConfig(options=EngineOptions(
            engine="oracle", precision=precision,
            oracle_samples_per_pass=256), **base), device="cpu")
        assert isinstance(eng, OracleEngine) and eng.name == "oracle"
        state = eng.init_state(None)
        for p in range(2):
            state = eng.run_pass(state, p)
        stats = eng.stats(state)
        assert stats["samples"] == 512
        assert eng.histogram(state).dtype == np.uint32
        assert oracle.precision_dtype(precision) == (
            torch.float32 if precision == "float32" else torch.float64)
    jstats = joe.OracleEngine(_jax_cfg(_pass_cfg(
        Canvas(width=8, height=8), 64, 20, 2)))
    assert set(stats) == set(jstats.stats(jstats.init_state(None)))
    with pytest.raises(ConfigError, match="--engine oracle"):
        make_engine(RenderConfig(options=EngineOptions(
            precision="float64"), **base), device="cpu")
    resumed = eng.init_state(np.full((24, 24), 7, np.uint32))
    assert eng.histogram(resumed).sum() == 7 * 24 * 24


def test_make_pass_fn_keys_passes_by_index():
    cfg = _pass_cfg(Canvas(width=16, height=16), 128, 40, 2)
    fn = oracle.make_pass_fn(cfg)
    a, _ = fn(torch.zeros((16, 16), dtype=torch.int32), 0)
    b, _ = fn(torch.zeros((16, 16), dtype=torch.int32), 1)
    again, _ = fn(torch.zeros((16, 16), dtype=torch.int32), 0)
    assert torch.equal(a, again) and not torch.equal(a, b)
