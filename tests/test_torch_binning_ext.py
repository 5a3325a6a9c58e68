"""The df32 bin quantization and the df32 replay-deposit's plain version
vs the JAX package and vs a float64 scalar replay.

``points_to_bin_ids_df`` agrees with eager JAX bit for bit (one rounding
per operation on both sides; the inverse pitch is the same f32 constant).
The replay is compared with ``_blocked_replay_ext`` as the JAX package's
own test runs it (jitted, XLA scatter): XLA's CPU backend contracts the
df32 error sums into fused multiply-adds, so positions differ by ~2^-48
and a point within that distance of a pixel edge lands one bin over. The
bound is the JAX test's own: the same orbit-point mass, histogram L1
difference at most max(2, 2%) (measured 0 against JAX, at most 0.14%
against float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.config import Canvas as JCanvas
from cudabrot_tpu.engines.pallas_engine import _blocked_replay_ext
from cudabrot_tpu.models import fractals as jfr
from cudabrot_tpu.ops import binning as jb
from cudabrot_tpu.ops import df32 as jdf
from cudabrot_tpu.ops import pallas_kernels_ext as pke
from cudabrot_tpu_torch.config import Canvas
from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import binning as tb
from cudabrot_tpu_torch.ops import classify_ext as cx
from cudabrot_tpu_torch.ops import df32, launches
from tests import reference_impl

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)

_CX, _CY = -0.743643887037151, 0.131825904205330
DEEP_CANVAS = dict(width=1000, height=1000, min_real=_CX - 5e-6,
                   max_real=_CX + 5e-6, min_imag=_CY - 5e-6,
                   max_imag=_CY + 5e-6)
CANVASES = [DEEP_CANVAS, dict(width=64, height=48),
            dict(width=37, height=29, min_real=-2.0, max_real=1.0,
                 min_imag=-1.3, max_imag=1.1)]
FAST = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)


def _df_points(cv, n, seed):
    """df32 points over 1.2x the canvas (so some fall off each side), with
    a NaN, infinities and a far point."""
    rng = np.random.default_rng(seed)
    c = Canvas(**cv)
    out = []
    for lo, hi in ((c.min_real, c.max_real), (c.min_imag, c.max_imag)):
        span = hi - lo
        x = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, n)
        h = x.astype(np.float32)
        h[:4] = [np.nan, np.inf, -np.inf, 1e30]
        with np.errstate(invalid="ignore", over="ignore"):
            low = (x - h.astype(np.float64)).astype(np.float32)
        low[:4] = 0.0
        out += [h, low]
    return (*out, rng.uniform(size=n) < 0.9)


@pytest.mark.parametrize("cv", CANVASES)
def test_points_to_bin_ids_df_matches_eager_jax(cv):
    reh, rel, imh, iml, valid = _df_points(cv, 1 << 16, 5)
    c = Canvas(**cv)
    mr, mi = df32.from_float(c.min_real), df32.from_float(c.min_imag)
    ref = jb.points_to_bin_ids_df(
        JCanvas(**cv), *(jnp.asarray(a) for a in (reh, rel, imh, iml, valid)),
        tuple(jnp.float32(v) for v in mr), tuple(jnp.float32(v) for v in mi))
    got = tb.points_to_bin_ids_df(
        c, *(torch.from_numpy(a) for a in (reh, rel, imh, iml, valid)),
        tuple(torch.tensor(v, dtype=torch.float32) for v in mr),
        tuple(torch.tensor(v, dtype=torch.float32) for v in mi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    on = (got.numpy() < c.num_pixels).mean()
    assert 0.3 < on < 0.9, on  # points fall on and off the canvas


def _grid_to_f64(k_r, k_i, win):
    c0r, c0i, step_r, step_i = cx.grid_params(win)
    two23 = np.float32(8388608.0)
    off_r = (np.float32(k_r) - two23) * np.float32(step_r)
    off_i = (np.float32(k_i) - two23) * np.float32(step_i)
    return (float(df32.to_float64(*c0r) + np.float64(off_r)),
            float(df32.to_float64(*c0i) + np.float64(off_i)))


def _short_escapers(win, ship=False, cap=200):
    """Grid samples of ``win`` that escape within ``cap`` steps (float64
    scalar classification), padded to a multiple of 64 with unused slots,
    sorted by descending orbit length as the compaction leaves them."""
    rng = np.random.default_rng(7)
    rows = []
    for k_r, k_i in rng.integers(0, 1 << 24, size=(512, 2)):
        e = reference_impl.classify_scalar(*_grid_to_f64(k_r, k_i, win), cap,
                                           burning_ship=ship)
        if e < cap:
            rows.append((float(k_r), float(k_i), e))
        if len(rows) >= 256:
            break
    assert len(rows) >= 64
    rows.sort(key=lambda r: -r[2])
    pad = (-len(rows)) % 64
    kr = np.asarray([r[0] for r in rows] + [0.0] * pad, np.float32)
    ki = np.asarray([r[1] for r in rows] + [0.0] * pad, np.float32)
    it = np.asarray([r[2] for r in rows] + [-1] * pad, np.int32)
    return kr, ki, it


@pytest.mark.parametrize("name,win", [
    ("buddhabrot", FAST),
    ("burning-ship", (-1.7548 - 5e-7, -1.7548 + 5e-7, -0.0338 - 5e-7,
                      -0.0338 + 5e-7)),
])
def test_replay_deposit_ext_matches_jax_and_float64(name, win):
    cv = dict(width=64, height=64)
    canvas, ship = Canvas(**cv), name == "burning-ship"
    kr, ki, it = _short_escapers(win, ship)
    hist = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    launches.reset()
    hits = tb.replay_deposit_ext(
        hist, torch.from_numpy(kr), torch.from_numpy(ki),
        torch.from_numpy(it), canvas=canvas, fractal=tfr.FRACTALS[name],
        sample_domain=win)
    assert launches.COUNTS["replay_deposit_ext_plain"] == 1
    assert launches.COUNTS["replay_deposit_ext"] == 0
    got = hist.numpy().astype(np.int64)
    assert int(hits) == got.sum() > 0

    c0r, c0i, step_r, step_i = pke.grid_params(win)
    assert (c0r, c0i, step_r, step_i) == cx.grid_params(win)
    dfc = jnp.asarray(
        [*c0r, *c0i, *jdf.from_float(canvas.min_real),
         *jdf.from_float(canvas.min_imag), 0.0], jnp.float32)
    ref, ref_hits = jax.jit(
        lambda h, a, b, c, d: _blocked_replay_ext(
            h, a, b, c, fractal=jfr.FRACTALS[name], canvas=JCanvas(**cv),
            chunk=32, block=64, backend="xla", dfc=d, step_r=step_r,
            step_i=step_i)
    )(jnp.zeros(canvas.num_pixels, jnp.uint32), jnp.asarray(kr),
      jnp.asarray(ki), jnp.asarray(it), dfc)
    ref = np.asarray(ref).astype(np.int64)
    assert int(ref_hits[0]) + (int(ref_hits[1]) << 32) == ref.sum()
    assert got.sum() == ref.sum()
    assert np.abs(got - ref).sum() <= max(2, 0.02 * ref.sum())

    want = np.zeros(canvas.shape, np.int64)
    for k_r, k_i, n in zip(kr, ki, it):
        if n < 0:
            continue
        c_r, c_i = _grid_to_f64(k_r, k_i, win)
        zr, zi = c_r, c_i
        for _ in range(n + 1):
            if ship:
                zr, zi = abs(zr), abs(zi)
            zr, zi = zr * zr - zi * zi + c_r, 2 * zr * zi + c_i
            rc = reference_impl.bin_point(zr, zi, canvas)
            if rc is not None:
                want[rc] += 1
    diff = np.abs(got.reshape(canvas.shape) - want).sum()
    assert diff <= max(2, 0.02 * want.sum()), (diff, want.sum())


def test_replay_deposit_ext_accounting_and_validation():
    """An unused slot deposits nothing; an active one records iters + 1
    points; wrong dtypes and sizes raise."""
    canvas = Canvas(width=32, height=32)
    fr = tfr.FRACTALS["buddhabrot"]
    kw = dict(canvas=canvas, fractal=fr, sample_domain=FAST)
    mid = torch.full((2,), 8388608.0)
    hist = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    hits = tb.replay_deposit_ext(
        hist, mid, mid, torch.tensor([9, -1], dtype=torch.int32), **kw)
    assert int(hits) == int(hist.sum()) == 10  # every point is on canvas
    empty = torch.zeros(0)
    assert int(tb.replay_deposit_ext(
        hist, empty, empty, torch.zeros(0, dtype=torch.int32), **kw)) == 0
    it = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="grid indices must be float32"):
        tb.replay_deposit_ext(hist, mid.double(), mid, it, **kw)
    with pytest.raises(ValueError, match="iters must be int32"):
        tb.replay_deposit_ext(hist, mid, mid, it.long(), **kw)
    with pytest.raises(ValueError, match="does not match the canvas"):
        tb.replay_deposit_ext(hist[:-1].clone(), mid, mid, it, **kw)


@pytest.mark.parametrize("ext", [False, True])
def test_replay_adds_into_the_given_count(ext):
    """Both fused replays add their on-canvas count into a given int64 (the
    engine's dev_hits, which the kernels add to with atomics) and return
    it; two calls into one count equal the sum of two fresh ones; a count
    of another dtype or size is refused."""
    canvas = Canvas(width=32, height=32)
    fr = tfr.FRACTALS["buddhabrot"]
    if ext:
        kw = dict(canvas=canvas, fractal=fr, sample_domain=FAST)
        x = torch.full((3,), 8388608.0)
        replay = tb.replay_deposit_ext
    else:
        kw = dict(canvas=canvas, fractal=fr)
        x = torch.tensor([-0.1, 0.2, 0.3], dtype=torch.float32)
        replay = tb.replay_deposit
    it = torch.tensor([9, 4, -1], dtype=torch.int32)
    hist = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    fresh = [int(replay(hist, x, x, it, **kw)) for _ in range(2)]
    total = torch.full((), 5, dtype=torch.int64)
    hist2 = torch.zeros_like(hist)
    for _ in range(2):
        assert replay(hist2, x, x, it, hits=total, **kw) is total
    assert int(total) == 5 + sum(fresh) and torch.equal(hist, hist2)
    assert sum(fresh) == int(hist.sum()) > 0
    for bad in (torch.zeros((), dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="hits must be one int64"):
            replay(hist, x, x, it, hits=bad, **kw)
