"""cudabrot_tpu_torch bin quantization and deposits vs the JAX package.

Bin ids and id-stream deposits agree bitwise (IEEE division; exact
integer adds commute). Jitted JAX code is compared only within stated
bounds, each with its cause: XLA's CPU backend rewrites a division by a
constant (a few points on bin edges land one bin over) and contracts
a*b+c into fused multiply-adds (replayed orbits drift in the low bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.config import Canvas as JCanvas
from cudabrot_tpu.engines.pallas_engine import _blocked_replay
from cudabrot_tpu.models import fractals as jfr
from cudabrot_tpu.ops import binning as jb
from cudabrot_tpu_torch.config import Canvas
from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import binning as tb
from cudabrot_tpu_torch.ops import launches

CANVASES = [
    dict(width=1000, height=1000),
    dict(width=64, height=48, min_real=-1.7, max_real=0.6, min_imag=-1.1,
         max_imag=1.3),
    dict(width=37, height=29, min_real=-2.0, max_real=1.0, min_imag=-1.3,
         max_imag=1.1),
]


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    re = rng.uniform(-2.2, 2.2, n).astype(np.float32)
    im = rng.uniform(-2.2, 2.2, n).astype(np.float32)
    re[:5] = [np.nan, np.inf, -np.inf, 1e30, -2.0]
    valid = rng.uniform(size=n) < 0.9
    return re, im, valid


@pytest.mark.parametrize("cv", CANVASES)
def test_points_to_bin_ids_matches_jax(cv):
    re, im, valid = _points(1 << 20)
    ref = jb.points_to_bin_ids(JCanvas(**cv), jnp.asarray(re), jnp.asarray(im),
                               jnp.asarray(valid))
    got = tb.points_to_bin_ids(Canvas(**cv), torch.from_numpy(re),
                               torch.from_numpy(im), torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_points_to_bin_ids_jit_edge_bound():
    """Jitted, XLA's CPU backend divides by the constant pitch with a
    rewrite that rounds differently on bin edges. The port keeps IEEE
    division (the reference's C `/`). Bound: at most 1e-4 of the points
    differ, each by one row or one column (measured 10 of 2^20 at 1000^2).
    """
    cv = dict(width=1000, height=1000)
    re, im, valid = _points(1 << 20, seed=3)
    fn = jax.jit(lambda a, b, v: jb.points_to_bin_ids(JCanvas(**cv), a, b, v))
    ref = np.asarray(fn(jnp.asarray(re), jnp.asarray(im), jnp.asarray(valid)))
    got = tb.points_to_bin_ids(Canvas(**cv), torch.from_numpy(re),
                               torch.from_numpy(im),
                               torch.from_numpy(valid)).numpy()
    diff = np.flatnonzero(ref != got)
    assert diff.size <= 1e-4 * re.size, diff.size
    n = 1000 * 1000
    for a, b in zip(ref[diff], got[diff]):
        assert a < n and b < n  # never on/off canvas, only the neighbour
        dr, dc = abs(a // 1000 - b // 1000), abs(a % 1000 - b % 1000)
        assert dr + dc == 1, (a, b)


@pytest.mark.parametrize("nbins", [1, 97, 64 * 48, 1000 * 1000])
def test_deposit_ids_matches_scatter_xla(nbins):
    rng = np.random.default_rng(nbins)
    ids = rng.integers(0, nbins + 1, 50_000).astype(np.int32)  # + sentinel
    hist0 = rng.integers(0, 2**32, nbins, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jb.scatter_xla(jnp.asarray(hist0), jnp.asarray(ids)))
    hist = torch.from_numpy(hist0.view(np.int32).copy())
    launches.reset()
    out = tb.deposit_ids(hist, torch.from_numpy(ids))
    assert out is hist
    assert launches.COUNTS["deposit_ids_plain"] == 1
    assert launches.COUNTS["deposit_ids"] == 0  # CPU tensors: plain only
    np.testing.assert_array_equal(hist.numpy().view(np.uint32), ref)


def _emissions(k, seed, max_it=60):
    rng = np.random.default_rng(seed)
    cr = rng.uniform(-2.0, 1.0, k).astype(np.float32)
    ci = rng.uniform(-1.5, 1.5, k).astype(np.float32)
    it = rng.integers(0, max_it, size=k).astype(np.int32)
    it[rng.uniform(size=k) < 0.3] = -1  # inactive slots
    return cr, ci, np.sort(it)[::-1].copy()  # descending, as compacted


def test_replay_deposit_plain_accounting():
    """Hits equal the histogram mass; an inactive slot deposits nothing;
    an active one records iters + 1 points (off-canvas ones dropped)."""
    canvas = Canvas(width=64, height=48)
    fr = tfr.FRACTALS["buddhabrot"]
    cr, ci, it = _emissions(2048, 5)
    hist = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    hits = tb.replay_deposit(hist, torch.from_numpy(cr), torch.from_numpy(ci),
                             torch.from_numpy(it), canvas=canvas, fractal=fr)
    assert int(hits) == int(hist.sum()) > 0
    assert int(hits) <= int((it[it >= 0] + 1).sum())
    # A point c = 0 stays at 0: iters + 1 on-canvas deposits in one bin.
    one = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.float32)
    hits = tb.replay_deposit(one, z, z, torch.tensor([9, -1], dtype=torch.int32),
                             canvas=canvas, fractal=fr)
    assert int(hits) == 10 and int(one.max()) == 10


@pytest.mark.parametrize("name", sorted(tfr.FRACTALS))
def test_replay_deposit_matches_jax_replay(name):
    """The fused replay-deposit's plain version against the JAX device
    replay (_blocked_replay, XLA scatter) on one emission batch. XLA's CPU
    backend contracts the jitted orbit update into fused multiply-adds, so
    chaotic orbits drift apart in the low bits and a few points land in
    other bins. Bound: histogram mass within 0.5% and at most 5% of the
    mass in differing bins (measured: 0 and 0 for buddhabrot and
    anti-buddhabrot, 0.14% and 2.5% for burning-ship)."""
    cv = dict(width=64, height=48)
    cr, ci, it = _emissions(1024, 11)
    ref, ref_hits = _blocked_replay(
        jnp.zeros(64 * 48, jnp.uint32), jnp.asarray(cr), jnp.asarray(ci),
        jnp.asarray(it), fractal=jfr.FRACTALS[name], canvas=JCanvas(**cv),
        chunk=32, block=256, backend="xla",
    )
    ref = np.asarray(ref).astype(np.int64)
    hist = torch.zeros(64 * 48, dtype=torch.int32)
    hits = tb.replay_deposit(hist, torch.from_numpy(cr), torch.from_numpy(ci),
                             torch.from_numpy(it), canvas=Canvas(**cv),
                             fractal=tfr.FRACTALS[name])
    got = hist.numpy().astype(np.int64)
    assert int(hits) == got.sum()
    ref_total = int(ref_hits[0]) + (int(ref_hits[1]) << 32)
    assert ref_total == ref.sum()
    assert abs(got.sum() - ref.sum()) <= 0.005 * ref.sum()
    assert np.abs(got - ref).sum() <= 0.05 * ref.sum()
