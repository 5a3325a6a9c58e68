"""cudabrot_tpu_torch bin quantization and deposits vs the JAX package.

Bin ids and id-stream deposits agree bitwise (IEEE division; exact
integer adds commute). Jitted JAX code is compared only within stated
bounds, each with its cause: XLA's CPU backend rewrites a division by a
constant (a few points on bin edges land one bin over) and contracts
a*b+c into fused multiply-adds (replayed orbits drift in the low bits).
"""

import ctypes

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
from tests.test_torch_df32 import harness  # noqa: F401  (fixture)

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)

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


@pytest.mark.parametrize("name,k,order", [
    (n, k, o) for n in sorted(tfr.FRACTALS) for k, o in (
        (1000, "descending"), (37, "shuffled"))])
def test_header_replay_queue_bitwise(harness, name, k, order):  # noqa: F811
    """The fused f32 replay as the kernel's queue runs it (csrc/orbit.cuh
    replay_orbit, built with g++): every group of 32 emissions
    replayed for its longest orbit, only each lane's own steps recorded,
    branch-free binning. Histogram and hits bitwise equal to the plain
    version, on a batch that is not a multiple of 32 long, sorted as the
    engine compacts it or shuffled (the histogram must not depend on the
    order)."""
    canvas = Canvas(width=64, height=48, min_real=-1.7, max_real=0.6,
                    min_imag=-1.1, max_imag=1.3)
    cr, ci, it = _emissions(k, 13, max_it=90)
    if order == "shuffled":
        perm = np.random.default_rng(2).permutation(k)
        cr, ci, it = cr[perm].copy(), ci[perm].copy(), it[perm].copy()
    fr = tfr.FRACTALS[name]
    hist_p = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    hits_p = tb.replay_deposit(hist_p, torch.from_numpy(cr),
                               torch.from_numpy(ci), torch.from_numpy(it),
                               canvas=canvas, fractal=fr)
    hist = np.zeros(canvas.num_pixels, np.uint32)
    hits = ctypes.c_ulonglong(0)
    vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    harness.cbh_replay_deposit.argtypes = [i, vp, vp, vp, i, vp, f, f, f, f,
                                           i, i, i, i, vp]
    assert harness.cbh_replay_deposit(
        fr.kernel_id, cr.ctypes.data, ci.ctypes.data, it.ctypes.data, k,
        hist.ctypes.data, canvas.min_real, canvas.min_imag,
        canvas.delta_real, canvas.delta_imag, canvas.width, canvas.height,
        0, canvas.height, ctypes.addressof(hits)) == 0
    np.testing.assert_array_equal(hist.view(np.int32), hist_p.numpy())
    assert hits.value == int(hits_p) == int(hist.sum()) > 0


#: Row windows over a 29-row canvas: the whole canvas, shards of an uneven
#: split, one row, a shard past the canvas's end, an empty window.
ROW_WINDOWS = [(0, 29), (0, 8), (8, 8), (24, 8), (28, 1), (13, 3), (32, 8),
               (5, 0)]


def _window_points(canvas, row_start, row_count, seed):
    """Points on the rows row_start - 1, row_start, row_start + row_count
    - 1, row_start + row_count and height (centres and lower edges), -1
    too, and random points around the canvas; NaN and inf among them."""
    rows = [row_start - 1, row_start, row_start + row_count - 1,
            row_start + row_count, canvas.height, -1, canvas.height - 1]
    rng = np.random.default_rng(seed)
    ims, res = [], []
    for r in rows:
        for frac in (0.0, 0.5, 0.999):
            ims += [canvas.min_imag + (r + frac) * canvas.delta_imag] * 8
            res += list(rng.uniform(canvas.min_real - 0.1,
                                    canvas.max_real + 0.1, 8))
    re = np.concatenate([np.asarray(res), rng.uniform(-2.2, 2.2, 2000)])
    im = np.concatenate([np.asarray(ims), rng.uniform(-2.2, 2.2, 2000)])
    re, im = re.astype(np.float32), im.astype(np.float32)
    re[-3:] = [np.nan, np.inf, -np.inf]
    return re, im


@pytest.mark.parametrize("rows", ROW_WINDOWS)
def test_header_bin_id_row_window_bitwise(harness, rows):  # noqa: F811
    """orbit.cuh bin_id and df32.cuh bin_id_df with a row window (the four
    replay kernels' binning) against the plain sharded quantizers
    (points_to_bin_ids_sharded, _df_sharded), bitwise, at the window's
    edge rows; -1 is the plain versions' sentinel row_count * width."""
    from cudabrot_tpu_torch.ops import df32

    canvas = Canvas(**CANVASES[2])
    r0, n = rows
    re, im = _window_points(canvas, r0, n, r0 * 31 + n)
    k = re.size
    sentinel = n * canvas.width
    got = np.empty(k, np.int64)
    f, i, vp = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    harness.cbh_bin_id.argtypes = [vp, vp, i, f, f, f, f, i, i, i, i, vp]
    harness.cbh_bin_id(re.ctypes.data, im.ctypes.data, k, canvas.min_real,
                       canvas.min_imag, canvas.delta_real, canvas.delta_imag,
                       canvas.width, canvas.height, r0, n, got.ctypes.data)
    want = tb.points_to_bin_ids_sharded(
        canvas, torch.from_numpy(re), torch.from_numpy(im),
        torch.ones(k, dtype=torch.bool), r0, n).numpy()
    np.testing.assert_array_equal(np.where(got < 0, sentinel, got), want)
    inside = int(((want >= 0) & (want < sentinel)).sum())
    assert inside == 0 if n == 0 or r0 >= canvas.height else inside > 8

    rel = (re * np.float32(2.0 ** -27)).astype(np.float32)
    iml = (im * np.float32(-2.0 ** -29)).astype(np.float32)
    mr, mi = df32.from_float(canvas.min_real), df32.from_float(canvas.min_imag)
    inv = (np.float32(1.0 / canvas.delta_real),
           np.float32(1.0 / canvas.delta_imag))
    got_df = np.empty(k, np.int64)
    harness.cbh_bin_id_df.argtypes = [vp, vp, vp, vp, i,
                                      ctypes.POINTER(i), ctypes.POINTER(f),
                                      vp]
    harness.cbh_bin_id_df(
        re.ctypes.data, rel.ctypes.data, im.ctypes.data, iml.ctypes.data, k,
        (i * 4)(canvas.width, canvas.height, r0, n),
        (f * 6)(*mr, *mi, *inv), got_df.ctypes.data)
    want_df = tb.points_to_bin_ids_df_sharded(
        canvas, *(torch.from_numpy(x) for x in (re, rel, im, iml)),
        torch.ones(k, dtype=torch.bool),
        tuple(torch.tensor(v) for v in mr),
        tuple(torch.tensor(v) for v in mi), r0, n).numpy()
    np.testing.assert_array_equal(np.where(got_df < 0, sentinel, got_df),
                                  want_df)
