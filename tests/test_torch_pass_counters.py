"""The pass counters (``cudabrot_tpu_torch/ops/pass_counters.py``) on the
CPU.

The plain version against the expression the engine ran before it (the
stat rows' sums, the 0-dim adds and the points over the whole batch), bit
for bit: on both compaction routes' own batches and on the hybrid split's
batch with -1 holes, each read up to its kept prefix. The g++ build of the
kernel's per-thread sums (``csrc/counters.cuh`` through
``host_harness.cpp``) against the plain version, bitwise, over grids of
one to a few blocks, unaligned views, ragged rows, an empty batch, no
batch, dropped emissions and totals past 2^32.
"""

import ctypes

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch.engines.cuda_engine import compact
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.ops import launches, prng
from cudabrot_tpu_torch.ops import length_sort as ls
from cudabrot_tpu_torch.ops import pass_counters as pc
from cudabrot_tpu_torch.utils import counters
from tests.test_torch_df32 import harness  # noqa: F401  (fixture)

torch.set_num_threads(1)

STEPS = 4096 * 256


def _totals(start=0):
    tot = counters.zeros("cpu")
    for i, k in enumerate(pc.TOTALS):
        tot[k] += start + 7919 * i
    return {k: tot[k] for k in pc.TOTALS}


def _values(tot):
    return [int(tot[k]) for k in pc.TOTALS]


def _old_expression(state, stats, n_valid, iters, steps, capacity):
    """The engine's counters as it added them before the kernel."""
    st = stats.reshape(cls.STATS_ROWS, -1).sum(dim=1)
    wasted = st[cls.STAT_WASTED]
    emitted = torch.clamp(n_valid, max=capacity)
    for k, v in (
        ("samples", st[cls.STAT_DRAWN]),
        ("culled", st[cls.STAT_CULLED]),
        ("in_band", st[cls.STAT_IN_BAND]),
        ("cycles", st[cls.STAT_CYCLES]),
        ("wasted", wasted),
        ("iters", steps - wasted),
        ("emitted", emitted),
        ("replay_dropped", n_valid - emitted),
    ):
        state[k] += v
    if iters is not None:
        state["points"] += torch.where(iters >= 0, iters + 1, 0).sum()


def _stats(width, seed, high=1 << 12):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, (cls.STATS_ROWS, width), generator=g,
                         dtype=torch.int32)


def _emissions(chunks, share, seed, band=(20, 100)):
    rng = np.random.default_rng(seed)
    it = rng.integers(*band, (chunks, 2, 128)).astype(np.int32)
    it[rng.random(it.shape) >= share] = -1
    c = rng.uniform(-2, 2, (chunks, 2, 2, 128)).astype(np.float32)
    return torch.from_numpy(c), torch.from_numpy(it)


def _route_batch(route, capacity, seed):
    """A compaction route's own batch of 16 windows of 256 lanes: the kept
    escape indices first, -1 after them."""
    c, it = _emissions(16, 0.4, seed)
    if route == "length":
        _, _, kept, n_valid = ls.length_sort_plain(c, it, 20, 100)
    else:
        _, _, kept, n_valid = compact(c, it, prng.key(seed), capacity, 100)
    return kept, n_valid


@pytest.mark.parametrize("route,capacity", [("length", 4096),
                                            ("select", 4096),
                                            ("select", 512)],
                         ids=["length", "select", "select-dropping"])
def test_plain_prefix_equals_the_old_expression(route, capacity):
    """The compaction's own batch read up to min(n_valid, capacity) adds
    what the old expression added reading it whole, where the capacity
    drops emissions too."""
    iters, n_valid = _route_batch(route, capacity, seed=capacity)
    k = pc.prefix_bound(iters.numel(), int(n_valid), capacity)
    assert (iters[:k] >= 0).all() and (iters[k:] == -1).all()
    stats = _stats(512, seed=1)
    want, got = _totals(), _totals()
    _old_expression(want, stats, n_valid, iters, STEPS, capacity)
    launches.reset()
    pc.pass_counters(stats, n_valid, iters, got, steps_per_pass=STEPS,
                     capacity=capacity)
    assert launches.COUNTS["pass_counters_plain"] == 1
    assert _values(got) == _values(want)
    if capacity < 4096:
        assert int(got["replay_dropped"]) > int(_totals()["replay_dropped"])


def test_plain_prefix_counts_the_split_batch_with_holes():
    """The hybrid split's device batch (``CudaEngine.host_pass``: -1 where
    the host's orbits were, valid slots after them) holds no point past
    its kept prefix, so reading that prefix adds what the old expression
    added reading it whole."""
    iters, n_valid = _route_batch("length", 4096, seed=3)
    pos = torch.arange(iters.numel())
    holes = torch.where((iters < 60) | (pos >= 700), iters, -1)
    k = pc.prefix_bound(holes.numel(), int(n_valid), 4096)
    assert (holes[:700] == -1).any() and (holes[700:k] >= 0).any()
    assert (holes[k:] == -1).all()
    stats = _stats(512, seed=2)
    want, got = _totals(), _totals()
    _old_expression(want, stats, n_valid, holes, STEPS, 4096)
    launches.reset()
    pc.pass_counters(stats, n_valid, holes, got, steps_per_pass=STEPS,
                     capacity=4096)
    assert launches.COUNTS["pass_counters_plain"] == 1
    assert _values(got) == _values(want)


def test_plain_without_a_batch_counts_no_points():
    stats = _stats(256, seed=4)
    n_valid = torch.tensor(9, dtype=torch.int64)
    want, got = _totals(), _totals()
    _old_expression(want, stats, n_valid, None, STEPS, 4)
    pc.pass_counters_plain(stats, n_valid, None, got, steps_per_pass=STEPS,
                           capacity=4)
    assert _values(got) == _values(want)
    assert int(got["replay_dropped"]) - int(_totals()["replay_dropped"]) == 5


def test_refusals():
    stats, n_valid = _stats(128, seed=5), torch.tensor(0, dtype=torch.int64)
    kw = dict(steps_per_pass=1, capacity=1)
    with pytest.raises(ValueError, match="iters must be int32"):
        pc.pass_counters(stats, n_valid, torch.zeros(4, dtype=torch.int64),
                         _totals(), **kw)
    with pytest.raises(ValueError, match="int32 rows of 5"):
        pc.pass_counters(stats[:4], n_valid, None, _totals(), **kw)
    with pytest.raises(ValueError, match="0-dim int64"):
        pc.pass_counters(stats, n_valid.to(torch.int32), None, _totals(),
                         **kw)
    bad = _totals()
    bad["points"] = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="'points'"):
        pc.pass_counters(stats, n_valid, None, bad, **kw)


def _harness_counters(lib, stats, n_valid, iters, tot, steps, capacity,
                      blocks):
    vp = ctypes.c_void_p
    lib.cbh_pass_counters.argtypes = [vp, ctypes.c_longlong, vp,
                                      ctypes.c_longlong, vp,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      vp, ctypes.c_int]
    ptrs = (vp * len(pc.TOTALS))(*(tot[k].data_ptr() for k in pc.TOTALS))
    n = 0 if iters is None else iters.numel()
    rc = lib.cbh_pass_counters(
        stats.data_ptr(), stats.numel() // cls.STATS_ROWS,
        None if iters is None else iters.data_ptr(), n, n_valid.data_ptr(),
        capacity, steps, ptrs, blocks)
    assert rc == 0


#: (stats width, offset of the stats' view, batch, its view's offset,
#: capacity, extra n_valid, blocks, large totals).
HARNESS_CASES = {
    "prefix": (1024, 0, "length", 0, 4096, 0, 2, False),
    "prefix-unaligned": (1021, 1, "length", 3, 4096, 0, 3, False),
    "select-dropping": (512, 2, "select", 1, 512, 0, 1, False),
    "holes": (777, 3, "holes", 2, 4096, 0, 2, False),
    "over-capacity": (256, 0, "length", 0, 300, 5000, 2, False),
    "no-batch": (640, 1, None, 0, 4096, 0, 2, False),
    "empty-batch": (640, 0, "empty", 0, 4096, 0, 1, False),
    "tiny": (3, 1, "tiny", 1, 4096, 0, 4, False),
    "past-2^32": (1 << 14, 0, "length", 0, 4096, 0, 2, True),
}


@pytest.mark.parametrize("case", sorted(HARNESS_CASES))
def test_host_harness_matches_plain(harness, case):  # noqa: F811
    """The kernel's per-thread shares (head words to the 16-byte boundary,
    4-word vectors, tail words), its block sums and its adds, run for every
    thread of the grid on the CPU, equal the plain version bitwise."""
    (width, s_off, kind, b_off, capacity, extra, blocks,
     large) = HARNESS_CASES[case]
    high = (1 << 31) - 1 if large else 1 << 12
    g = torch.Generator().manual_seed(width)
    flat = torch.randint(0, high, (cls.STATS_ROWS * width + s_off,),
                         generator=g, dtype=torch.int32)
    stats = flat[s_off:].view(cls.STATS_ROWS, width)
    n_valid = torch.tensor(0, dtype=torch.int64)
    iters = None
    if kind in ("length", "select", "holes"):
        it, n_valid = _route_batch("select" if kind == "select" else "length",
                                   capacity, seed=width)
        if kind == "holes":
            it = torch.where(it % 3 == 0, -1, it)
        iters = torch.cat([torch.full((b_off,), 7, dtype=torch.int32),
                           it])[b_off:]
        if large:
            iters = torch.where(iters >= 0, (1 << 31) - 1 - iters, -1)
    elif kind == "empty":
        iters = torch.zeros(0, dtype=torch.int32)
    elif kind == "tiny":
        iters = torch.tensor([5, 9, -1, 3, -1, 2], dtype=torch.int32)[b_off:]
        n_valid = torch.tensor(iters.numel(), dtype=torch.int64)
    n_valid = n_valid + extra
    start = 1 << 33 if large else 0
    want, got = _totals(start), _totals(start)
    pc.pass_counters_plain(stats, n_valid, iters, want, steps_per_pass=STEPS,
                           capacity=capacity)
    _harness_counters(harness, stats, n_valid, iters, got, STEPS, capacity,
                      blocks)
    assert _values(got) == _values(want)
    if large:
        assert int(want["samples"]) - start > 1 << 32
        assert int(want["points"]) - start - 7919 * 8 > 1 << 32
