"""The length sort (``cudabrot_tpu_torch/ops/length_sort.py``) on the CPU.

Its plain version against ``compact`` (the JAX selection, held to the JAX
engine by ``test_torch_engine.test_compaction_matches_jax``) on the same
emission buffers where the capacity holds every slot: the same count and
the same kept (cr, ci, iters) words, bit for bit, now ordered by
descending length and then slot, with -1 after them. The g++ build of the
kernels' tile logic (``csrc/length_sort.cuh`` through ``host_harness.cpp``)
against the plain version, bitwise, over small tiles: ragged last tiles,
tiles without a valid slot, one digit of buckets and the deep zoom's
19,500.
"""

import ctypes

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch.engines.cuda_engine import compact
from cudabrot_tpu_torch.ops import launches
from cudabrot_tpu_torch.ops import length_sort as ls
from tests.test_torch_df32 import harness  # noqa: F401  (fixture)

torch.set_num_threads(1)

#: (min_it, max_it): the default cell's band and the deep zoom's.
BANDS = {"narrow": (20, 100), "wide": (500, 20000)}


def _buffers(chunks, rows, band, share, seed, words=False):
    """Emission buffers of ``chunks`` flush windows of ``rows`` x 128
    lanes: escape indices in the band on a ``share`` of the slots, -1
    elsewhere; c uniform in [-2, 2), or any 32-bit words (NaNs too)."""
    rng = np.random.default_rng(seed)
    it = rng.integers(band[0], band[1], (chunks, rows, 128)).astype(np.int32)
    it[rng.random(it.shape) >= share] = -1
    if words:
        c = rng.integers(-2**31, 2**31, (chunks, 2, rows, 128),
                         dtype=np.int64).astype(np.int32).view(np.float32)
    else:
        c = rng.uniform(-2, 2, (chunks, 2, rows, 128)).astype(np.float32)
    return torch.from_numpy(c), torch.from_numpy(it)


def _triples(cr, ci, it):
    rows = np.stack([cr.numpy().view(np.int32), ci.numpy().view(np.int32),
                     it.numpy()])
    return rows[:, np.lexsort(rows[::-1])]


def _assert_length_order(it, n_valid):
    """Non-increasing ``iters`` over the first ``n_valid`` slots, -1
    after."""
    head = it[:n_valid].numpy()
    assert (head >= 0).all() and (np.diff(head) <= 0).all()
    assert (it[n_valid:] == -1).all()


@pytest.mark.parametrize("extra", [0, 1000], ids=["capacity=slots",
                                                  "capacity>slots"])
@pytest.mark.parametrize("share", [0.0, 0.05, 0.45, 1.0])
@pytest.mark.parametrize("band", list(BANDS))
def test_length_sort_keeps_what_compact_keeps(band, share, extra):
    lo, hi = BANDS[band]
    c, it = _buffers(8, 2, (lo, hi), share, seed=int(share * 100) + extra)
    n = it.numel()
    launches.reset()
    cr, ci, itk, n_valid = ls.length_sort(c, it, lo, hi)
    assert launches.COUNTS["length_sort_plain"] == 1
    want = compact(c, it, (7, 11), n + extra, hi)
    assert int(n_valid) == int(want[3]) == int((it >= 0).sum())
    assert n_valid.dtype == torch.int64 and n_valid.dim() == 0
    for got, ref in zip((cr, ci, itk), want[:3]):
        assert got.shape == ref.shape == (n,) and got.dtype == ref.dtype
    k = int(n_valid)
    np.testing.assert_array_equal(
        _triples(cr[:k], ci[:k], itk[:k]),
        _triples(want[0][:k], want[1][:k], want[2][:k]))
    _assert_length_order(itk, k)
    assert (want[2][k:] == -1).all()
    # Equal lengths keep the slots' order: each c is its slot's.
    slot_of = {(int(a), int(b)): s for s, (a, b) in enumerate(zip(
        c[:, 0].reshape(-1).view(torch.int32),
        c[:, 1].reshape(-1).view(torch.int32)))}
    slots = np.array([slot_of[(int(a), int(b))] for a, b in zip(
        cr[:k].view(torch.int32), ci[:k].view(torch.int32))])
    same = itk[:k].numpy()[1:] == itk[:k].numpy()[:-1]
    assert (np.diff(slots)[same] > 0).all()
    assert not cr[k:].view(torch.int32).any()
    assert not ci[k:].view(torch.int32).any()


def test_length_sort_clamps_indices_outside_the_band():
    """An escape index past either end of the band sorts at that end, its
    words kept as they are."""
    it = torch.full((1, 1, 128), -1, dtype=torch.int32)
    it[0, 0, :6] = torch.tensor([25, 5, 30, 200, 24, 100], dtype=torch.int32)
    c = torch.arange(256, dtype=torch.float32).reshape(1, 2, 1, 128)
    _, _, itk, n_valid = ls.length_sort_plain(c, it, 20, 30)
    assert int(n_valid) == 6
    assert itk[:6].tolist() == [30, 200, 100, 25, 24, 5]


def test_tile_bits_by_band_and_slots():
    # canvas1k.default, hires15k.coarse and zoom1e5.df32's plans.
    assert ls.tile_bits(1 << 23, 80) == 13
    assert ls.tile_bits(1 << 23, 480) == 13
    assert ls.tile_bits(1 << 21, 19500) == 14
    assert ls.tile_bits(1 << 23, 1 << 18) is None  # past MAX_COUNTS
    assert ls.tile_bits(1 << 31, 80) is None
    assert ls.fits(4096, 20, 100) and not ls.fits(1 << 23, 0, 1 << 19)
    with pytest.raises(ValueError, match="float32 emit_c"):
        ls.length_sort(torch.zeros(1, 2, 1, 128, dtype=torch.float64),
                       torch.zeros(1, 1, 128, dtype=torch.int32), 0, 10)
    with pytest.raises(ValueError, match="words of emit_it"):
        ls.length_sort(torch.zeros(2, 2, 1, 128),
                       torch.zeros(1, 1, 128, dtype=torch.int32), 0, 10)


def _harness_sort(lib, c, it, lo, hi, lb):
    n = it.numel()
    nb = ls.buckets(lo, hi)
    scratch = np.full(lib.cbh_length_sort_words(n, nb, lb), -7, np.int32)
    out = np.full((3, n), -9, np.int32)
    n_valid = np.zeros(1, np.int64)
    vp = ctypes.c_void_p
    rc = lib.cbh_length_sort(
        vp(c.numpy().ctypes.data), vp(it.numpy().ctypes.data), n,
        it.shape[1] * it.shape[2], hi, nb, lb, vp(scratch.ctypes.data),
        vp(out.ctypes.data), vp(n_valid.ctypes.data))
    assert rc == 0
    return out, int(n_valid[0])


@pytest.mark.parametrize("lb", [5, 7, 13])
@pytest.mark.parametrize("case", ["narrow", "wide", "empty_tiles", "full",
                                  "none"])
def test_host_harness_matches_plain(harness, case, lb):  # noqa: F811
    """The three kernels' tile logic on the CPU equals the plain version
    bitwise: the tiles' keys (the last warp's first) through the bitonic
    network pair by pair, the offsets blocks in ticket order, in the
    default cell's narrow band and the deep zoom's wide one; slots of 11
    windows of 256 lanes (a ragged last tile at 2^7 and 2^13 slots)."""
    harness.cbh_length_sort_words.restype = ctypes.c_longlong
    band = BANDS["wide" if case == "wide" else "narrow"]
    share = {"full": 1.0, "none": 0.0}.get(case, 0.3)
    c, it = _buffers(11, 2, band, share, seed=lb, words=True)
    if case == "empty_tiles":
        it.view(-1)[300:1500] = -1  # whole tiles of 2^5 and 2^7 slots
    out, n_valid = _harness_sort(harness, c, it, *band, lb)
    cr, ci, itk, k = ls.length_sort_plain(c, it, *band)
    assert n_valid == int(k)
    np.testing.assert_array_equal(out[0], cr.numpy().view(np.int32))
    np.testing.assert_array_equal(out[1], ci.numpy().view(np.int32))
    np.testing.assert_array_equal(out[2], itk.numpy())
