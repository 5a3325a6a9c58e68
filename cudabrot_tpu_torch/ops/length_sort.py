"""The length sort: every valid emission of a pass, longest orbit first.

Replaces no TPU kernel. Where a pass's replay capacity holds every
emission slot, the JAX engine's selection (``cuda_engine.compact``: a
random key, then the length) drops nothing, and its random key decides
only the order of equal lengths, which no output reads: the histogram's
adds commute, the hybrid split and the replay queue read the lengths
alone. ``length_sort`` computes that batch directly: the valid slots
(``iters >= 0``) in descending ``iters``, equal ``iters`` in ascending slot
order, each emission's three 32-bit words as the emission buffers hold
them (grid indices at extended precision pass through), then ``iters`` =
-1 and c words 0 up to the slot count. For CUDA tensors it launches
``csrc/length_sort.cu`` (three launches, a stable counting sort on the
bucket ``max_it - 1 - iters``); for CPU tensors it runs
``length_sort_plain``. Both give the same bits.

An escape index outside the band ``[min_it, max_it)``, which classify
never emits, sorts as the nearest end of the band.
"""

from __future__ import annotations

import ctypes

import torch

from cudabrot_tpu_torch.ops import _build, launches

#: Tile sizes (log2 of the slots a block sorts): the smaller, unless its
#: tile-by-bucket counts would pass SMALL_TILE_COUNTS words (wide bands,
#: such as the deep zoom's 19,500 lengths), then the larger.
TILE_BITS = (13, 14)
SMALL_TILE_COUNTS = 1 << 22
#: Most tile-by-bucket counts a sort may take (256 MB of scratch).
MAX_COUNTS = 1 << 26


def buckets(min_it: int, max_it: int) -> int:
    """The sort's buckets: one for each escape index of the band."""
    return max(max_it - min_it, 1)


def tile_bits(n: int, nb: int) -> int | None:
    """log2 of the tile size for ``n`` slots in ``nb`` buckets, or None
    where the kernel cannot take them (over 2^31 slots, or counts past
    MAX_COUNTS)."""
    if n >= 1 << 31:
        return None
    for lb in TILE_BITS:
        counts = -(-n >> lb) * nb
        if nb < 1 << (32 - lb) and (counts <= SMALL_TILE_COUNTS
                                    or lb == TILE_BITS[-1]):
            return lb if counts <= MAX_COUNTS else None
    return None


def fits(n: int, min_it: int, max_it: int) -> bool:
    """Whether the kernel takes a pass of ``n`` emission slots in the band
    [min_it, max_it)."""
    return tile_bits(n, buckets(min_it, max_it)) is not None


def _check(emit_c: torch.Tensor, emit_it: torch.Tensor):
    if emit_c.dtype != torch.float32 or emit_it.dtype != torch.int32:
        raise ValueError("length_sort takes float32 emit_c and int32 "
                         "emit_it")
    chunks = emit_it.shape[0]
    n = emit_it.numel()
    if chunks == 0 or n == 0 or emit_c.numel() != 2 * n \
            or emit_c.shape[:2] != (chunks, 2):
        raise ValueError(f"emit_c {tuple(emit_c.shape)} is not the "
                         f"(chunks, 2, ...) words of emit_it "
                         f"{tuple(emit_it.shape)}")
    if emit_c.device != emit_it.device:
        raise ValueError("emit_c and emit_it lie on different devices")
    return n, n // chunks


def length_sort(emit_c: torch.Tensor, emit_it: torch.Tensor, min_it: int,
                max_it: int):
    """Every valid emission, by descending length then slot: ``(cr, ci,
    iters, n_valid)``, each of the slot count (``iters`` -1 and c 0 past
    the valid ones), and the 0-dim int64 count of valid emissions.
    ``emit_c``: (chunks, 2, R, 128) float32; ``emit_it``: (chunks, R, 128)
    int32, -1 on an empty slot."""
    n, _ = _check(emit_c, emit_it)
    if emit_it.device.type == "cpu":
        return length_sort_plain(emit_c, emit_it, min_it, max_it)
    lb = tile_bits(n, buckets(min_it, max_it))
    if lb is None:
        raise ValueError(f"length_sort takes no {n} slots in the band "
                         f"[{min_it}, {max_it})")
    out = launch(emit_c.contiguous(), emit_it.contiguous(), min_it, max_it,
                 lb)
    launches.COUNTS["length_sort"] += 1
    return out


def launch(emit_c, emit_it, min_it: int, max_it: int, lb: int):
    """The three kernels on contiguous CUDA buffers with tiles of 2^lb
    slots (5 <= lb <= 14), their scratch allocated as the library lays it
    out."""
    lib, dev = _lib(), emit_it.device
    n, nb = emit_it.numel(), buckets(min_it, max_it)
    scratch = torch.empty(lib.cb_length_sort_words(n, nb, lb),
                          dtype=torch.int32, device=dev)
    out = torch.empty((3, n), dtype=torch.int32, device=dev)
    n_valid = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cb_length_sort(
            emit_c.data_ptr(), emit_it.data_ptr(), n, n // emit_it.shape[0],
            max_it, nb, lb, scratch.data_ptr(), out.data_ptr(),
            n_valid.data_ptr(), _build.stream_of(emit_it))
    _build.check(rc, "length_sort kernels")
    return (out[0].view(torch.float32), out[1].view(torch.float32), out[2],
            n_valid)


def length_sort_plain(emit_c: torch.Tensor, emit_it: torch.Tensor,
                      min_it: int, max_it: int):
    """``length_sort`` in plain PyTorch: the valid slots in slot order, a
    stable sort of their buckets, and gathers."""
    n, _ = _check(emit_c, emit_it)
    launches.COUNTS["length_sort_plain"] += 1
    it = emit_it.reshape(-1)
    idx = torch.nonzero(it >= 0).reshape(-1)
    nb = buckets(min_it, max_it)
    d = torch.clamp((max_it - 1) - it[idx], 0, nb - 1)
    take = idx[torch.sort(d, stable=True).indices]
    k = take.numel()
    out_c = torch.zeros((2, n), dtype=torch.float32, device=it.device)
    out_c[:, :k] = emit_c.transpose(0, 1).reshape(2, -1)[:, take]
    out_it = torch.full((n,), -1, dtype=torch.int32, device=it.device)
    out_it[:k] = it[take]
    return out_c[0], out_c[1], out_it, torch.tensor(k, dtype=torch.int64,
                                                     device=it.device)


def _lib():
    lib = _build.load("length_sort")
    if lib.cb_length_sort.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cb_length_sort.argtypes = [vp, vp, i, i, i, i, i, vp, vp, vp, vp]
        lib.cb_length_sort.restype = i
        lib.cb_length_sort_words.argtypes = [i, i, i]
        lib.cb_length_sort_words.restype = ctypes.c_longlong
    return lib
