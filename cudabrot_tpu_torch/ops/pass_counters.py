"""The counters of a uniform pass: one kernel in place of PyTorch's sums.

Replaces no TPU kernel (the JAX engine sums its stat rows in XLA). A pass
adds to the render's int64 totals (``utils/counters.py``): the sums of
classify's five stat rows (``samples``, ``culled``, ``in_band``,
``cycles``, ``wasted``), ``iters`` = the pass's lane-steps less the
wasted sum, ``emitted`` = min(n_valid, capacity) and ``replay_dropped``
the rest, and ``points`` = the sum of ``iters + 1`` over the kept slots
with ``iters >= 0``. For CUDA tensors ``pass_counters`` launches
``csrc/classify.cu``'s ``pass_counters_kernel`` (one launch, reading
``n_valid`` on the device); for CPU tensors it runs
``pass_counters_plain``. Integer adds commute, so both give the same
bits.

Only the batch's first min(n_valid, capacity) slots are read. Both
compaction routes (``length_sort`` and ``cuda_engine.compact``) return
their kept emissions first and -1 after them, and the hybrid split's
device batch (``CudaEngine.host_pass``) only puts -1 holes into that
batch, so no slot past the prefix holds a point.
"""

from __future__ import annotations

import ctypes

import torch

from cudabrot_tpu_torch.ops import _build, launches
from cudabrot_tpu_torch.ops.classify import STAT_WASTED, STATS_ROWS

#: The totals a pass adds to, in the kernel's order (``counters.cuh``):
#: the stat rows' in classify's row order, then the derived ones.
TOTALS = ("samples", "culled", "in_band", "cycles", "wasted", "iters",
          "emitted", "replay_dropped", "points")
#: Blocks of the kernel's grid-stride loop (``counters.cuh`` kThreads
#: threads each). The kernel runs between a pass's compaction and the next
#: pass's classify, while the pass's replay fills the multiprocessors from
#: its high-priority side stream; a grid of a few blocks finds room beside
#: it. Two blocks a multiprocessor (264) had to wait for room on every one
#: of them, and zoom1e5.df32 ran 1.61e8 points/s against 2.17e8 with 16.
#: Over three seeds, 64 blocks against 16 raised hires15k.coarse by 25% but
#: cost zoom1e5.df32 7% and hires15k.medium 19%; 32 lay between (one H100
#: 80GB HBM3, 700 W).
BLOCKS = 16


def prefix_bound(n: int, n_valid: int, capacity: int) -> int:
    """The slots of an ``n``-slot batch that the counters read: its kept
    prefix, min(n_valid, capacity)."""
    return max(0, min(n_valid, capacity, n))


def _check(stats, n_valid, iters, totals):
    if stats.dtype != torch.int32 or stats.numel() % STATS_ROWS:
        raise ValueError(f"stats must be int32 rows of {STATS_ROWS} "
                         f"(got {stats.dtype}, {tuple(stats.shape)})")
    if iters is not None and iters.dtype != torch.int32:
        raise ValueError(f"iters must be int32, not {iters.dtype}")
    if n_valid.dtype != torch.int64 or n_valid.dim() != 0:
        raise ValueError("n_valid must be a 0-dim int64 tensor")
    for k in TOTALS:
        t = totals[k]
        if t.dtype != torch.int64 or t.dim() != 0:
            raise ValueError(f"total {k!r} must be a 0-dim int64 tensor")
    dev = stats.device
    ts = (n_valid, *(totals[k] for k in TOTALS))
    if any(t.device != dev for t in ts) or (
            iters is not None and iters.device != dev):
        raise ValueError("the counters' tensors lie on different devices")


def pass_counters(stats: torch.Tensor, n_valid: torch.Tensor,
                  iters: torch.Tensor | None, totals: dict, *,
                  steps_per_pass: int, capacity: int) -> None:
    """Adds a pass's counters to ``totals`` in place (0-dim int64 tensors
    under ``TOTALS``' keys). ``stats``: classify's (STATS_ROWS, ...) int32
    stat rows; ``n_valid``: the 0-dim int64 count of valid emissions;
    ``iters``: the kept batch's escape indices (None: no points counted);
    ``steps_per_pass``: the pass's lane-steps; ``capacity``: the replay
    capacity."""
    if stats.device.type == "cpu":
        pass_counters_plain(stats, n_valid, iters, totals,
                            steps_per_pass=steps_per_pass, capacity=capacity)
        return
    _check(stats, n_valid, iters, totals)
    launch(stats.contiguous(), n_valid,
           None if iters is None else iters.reshape(-1).contiguous(),
           totals, steps_per_pass, capacity)
    launches.COUNTS["pass_counters"] += 1


def launch(stats, n_valid, iters, totals, steps_per_pass: int,
           capacity: int) -> None:
    """The kernel on contiguous CUDA tensors, on the current stream."""
    lib, dev = _lib(), stats.device
    ptrs = (ctypes.c_void_p * len(TOTALS))(
        *(totals[k].data_ptr() for k in TOTALS))
    n = 0 if iters is None else iters.numel()
    with torch.cuda.device(dev):
        rc = lib.cb_pass_counters(
            stats.data_ptr(), stats.numel() // STATS_ROWS,
            None if iters is None else iters.data_ptr(), n,
            n_valid.data_ptr(), capacity,
            steps_per_pass, ptrs, BLOCKS, _build.stream_of(stats))
    _build.check(rc, "pass_counters kernel")


def pass_counters_plain(stats: torch.Tensor, n_valid: torch.Tensor,
                        iters: torch.Tensor | None, totals: dict, *,
                        steps_per_pass: int, capacity: int) -> None:
    """``pass_counters`` in plain PyTorch: the row sums, the 0-dim adds, and
    ``where(iters >= 0, iters + 1, 0).sum()`` over the kept prefix (its
    length read on the host)."""
    _check(stats, n_valid, iters, totals)
    launches.COUNTS["pass_counters_plain"] += 1
    st = stats.reshape(STATS_ROWS, -1).sum(dim=1)
    wasted = st[STAT_WASTED]
    emitted = torch.clamp(n_valid, max=capacity)
    for k, v in zip(TOTALS, (*st, steps_per_pass - wasted, emitted,
                             n_valid - emitted)):
        totals[k] += v
    if iters is not None:
        it = iters.reshape(-1)[:prefix_bound(iters.numel(), int(n_valid),
                                             capacity)]
        totals["points"] += torch.where(it >= 0, it + 1, 0).sum()


def _lib():
    lib = _build.load("classify")
    if lib.cb_pass_counters.argtypes is None:
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.cb_pass_counters.argtypes = [vp, ll, vp, ll, vp, ll, ll, vp, i,
                                         vp]
        lib.cb_pass_counters.restype = i
    return lib
