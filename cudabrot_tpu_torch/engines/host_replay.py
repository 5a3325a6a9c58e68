"""Host-side orbit replay pipeline.

Port of ``cudabrot_tpu/engines/host_replay.py``. The card classifies; the
host replays. Each pass's compacted in-band emission batch is copied from
the card and fed to the native C++ replay (``io/native.py``) on a worker
thread, so the histogram accumulates on the host while the card runs the
next classify pass. ctypes releases the GIL during the native call, so the
worker overlaps the main thread's launches.

The copy never stalls the card's stream: the engine stages a pass's
fixed-size payload and its valid count into a ring of pinned host buffers
with ``non_blocking`` copies on a copy stream that waits for the
compaction, and records an event after them (``PinnedStage``). The
worker's fetch thread waits on that event, never on the device; nothing on
the main thread synchronizes. The ring has ``max_queue + 1`` slots and
``submit`` applies back-pressure at ``max_queue`` jobs in flight, so a slot
is reused only after the job that read it has finished.

Ordering: histogram addition commutes, so jobs need no ordering, and the
accumulation is deterministic for a fixed pass sequence.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import os
import time

import numpy as np
import torch

from cudabrot_tpu_torch.config import Canvas
from cudabrot_tpu_torch.io import native

#: Queued jobs before ``submit`` waits (the JAX worker's back-pressure).
MAX_QUEUE = 3


def alloc_hist(shape, dtype) -> np.ndarray:
    """Host histogram allocation with transparent-huge-page backing.

    A multi-GB histogram on 4 KiB pages misses the TLB on essentially every
    random increment, so histograms of 64 MiB and more are mapped private
    and anonymous (zero-filled) and advised MADV_HUGEPAGE; small ones are
    plain numpy allocations."""
    n = 1
    for s in shape:
        n *= int(s)
    nbytes = n * np.dtype(dtype).itemsize
    if nbytes < (64 << 20):
        return np.zeros(shape, dtype)
    import ctypes
    import mmap

    align = 2 << 20
    # MAP_PRIVATE: anonymous THP backs private mappings only.
    buf = mmap.mmap(
        -1, nbytes + align, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
    )
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    off = (-addr) % align
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.madvise(
            ctypes.c_void_p(addr + off),
            ctypes.c_size_t(nbytes),
            ctypes.c_int(14),  # MADV_HUGEPAGE
        )
    except OSError:  # pragma: no cover - madvise is advisory anyway
        pass
    return np.frombuffer(buf, dtype=dtype, count=n, offset=off).reshape(
        shape
    )


def mh_deposit_numpy(hist: np.ndarray, bins, t, rep) -> tuple[int, int]:
    """Apply MH tenure deposits to a host histogram.

    The host twin of ``ops.binning.mh_scatter``: ``bins`` int32 (V, N)
    kernel-recorded visit bins, ``t``/``rep`` int32 (N,). Returns (hits,
    deposits): the deposited mass in 1/WEIGHT_SCALE units and the
    recorded-bin count. Both compute floor(v * rep * 65536 / t) spread over
    the recorded bins by the same Bresenham, so host and device deposits
    agree exactly. As on the device, a depositable emission records at
    least one bin: where t > 1 but (t - 1) // 256 == 0 it counts one bin
    of zero mass (the JAX worker counts none there, dividing by zero)."""
    visit_slots = bins.shape[0]
    valid = np.asarray(t) > 1
    if not valid.any():
        return 0, 0
    t64 = np.asarray(t)[valid].astype(np.uint64)
    v = (t64 - 1) // 256
    rep64 = np.asarray(rep)[valid].astype(np.uint64)
    q = (v * rep64 * 65536) // t64
    n = np.maximum(np.minimum(v, np.uint64(visit_slots)), np.uint64(1))
    k = np.arange(visit_slots + 1, dtype=np.uint64)[:, None]
    kk = np.minimum(k, n[None])
    pref = (kk * q[None]) // n[None]
    d = pref[1:] - pref[:-1]
    mask = np.arange(visit_slots, dtype=np.uint64)[:, None] < n[None]
    b = np.asarray(bins)[:, valid]
    flat = hist.reshape(-1)
    np.add.at(flat, b[mask], d[mask].astype(hist.dtype))
    return int(d.sum()), int(mask.sum())


@dataclasses.dataclass
class Staged:
    """One pass's payload and its valid count on the host: CPU tensors, in
    pinned memory readable once ``event`` has completed (None: at once)."""

    event: torch.cuda.Event | None
    n_valid: torch.Tensor
    payload: torch.Tensor


class PinnedStage:
    """A ring of pinned host buffers and a copy stream for one card's
    payloads (``slots`` = the worker's ``max_queue + 1``)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring: list[Staged | None] = [None] * slots
        self.count = 0

    def stage(self, n_valid: torch.Tensor, payload: torch.Tensor) -> Staged:
        """Copy ``n_valid`` and ``payload`` into the next slot on the copy
        stream, after the work queued so far on the current stream; the
        sources are marked as used by the copy stream, so the caching
        allocator does not reuse them before the copy has run."""
        i = self.count % len(self.ring)
        self.count += 1
        buf = self.ring[i]
        if (buf is None or buf.payload.shape != payload.shape
                or buf.payload.dtype != payload.dtype):
            buf = Staged(
                torch.cuda.Event(),
                torch.empty((), dtype=n_valid.dtype, pin_memory=True),
                torch.empty(payload.shape, dtype=payload.dtype,
                            pin_memory=True))
            self.ring[i] = buf
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            buf.payload.copy_(payload, non_blocking=True)
            buf.n_valid.copy_(n_valid, non_blocking=True)
            buf.event.record(self.stream)
        payload.record_stream(self.stream)
        n_valid.record_stream(self.stream)
        return buf


def available_cores() -> int:
    """Cores this process may run on (affinity and cgroup limits seen)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


class HostReplayWorker:
    """Background worker feeding the native replay engine."""

    def __init__(
        self,
        canvas: Canvas,
        *,
        burning_ship: bool,
        num_threads: int = 0,
        dtype=np.uint32,
        grid_decode: tuple | None = None,
        mh_bins: int | None = None,
    ):
        #: Metropolis-Hastings payload mode: the number of visit-bin rows
        #: (visit_slots). Payload rows are int32 [iters, rep, t, bin_0 ..
        #: bin_{V-1}], kernel-recorded canvas bins applied with
        #: mh_deposit_numpy (no replay). None = uniform sampling.
        self.mh_bins = mh_bins
        #: MH: the bins deposit conserves tenure mass by construction, so
        #: this stays 0 (kept for the stats' mh_lost_weight).
        self.lost_weight = 0
        #: Extended-precision payload decode (center_r64, center_i64,
        #: step_r32, step_i32): payload rows carry 24-bit sample-window
        #: grid indices, rebuilt here in f64 and replayed through the
        #: native double path. None = f32 mode.
        self.grid_decode = grid_decode
        native.load()  # a missing or unbuildable library is an error here
        self.canvas = canvas
        self.burning_ship = burning_ship
        self.max_queue = MAX_QUEUE
        #: uint64 bins for extreme-duration renders (--hist-dtype); the
        #: native library has entry points for both.
        self.hist = alloc_hist(canvas.shape, dtype)
        self.hits = 0
        self.points = 0
        #: Cumulative seconds the worker spent fetching payloads (the wait
        #: for the copy and the decode) and replaying them.
        self.fetch_seconds = 0.0
        self.replay_seconds = 0.0
        cores = available_cores()
        # Resolve auto (0) threads here rather than in the native library,
        # whose hardware_concurrency() ignores affinity limits.
        self.num_threads = num_threads if num_threads > 0 else cores
        # Two stages on multi-core hosts, so fetch(p + 1) overlaps
        # replay(p); on one core they share a thread (the split would only
        # add contention).
        self._pipelined = cores > 1
        self._fetch_pool = (
            cf.ThreadPoolExecutor(max_workers=1) if self._pipelined else None
        )
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: collections.deque[cf.Future] = collections.deque()

    def make_room(self) -> None:
        """Wait until fewer than ``max_queue`` jobs are in flight. Called
        before a payload is staged: the ring slot it takes was then read by
        a job that has finished."""
        while len(self._pending) >= self.max_queue:
            self._pending.popleft().result()

    def submit(self, staged) -> None:
        """Queue one emission batch: a ``Staged`` payload, or a list of them
        (one per device of a data-parallel engine). A payload is one of: the
        (2, K) packed layout (24-bit grid index a word + the split 16-bit
        iters + 1; int32 words holding the uint32 bits), the (3, K) float32
        layout [cr; ci; iters] (grid indices in place of c at extended
        precision), or the MH int32 layout [iters; rep; t; bins]. Only
        valid columns replay."""
        self.make_room()
        if self._pipelined:
            fetched = self._fetch_pool.submit(self._fetch, staged)
            self._pending.append(self._pool.submit(self._replay, fetched))
        else:
            self._pending.append(self._pool.submit(self._job, staged))

    def _job(self, staged) -> None:
        """Single-thread path: fetch and replay chained on one worker."""
        done: cf.Future = cf.Future()
        done.set_result(self._fetch(staged))
        self._replay(done)

    def _fetch(self, staged):
        t0 = time.perf_counter()
        if isinstance(staged, Staged):
            staged = [staged]
        parts = []
        n = 0
        for s in staged:
            if s.event is not None:
                s.event.synchronize()  # the copy, not the device
            n += int(s.n_valid)
            parts.append(s.payload.numpy())
        if n <= 0:
            self.fetch_seconds += time.perf_counter() - t0
            return None
        # Several devices' payloads fold into the lane axis: replay order is
        # irrelevant (addition commutes) and invalid lanes cost nothing.
        batch = parts[0] if len(parts) == 1 else np.concatenate(parts, 1)
        if self.mh_bins is not None:
            # MH payload: int32 rows [iters, rep, t, bin_0..bin_{V-1}].
            batch = batch.astype(np.int32, copy=False)
            self.fetch_seconds += time.perf_counter() - t0
            return batch[1], batch[2], batch[3:]
        if batch.dtype == np.int32:
            # Packed layout (the words' bits): exact c reconstruction
            # (k * 2^-22 - 2 is the kernel's own sample quantization).
            w0, w1 = batch[0].view(np.uint32), batch[1].view(np.uint32)
            k_r = (w0 & 0xFFFFFF).astype(np.float32)
            k_i = (w1 & 0xFFFFFF).astype(np.float32)
            cr = k_r * np.float32(2.384185791015625e-07) - np.float32(2.0)
            ci = k_i * np.float32(2.384185791015625e-07) - np.float32(2.0)
            enc = (w0 >> 24) | ((w1 >> 24) << 8)
            iters = enc.astype(np.int32) - 1
        elif self.grid_decode is not None:
            # Extended-precision payload: 24-bit grid indices (exact in
            # f32). The f32 window offset is rebuilt as the classify kernel
            # computed it (one rounding), then added to the f64 window
            # centre: c agrees with the kernel's df32 c to ~2^-48.
            c_r64, c_i64, step_r, step_i = self.grid_decode
            batch = batch.astype(np.float32, copy=False)
            two23 = np.float32(8388608.0)
            off_r = (batch[0] - two23) * np.float32(step_r)
            off_i = (batch[1] - two23) * np.float32(step_i)
            cr = c_r64 + off_r.astype(np.float64)
            ci = c_i64 + off_i.astype(np.float64)
            iters = batch[2].astype(np.int32)
        else:
            batch = batch.astype(np.float32, copy=False)
            cr = batch[0]
            ci = batch[1]
            iters = batch[2].astype(np.int32)
        self.fetch_seconds += time.perf_counter() - t0
        return cr, ci, iters

    def _replay(self, fetched: cf.Future) -> None:
        decoded = fetched.result()
        if decoded is None:
            return
        if self.mh_bins is not None:
            reps, vks, bins = decoded
            t1 = time.perf_counter()
            hits, points = mh_deposit_numpy(self.hist, bins, vks, reps)
            self.hits += hits
            self.points += points
            self.replay_seconds += time.perf_counter() - t1
            return
        cr, ci, iters = decoded
        t1 = time.perf_counter()
        cv = self.canvas
        if cr.dtype == np.float64:
            replay = native.replay_scatter_f64
            extra = {}
        else:
            # The contraction-proof f32 orbit: the port's classify
            # trajectory bit for bit (its kernels and plain versions both
            # round every product and sum once), on the CPU and the card.
            replay = native.replay_scatter
            extra = {"strict": True}
        hits, points = replay(
            cr,
            ci,
            iters,
            self.hist,
            width=cv.width,
            height=cv.height,
            min_real=cv.min_real,
            min_imag=cv.min_imag,
            delta_real=cv.delta_real,
            delta_imag=cv.delta_imag,
            burning_ship=self.burning_ship,
            num_threads=self.num_threads,
            **extra,
        )
        self.hits += hits
        self.points += points
        self.replay_seconds += time.perf_counter() - t1

    def reset(self) -> None:
        """Drain, then zero the accumulator and the tallies (a new
        render)."""
        self.drain()
        self.hist[:] = 0
        self.hits = 0
        self.points = 0
        self.lost_weight = 0
        self.fetch_seconds = 0.0
        self.replay_seconds = 0.0

    def add_resumed(self, hist0: np.ndarray) -> None:
        """Fold a resumed checkpoint into the accumulator, guarding the
        uint64-checkpoint-into-uint32-render downcast (silent wraparound
        would corrupt hours of work)."""
        h0 = np.asarray(hist0)
        if (
            self.hist.dtype == np.uint32
            and h0.dtype == np.uint64
            and int(h0.max(initial=0)) > 0xFFFFFFFF
        ):
            raise ValueError(
                "checkpoint holds uint64 counts above the uint32 range; "
                "resume with --hist-dtype uint64"
            )
        self.hist += h0.astype(self.hist.dtype)

    def drain(self) -> None:
        """Block until all queued replays have accumulated."""
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        self.drain()
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=True)
        self._pool.shutdown(wait=True)
