"""Row-sharded histogram engine: canvas memory and deposit work split over
the devices.

Port of ``ShardedHistogramEngine`` in
``cudabrot_tpu/parallel/sharded_hist.py`` (``:41-194``). The replicated
data-parallel engine keeps a whole histogram on every device; this one
gives device d the canvas rows [d·R, (d + 1)·R), R = ceil(height / D), so
a canvas D times larger fits:

  1. every device runs its classify kernel and compaction with its own
     RNG ordinal (``CudaEngine.classify_and_compact``), as in the
     replicated engine, and counts its own kept orbit points;
  2. the D kept batches are gathered onto every device (a concatenation
     on one card, copies between cards on several);
  3. every device replays the whole gathered batch with its shard's row
     window (the replay kernels' ``rows``), on the fused route or the
     id-stream route that ``--scatter`` names, so it deposits only the points
     on its rows.

The orbit arithmetic is repeated D times; the deposits, and the memory,
split D ways. Row windows partition the canvas, so every point is counted
exactly once and the histogram equals the replicated engine's bit for
bit for the same seeds. The gathered batch is D runs each ordered
longest first, so the replay queue no longer starts the longest orbits
first; the histogram does not depend on the order. Ordering the whole
batch again does not pay: on an H100 a pass of two shards took 22.75 ms
re-sorted against 21.67 unsorted at the default cell, 11.43 against
10.06-11.37 at the zoom cell (``chip_smoke.py`` phase 10 times both).
"""

from __future__ import annotations

import numpy as np
import torch

from cudabrot_tpu_torch.config import ConfigError, RenderConfig
from cudabrot_tpu_torch.parallel import distributed, mesh
from cudabrot_tpu_torch.parallel.data_parallel import sum_stats

#: The refusal of MH with row shards (the JAX package's message).
MH_ROWS = (
    "--sampler mh is incompatible with row-sharded histograms (MH deposits "
    "scatter into a full per-device histogram replica; MH crops are small "
    "by construction \u2014 use the replicated layout)")
#: Row shards over several processes. The JAX package's row-sharded
#: engine, the reference, cannot finish such a render: its histogram()
#: fetches a global array whose shards lie on other processes' devices
#: (cudabrot_tpu/parallel/sharded_hist.py:178), and its stats() reads one
#: the same way.
MULTI_PROCESS_ROWS = (
    "--hist-sharding rows over several processes is not supported: the JAX "
    "package's row-sharded engine, which this one follows, cannot read its "
    "histogram back across processes (cudabrot_tpu/parallel/"
    "sharded_hist.py:178). Use --hist-sharding replicated over several "
    "processes, or --hist-sharding rows in one process.")
#: --replay host with row shards: each shard replays the gathered batch
#: into its rows on its device; a host replay would accumulate a whole
#: canvas on one host, which is what the shards exist to avoid.
HOST_ROWS = ("--replay host does not apply to --hist-sharding rows (each "
             "row shard replays on its own device; use the replicated "
             "layout for host replay).")


class ShardedHistogramEngine:
    """Data-parallel sampling into a row-sharded histogram (cuda engine,
    uniform sampling, one process)."""

    def __init__(self, cfg: RenderConfig, device=None, devices=None):
        from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine

        if distributed.process_count() > 1:
            raise ConfigError(MULTI_PROCESS_ROWS)
        if cfg.options.sampler == "mh":
            raise ConfigError(MH_ROWS)
        if cfg.options.replay == "host":
            raise ConfigError(HOST_ROWS)
        if devices is None:
            devices, _, _ = mesh.local_devices(
                cfg.options.num_devices, cfg.device_index, device)
        self.cfg = cfg
        self.devices = list(devices)
        self.num_devices = len(self.devices)
        # The shards replay on their devices, as the JAX package's rows
        # engine does; so uint64 is refused there, by the JAX message.
        self.inners = [CudaEngine(cfg, device=d, replay_mode="device")
                       for d in self.devices]
        self.name = "sharded(cuda)"
        self.device = self.devices[0]
        self.steps_per_pass = self.inners[0].steps_per_pass * self.num_devices
        h = cfg.canvas.height
        self.rows_per_shard = -(-h // self.num_devices)
        self.padded_rows = self.rows_per_shard * self.num_devices

    def rows(self, d: int) -> tuple[int, int]:
        """Shard d's row window: (first row, rows)."""
        return d * self.rows_per_shard, self.rows_per_shard

    def init_state(self, hist0: np.ndarray | None) -> list:
        """One state per device, its ``hist`` its shard (R, width) and
        nothing canvas-sized on the device; a resumed histogram is split
        into the shards."""
        if hist0 is None:
            return [inner.init_state(None, rows=self.rows_per_shard)
                    for inner in self.inners]
        padded = np.zeros((self.padded_rows, self.cfg.canvas.width),
                          np.uint32)
        padded[: self.cfg.canvas.height] = np.asarray(hist0, np.uint32)
        states = []
        for d, inner in enumerate(self.inners):
            r0, n = self.rows(d)
            states.append(inner.init_state(padded[r0:r0 + n]))
        return states

    def run_pass(self, state: list, pass_index: int) -> list:
        batches = []
        for d, (inner, st) in enumerate(zip(self.inners, state)):
            batch, result, n_valid = inner.classify_and_compact(
                st, pass_index, d)
            # Each device's own kept points, before the gather, so the
            # global stat is not counted D times.
            inner.add_pass_stats(st, result, n_valid, batch[2])
            batches.append(batch)
        for d, (inner, st, dev) in enumerate(
                zip(self.inners, state, self.devices)):
            gathered = self.gather(batches, dev)
            # dev_hits counts the shard's own rows: the shards' counters
            # sum to the on-canvas total once.
            inner.replay(st, pass_index, gathered, rows=self.rows(d))
        return state

    @staticmethod
    def gather(batches, dev) -> tuple:
        """The D kept batches, concatenated on ``dev``."""
        return tuple(torch.cat([b[j].to(dev) for b in batches])
                     for j in range(3))

    def histogram(self, state: list) -> np.ndarray:
        shards = [inner.histogram(st) for inner, st in zip(self.inners, state)]
        return np.concatenate(shards)[: self.cfg.canvas.height]

    def stats(self, state: list) -> dict:
        out = sum_stats(inner.stats(st)
                        for inner, st in zip(self.inners, state))
        out["histogram_sharding"] = "rows"
        return out

    def warmup(self, state: list) -> None:
        for inner, st in zip(self.inners, state):
            inner.warmup(st)

    def synchronize(self) -> None:
        for inner in self.inners:
            inner.synchronize()

    def wait_replay(self) -> None:
        for inner in self.inners:
            inner.wait_replay()

    def memory_estimate(self) -> tuple[int, int]:
        """(device_bytes, host_bytes) of one device: its engine's estimate
        with the shard in place of the whole histogram, and the gathered
        batch (12 bytes a kept emission of every device)."""
        inner = self.inners[0]
        dev, host = inner.memory_estimate()
        cv = self.cfg.canvas
        shard = self.rows_per_shard * cv.width * 4
        gathered = self.num_devices * inner.replay_capacity * 12
        return dev - cv.num_pixels * 4 + shard + gathered, host
