"""Data-parallel engine: one inner engine per device, histograms merged at
readback.

Port of ``DataParallelEngine`` in ``cudabrot_tpu/parallel/data_parallel.py``
(``:30-212``). The reference has no multi-device story (``-d`` selects one
GPU, cudabrot.cu:155). Here every device runs the same pass with its own
RNG ordinal (``pass_key(seed, ordinal, pass)``), each accumulates into its
own full histogram replica, and the replicas are summed once at readback:
communication is O(image) per readback, none inside a pass, so the
throughput scales with the devices.

Where the JAX package stacks the per-device states along a leading axis
and runs them under ``shard_map``, this engine keeps one ``CudaEngine`` (or
``OracleEngine``) per ``torch.device``, each with its own state dict and,
on the card, its own replay side streams; the engine's state is the list
of them. ``run_pass`` issues every device's pass in turn without a host
synchronization between devices, so several cards overlap. An id-stream
route reads its id count back once a pass (``binning._replay_groups``):
there the devices' passes run one after another.

In a multi-process run (``parallel.distributed``) each process holds its
share of the devices; ``histogram`` and ``stats`` are collective: every
process calls them at every readback.
"""

from __future__ import annotations

import numpy as np

from cudabrot_tpu_torch.config import RenderConfig
from cudabrot_tpu_torch.parallel import distributed, mesh
from cudabrot_tpu_torch.utils import trace

#: Stats that describe the render rather than count it: taken once, not
#: summed over devices.
NOT_SUMMED = ("weight_scale",)


def sum_stats(per_device) -> dict:
    """Stats of several devices' engines: counts summed exactly on the
    host, then over processes; strings and ``NOT_SUMMED`` taken as they
    are."""
    totals: dict[str, int] = {}
    extras: dict = {}
    for stats in per_device:
        for k, v in stats.items():
            if isinstance(v, str) or k in NOT_SUMMED:
                extras[k] = v
            else:
                totals[k] = totals.get(k, 0) + int(v)
    if distributed.process_count() > 1:
        keys = sorted(totals)
        rows = distributed.allgather_ints([totals[k] for k in keys])
        totals = {k: int(v) for k, v in zip(keys, rows.sum(axis=0))}
    return {**totals, **extras}


class DataParallelEngine:
    """Runs one single-device engine on every device of this process."""

    def __init__(self, cfg: RenderConfig, device=None, devices=None):
        """``devices``: an explicit list of this process's devices (several
        may be the same card, which then holds several engines); by default
        ``mesh.local_devices`` of ``--devices`` and ``-d``, or CPU devices
        with ``device="cpu"``."""
        self.cfg = cfg
        if devices is None:
            devices, first, total = mesh.local_devices(
                cfg.options.num_devices, cfg.device_index, device)
        else:
            first = distributed.process_index() * len(devices)
            total = distributed.process_count() * len(devices)
        self.devices = list(devices)
        #: The global RNG ordinal of this process's first device.
        self.first_ordinal = first
        #: Devices over all processes.
        self.num_devices = total
        self.inners = self._make_inners()
        inner = self.inners[0]
        self.name = f"dp({inner.name})"
        self.device = self.devices[0]
        self.steps_per_pass = inner.steps_per_pass * total

    def _make_inners(self) -> list:
        """One single-device engine a device."""
        from cudabrot_tpu_torch import engines

        return [engines.single_engine(self.cfg, d) for d in self.devices]

    def ordinals(self) -> range:
        """The global RNG ordinals of this process's devices."""
        return range(self.first_ordinal,
                     self.first_ordinal + len(self.devices))

    def init_state(self, hist0: np.ndarray | None) -> list:
        """One state per device. On a resume the loaded histogram becomes
        the replica of global ordinal 0 (held by the primary process), so
        the sum over replicas counts it once."""
        return [inner.init_state(hist0 if ordinal == 0 else None)
                for inner, ordinal in zip(self.inners, self.ordinals())]

    def run_pass(self, state: list, pass_index: int) -> list:
        for inner, st, ordinal in zip(self.inners, state, self.ordinals()):
            with trace.span("cb.replica", device=inner.device,
                            ordinal=ordinal):
                inner.core(st, pass_index, ordinal)
        return state

    def histogram(self, state: list) -> np.ndarray:
        """The uint32 sum of the replicas (wrapping, as the JAX package's
        ``jnp.sum(dtype=uint32)``), over every process. Each inner
        ``histogram`` first deposits its MH chains' unfinished tenures
        (``CudaEngine.mh_tail_core``), the JAX engine's
        ``_flush_mh_tails``. Collective."""
        total = np.zeros(self.cfg.canvas.shape, np.uint32)
        for inner, st in zip(self.inners, state):
            total += inner.histogram(st)
        return distributed.allgather_sum_u32(total)

    def stats(self, state: list) -> dict:
        """Every device's stats summed exactly, over every process.
        Collective."""
        return sum_stats(inner.stats(st)
                         for inner, st in zip(self.inners, state))

    def warmup(self, state: list) -> None:
        for inner, st in zip(self.inners, state):
            inner.warmup(st)

    def synchronize(self) -> None:
        for inner in self.inners:
            inner.synchronize()

    def wait_replay(self) -> None:
        for inner in self.inners:
            getattr(inner, "wait_replay", lambda: None)()

    def memory_estimate(self) -> tuple[int, int]:
        """(device_bytes, host_bytes) of one device's engine."""
        return self.inners[0].memory_estimate()


class DataParallelHostReplayEngine(DataParallelEngine):
    """Classify on every device, replay on this process's host.

    Port of ``DataParallelHostReplayEngine`` in
    ``cudabrot_tpu/parallel/data_parallel.py`` (``:215-388``). Every device
    runs its own ``CudaEngine`` in host mode at its own RNG ordinal
    (``host_pass``), and each pass's payloads, one a device, go to one
    ``HostReplayWorker`` shared by this process's engines, which replays
    them as one batch. A hybrid device share replays into each device's
    own histogram and ``dev_hits``, summed at readback. Across processes
    each process feeds its own worker, and the accumulators and tallies
    merge once per readback (``distributed.allgather_sum``, in the
    histogram's dtype: a uint64 render does not wrap there, where the JAX
    engine sums in uint32). ``histogram`` and ``stats`` are collective."""

    def __init__(self, cfg: RenderConfig, device=None, devices=None):
        super().__init__(cfg, device=device, devices=devices)
        self.name = f"dp-host({self.inners[0].name})"

    def _make_inners(self) -> list:
        from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine

        first = CudaEngine(self.cfg, device=self.devices[0],
                           replay_mode="host")
        #: The worker every device's payloads go to.
        self._worker = first._worker
        return [first] + [
            CudaEngine(self.cfg, device=d, replay_mode="host",
                       worker=self._worker) for d in self.devices[1:]]

    def init_state(self, hist0: np.ndarray | None) -> list:
        """One state per device; a resumed histogram goes into the worker
        of the process that holds global ordinal 0, so the merge counts it
        once."""
        states = [inner.init_state(None) for inner in self.inners]
        if hist0 is not None and self.first_ordinal == 0:
            self._worker.add_resumed(hist0)
        return states

    def run_pass(self, state: list, pass_index: int) -> list:
        with trace.span("cb.make_room"):
            self._worker.make_room()
        staged = []
        for inner, st, ordinal in zip(self.inners, state, self.ordinals()):
            with trace.span("cb.replica", device=inner.device,
                            ordinal=ordinal):
                out = inner.host_pass(st, pass_index, ordinal)
            if out is not None:
                staged.append(inner.stage(*out))
        if staged:
            self._worker.submit(staged)
        return state

    def histogram(self, state: list) -> np.ndarray:
        """The worker's accumulator, plus each device's histogram where a
        device share writes one (MH tenures flushed into the worker
        first), summed over processes. Collective."""
        inner = self.inners[0]
        if inner.mh:
            for eng, st in zip(self.inners, state):
                eng.flush_mh_tails_host(st)
        self._worker.drain()
        local = self._worker.hist.copy()
        if inner.split_threshold > 0:
            for eng, st in zip(self.inners, state):
                local += eng.device_histogram(st)
        return distributed.allgather_sum(local)

    def stats(self, state: list) -> dict:
        """The device counters of every device and the worker's tally,
        summed exactly over every process. Collective."""
        from cudabrot_tpu_torch.engines import cuda_engine

        inner = self.inners[0]
        per = [eng.counter_stats(st) for eng, st in zip(self.inners, state)]
        per.append(cuda_engine.worker_tally(self._worker, inner.mh))
        return cuda_engine.finish_host_stats(inner, sum_stats(per),
                                             self._worker)
