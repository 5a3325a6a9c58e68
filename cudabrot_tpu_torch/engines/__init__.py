"""Compute-engine registry.

An engine owns the per-pass work (the analog of one DrawBuddhabrot kernel
launch, cudabrot.cu:485-486) and its device-resident state. The driver is
engine-agnostic: it time-boxes passes, handles signals and checkpoints,
and reads the final histogram.
"""

from __future__ import annotations

from cudabrot_tpu_torch.config import ConfigError, RenderConfig


def single_engine(cfg: RenderConfig, device=None):
    """The one-device engine ``cfg.options.engine`` names on ``device``:
    ``cuda`` (what ``auto`` resolves to) or ``oracle``."""
    if cfg.options.engine == "oracle":
        from cudabrot_tpu_torch.engines.oracle_engine import OracleEngine

        return OracleEngine(cfg, device=device)
    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine

    # float64 without the oracle is refused there, by name.
    return CudaEngine(cfg, device=device)


def make_engine(cfg: RenderConfig, device=None):
    """The engine ``cfg.options.engine`` names: ``cuda`` (what ``auto``
    resolves to; float32 and extended precision, uniform and
    Metropolis-Hastings sampling) or ``oracle`` (plain PyTorch; float32,
    and float64 for ``--precision float64`` and ``extended``). It runs on
    ``cuda:<cfg.device_index>`` unless ``device`` says otherwise; without
    CUDA and without ``device="cpu"`` it raises DeviceError.

    Over more than one device (``--devices``, counted over every process
    of a ``parallel.distributed`` group; None takes every card from ``-d``)
    it is a ``DataParallelEngine``, or with ``--hist-sharding rows`` a
    ``ShardedHistogramEngine`` (the cuda engine only, as the JAX package's
    rows need its pallas engine), or with the host replay (``--replay
    host``, or ``auto`` at ``--hist-dtype uint64``) a
    ``DataParallelHostReplayEngine``: one worker per process. Asking for
    more cards than there are is an error, never a render on fewer."""
    from cudabrot_tpu_torch.parallel import distributed, mesh
    from cudabrot_tpu_torch.parallel.sharded_hist import MH_ROWS

    cfg.options.validate()
    o = cfg.options
    if o.sampler == "mh" and o.engine == "oracle":
        raise ConfigError(
            "--sampler mh runs on the cuda engine only (the MH chains live "
            "in the kernel's persistent lane state)"
        )
    if o.sampler == "mh" and o.histogram_sharding == "rows":
        raise ConfigError(MH_ROWS)
    if o.num_devices == 1 and distributed.process_count() == 1:
        return single_engine(cfg, device)
    devices, first, total = mesh.local_devices(o.num_devices,
                                               cfg.device_index, device)
    if total == 1:
        return single_engine(cfg, devices[0] if device is None else device)
    if o.histogram_sharding == "rows" and o.engine != "oracle":
        from cudabrot_tpu_torch.parallel.sharded_hist import (
            ShardedHistogramEngine,
        )

        return ShardedHistogramEngine(cfg, devices=devices)
    from cudabrot_tpu_torch.parallel import data_parallel

    host = o.replay == "host" or (o.replay == "auto"
                                  and o.hist_dtype == "uint64")
    if host and o.engine != "oracle":
        return data_parallel.DataParallelHostReplayEngine(cfg,
                                                          devices=devices)
    return data_parallel.DataParallelEngine(cfg, devices=devices)
