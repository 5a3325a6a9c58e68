"""Compute-engine registry.

An engine owns the per-pass work (the analog of one DrawBuddhabrot kernel
launch, cudabrot.cu:485-486) and its device-resident state. The driver is
engine-agnostic: it time-boxes passes, handles signals and checkpoints,
and reads the final histogram.
"""

from __future__ import annotations

from cudabrot_tpu_torch.config import ConfigError, RenderConfig


def make_engine(cfg: RenderConfig, device=None):
    """The engine ``cfg.options.engine`` names: ``cuda`` (what ``auto``
    resolves to; float32 and extended precision, uniform and
    Metropolis-Hastings sampling) or ``oracle`` (plain
    PyTorch; float32, and float64 for ``--precision float64`` and
    ``extended``). It runs on ``cuda:<cfg.device_index>`` unless ``device``
    says otherwise; without CUDA and without ``device="cpu"`` it raises
    DeviceError."""
    import torch

    cfg.options.validate()
    if cfg.options.num_devices is None and torch.cuda.device_count() > 1:
        raise ConfigError(
            "num_devices > 1 is not yet ported to cudabrot_tpu_torch."
        )
    if cfg.options.sampler == "mh" and cfg.options.engine == "oracle":
        raise ConfigError(
            "--sampler mh runs on the cuda engine only (the MH chains live "
            "in the kernel's persistent lane state)"
        )
    if cfg.options.engine == "oracle":
        from cudabrot_tpu_torch.engines.oracle_engine import OracleEngine

        return OracleEngine(cfg, device=device)
    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine

    # float64 without the oracle is refused there, by name.
    return CudaEngine(cfg, device=device)
