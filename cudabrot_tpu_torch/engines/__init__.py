"""Compute-engine registry.

An engine owns the per-pass work (the analog of one DrawBuddhabrot kernel
launch, cudabrot.cu:485-486) and its device-resident state. The driver is
engine-agnostic: it time-boxes passes, handles signals and checkpoints,
and reads the final histogram.
"""

from __future__ import annotations

from cudabrot_tpu_torch.config import ConfigError, RenderConfig


def make_engine(cfg: RenderConfig, device=None):
    """The single-device CUDA engine (``auto`` resolves to it). It runs on
    ``cuda:<cfg.device_index>`` unless ``device`` says otherwise; without
    CUDA and without ``device="cpu"`` it raises DeviceError."""
    import torch

    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine

    cfg.options.validate()
    if cfg.options.num_devices is None and torch.cuda.device_count() > 1:
        raise ConfigError(
            "num_devices > 1 is not yet ported to cudabrot_tpu_torch."
        )
    return CudaEngine(cfg, device=device)
