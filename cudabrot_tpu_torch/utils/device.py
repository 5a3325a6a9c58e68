"""Device resolution for the port's entry points.

Every entry point runs on CUDA unless the caller asks for the CPU. Asking
for CUDA on a machine without it is an error, never a silent CPU run: the
CPU executes the kernels' plain PyTorch versions, which exist for tests.
"""

from __future__ import annotations

import torch


class DeviceError(RuntimeError):
    """The requested device is not available."""


def resolve_device(device=None, index: int = 0) -> torch.device:
    """``None`` -> ``cuda:<index>``; ``"cuda"`` -> ``cuda:<index>``;
    ``"cuda:N"`` and ``"cpu"`` pass through. Raises DeviceError when CUDA
    is asked for and absent, or the index is out of range."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DeviceError(f"Unsupported device {device!r} (cuda or cpu).")
    if dev.index is None:
        dev = torch.device("cuda", index)
    if not torch.cuda.is_available():
        raise DeviceError(
            f"CUDA device {dev} requested but CUDA is not available "
            "(pass device='cpu' to run the plain PyTorch versions)."
        )
    count = torch.cuda.device_count()
    if dev.index >= count:
        raise DeviceError(
            f"Device {dev.index} not available ({count} devices present)."
        )
    return dev
