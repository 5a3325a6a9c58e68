"""The devices one process renders on.

Port of ``cudabrot_tpu/parallel/mesh.py``. The workload is parallel over
samples: every device runs the same sampler with its own RNG ordinal and
accumulates into its own histogram (or its own rows of one), so a flat
list of devices is all the layout there is.

``--devices N`` counts devices over all processes, as the JAX package's
global mesh does: each of P processes takes N/P devices starting at its
``-d``, and process p's i-th device has the global ordinal p·(N/P) + i,
so a render's samples do not depend on how its devices are spread over
processes.
"""

from __future__ import annotations

import torch

from cudabrot_tpu_torch.config import ConfigError
from cudabrot_tpu_torch.utils.device import DeviceError, resolve_device


def _on_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def device_list(num_devices: int | None, base: int = 0,
                device=None) -> list[torch.device]:
    """Cards ``base .. base + num_devices - 1`` (every card from ``base``
    for None), the multi-device form of ``-d`` (cudabrot.cu:155). With
    ``device="cpu"``: ``num_devices`` CPU devices (1 for None), the
    analogue of the JAX tests' virtual CPU devices. Raises DeviceError
    when CUDA is absent or the cards are not there: never fewer devices,
    never the CPU in their place."""
    if num_devices is not None and num_devices < 1:
        raise ConfigError("--devices must be at least 1 (or 'all').")
    if _on_cpu(device):
        return [torch.device("cpu")] * (num_devices or 1)
    resolve_device("cuda", 0)  # CUDA present, or the resolver's error
    count = torch.cuda.device_count()
    if base >= count:
        raise DeviceError(
            f"Base device {base} not available ({count} devices present).")
    avail = count - base
    n = avail if num_devices is None else num_devices
    if n > avail:
        raise DeviceError(
            f"Requested {n} devices starting at device {base} but only "
            f"{avail} are available there.")
    return [torch.device("cuda", base + i) for i in range(n)]


def local_devices(num_devices: int | None, base: int = 0, device=None):
    """``(devices, first_ordinal, global_count)`` of this process: its
    share of ``num_devices`` devices counted over all processes (every
    local card from ``base`` for None), the global RNG ordinal of its
    first device, and the devices over all processes."""
    from cudabrot_tpu_torch.parallel import distributed

    procs, rank = distributed.process_count(), distributed.process_index()
    if num_devices is not None and num_devices % procs:
        raise ConfigError(
            f"--devices {num_devices} does not divide over {procs} "
            "processes (each takes the same number).")
    local = device_list(None if num_devices is None else num_devices // procs,
                        base, device)
    counts = distributed.allgather_ints([len(local)])[:, 0]
    if (counts != len(local)).any():
        raise ConfigError(
            f"The processes hold {counts.tolist()} devices; each must take "
            "the same number (pass --devices).")
    return local, rank * len(local), procs * len(local)
