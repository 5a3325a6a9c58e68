"""Multi-process rendering on ``torch.distributed``.

Port of ``cudabrot_tpu/parallel/distributed.py``. Every process renders on
its own devices with its own RNG ordinals; histograms and stats merge once
per readback, so nothing crosses processes inside a pass but one stop
flag. Launch contract (one process per host, or per card):

    CUDABROT_COORDINATOR=host0:1234 \\
    CUDABROT_NUM_PROCESSES=2 CUDABROT_PROCESS_ID=0 \\
    python -m cudabrot_tpu_torch.cli ... &
    CUDABROT_COORDINATOR=host0:1234 \\
    CUDABROT_NUM_PROCESSES=2 CUDABROT_PROCESS_ID=1 \\
    python -m cudabrot_tpu_torch.cli ... &

``CUDABROT_DISTRIBUTED=auto`` instead reads torchrun's environment
(``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).

The group runs the ``gloo`` backend: what crosses processes is host-side
(a stop flag a pass, a histogram and the stat totals a readback), so it
needs no NCCL. Process 0 is the primary: it owns every file the render
writes and the time box; a SIGINT on any process stops all of them on
the same pass (``any_flag``). Non-primary processes print nothing.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

#: How long a process waits for the others to join the group, and for a
#: collective.
TIMEOUT = datetime.timedelta(seconds=300)


class DistributedError(RuntimeError):
    """The launch environment names a process group that cannot be
    joined."""


def initialize_from_env(log: Callable[[str], None] = print) -> bool:
    """Join the process group the launch environment asks for (nothing
    when it asks for none). Returns True when a multi-process group is up.
    Raises DistributedError when the environment is incomplete or the
    group cannot be reached within ``TIMEOUT``: a render never carries on
    alone."""
    auto = os.environ.get("CUDABROT_DISTRIBUTED", "") == "auto"
    coord = os.environ.get("CUDABROT_COORDINATOR")
    if not coord and not auto:
        return False
    if dist.is_initialized():
        return True
    try:
        if auto:
            where = "env://"
            dist.init_process_group("gloo", init_method=where,
                                    timeout=TIMEOUT)
        else:
            where = f"tcp://{coord}"
            dist.init_process_group(
                "gloo", init_method=where,
                world_size=int(os.environ["CUDABROT_NUM_PROCESSES"]),
                rank=int(os.environ["CUDABROT_PROCESS_ID"]),
                timeout=TIMEOUT)
    except KeyError as e:
        raise DistributedError(
            f"CUDABROT_COORDINATOR is set but {e.args[0]} is not.") from None
    except (RuntimeError, ValueError, OSError) as e:
        raise DistributedError(
            f"Cannot join the process group at {where}: {e}") from None
    if is_primary():
        log(f"Distributed runtime: {process_count()} processes (gloo).")
    return True


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def any_flag(value: bool) -> bool:
    """OR of a local stop request over every process. A SIGINT delivered to
    any process stops the whole render, and every process sees the verdict
    on the same pass; the primary's contribution carries the time box and
    the pass count (its clock alone decides them)."""
    if process_count() == 1:
        return value
    t = torch.tensor([int(bool(value))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def allgather_ints(values) -> np.ndarray:
    """Every process's int64 ``values`` (one row per process, in rank
    order)."""
    t = torch.tensor(list(values), dtype=torch.int64)
    if process_count() == 1:
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_sum(hist: np.ndarray) -> np.ndarray:
    """The sum over processes of each process's ``hist`` in its own dtype,
    uint32 (wrapping, ``allgather_sum_u32``) or uint64: a uint64 render's
    merge never wraps at 2^32, where the JAX package's host-replay engine
    sums the gathered histograms in uint32."""
    if hist.dtype != np.uint64:
        return allgather_sum_u32(hist)
    if process_count() == 1:
        return hist
    t = torch.from_numpy(np.ascontiguousarray(hist).view(np.int64))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    total = np.zeros(hist.shape, np.uint64)
    for h in out:
        total += h.numpy().view(np.uint64)
    return total


def allgather_sum_u32(hist: np.ndarray) -> np.ndarray:
    """The uint32 sum over processes of each process's ``hist`` (wrapping,
    as the JAX package's ``jnp.sum(dtype=uint32)``). The histograms travel
    as their int32 view and are summed on the host."""
    if process_count() == 1:
        return hist
    t = torch.from_numpy(np.ascontiguousarray(hist, np.uint32).view(np.int32))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    total = np.zeros(hist.shape, np.uint32)
    for h in out:
        total += h.numpy().view(np.uint32)
    return total
