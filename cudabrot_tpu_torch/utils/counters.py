"""Render statistic accumulators.

The JAX package carries 64-bit totals as (lo, hi) uint32 pairs because
JAX disables 64-bit integers by default. PyTorch has int64, so each total
here is one 0-dim int64 tensor on the render device, updated in place
without a host round trip; values cross to the host only when stats are
read. The keys are the JAX engine's ``STAT_KEYS``
(``cudabrot_tpu/engines/pallas_engine.py``) and ``stats`` reports the same
keys and values.
"""

from __future__ import annotations

import torch

STAT_KEYS = (
    "samples", "culled", "in_band", "emitted", "replay_dropped",
    "iters", "points", "cycles", "wasted", "dev_hits",
)

_MASK32 = 0xFFFFFFFF


def zeros(device) -> dict:
    """One zeroed int64 total per stat key."""
    return {k: torch.zeros((), dtype=torch.int64, device=device)
            for k in STAT_KEYS}


def value(total: torch.Tensor) -> int:
    """Exact host value of a total."""
    return int(total.item())


def from_u64_pair(pair, device) -> torch.Tensor:
    """A JAX (lo, hi) uint32 pair as an int64 total."""
    lo, hi = (int(v) for v in pair)
    return torch.tensor((hi << 32) | lo, dtype=torch.int64, device=device)


def to_u64_pair(total: torch.Tensor) -> tuple[int, int]:
    """An int64 total as a JAX (lo, hi) uint32 pair."""
    v = value(total)
    return v & _MASK32, (v >> 32) & _MASK32


def counter_stats(totals: dict) -> dict:
    """Counter totals under the JAX engine's ``counter_stats`` names."""
    vals = {k: value(totals[k]) for k in STAT_KEYS}
    return {
        "samples": vals["samples"],
        "culled": vals["culled"],
        "in_band": vals["in_band"],
        "emitted": vals["emitted"],
        "replay_dropped": vals["replay_dropped"],
        "cycles_detected": vals["cycles"],
        "classify_iters": vals["iters"],
        "wasted_steps": vals["wasted"],
        "orbit_points": vals["points"],
        "_device_on_canvas": vals["dev_hits"],
    }
