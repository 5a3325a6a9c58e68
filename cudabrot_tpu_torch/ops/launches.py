"""Launch counts of the hand-written kernels and their plain versions.

Each kernel wrapper adds one under the kernel's name where it launches the
kernel, and nowhere else; each plain PyTorch version adds one under
``<name>_plain`` when it runs. A run that resets the counts, renders and
reads them back shows which path the render took (``chip_smoke.py``).
"""

from __future__ import annotations

import collections

KERNELS = ("classify", "threefry_bits", "deposit_ids", "replay_deposit",
           "classify_ext", "replay_deposit_ext", "classify_mh",
           "classify_ext_mh", "mh_deposit", "replay_ids", "replay_ids_ext",
           "bigtiles_deposit", "length_sort", "pass_counters")

COUNTS: collections.Counter = collections.Counter()


def reset() -> None:
    COUNTS.clear()


def snapshot() -> dict:
    """Counts of every kernel and plain version (zeros included)."""
    return {name: COUNTS[name]
            for k in KERNELS for name in (k, f"{k}_plain")}
