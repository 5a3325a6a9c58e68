"""Carry engine state between the JAX engine and this package's.

The JAX engine's state, brought to numpy (``jax.tree.map(np.asarray,
state)``), is a dict: ``"hist"`` (H, W) uint32, ``"lanes"`` the 10-array
LaneState tuple ((R, 128) float32/int32), and one (lo, hi) uint32 pair per
stat key. This package keeps the same fields as tensors: the histogram as
int32 holding the same bits, the lanes as a LaneState, each stat as an
int64 total. Converting either way loses nothing, so both engines can
start from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from cudabrot_tpu_torch.ops.classify import LaneState
from cudabrot_tpu_torch.utils import counters


def state_from_jax(np_state: dict, device="cpu") -> dict:
    """The JAX engine's numpy state as this package's state on ``device``."""
    hist = np.ascontiguousarray(np_state["hist"], dtype=np.uint32)
    lanes = []
    for name, a in zip(LaneState._fields, np_state["lanes"]):
        a = np.ascontiguousarray(a)
        want = np.float32 if name in ("cr", "ci", "zr", "zi", "sr", "si") \
            else np.int32
        if a.dtype != want:
            raise ValueError(f"lane field {name} is {a.dtype}, want {want}")
        lanes.append(torch.from_numpy(a.copy()).to(device))
    state = {
        "hist": torch.from_numpy(hist.view(np.int32).copy()).to(device),
        "lanes": LaneState(*lanes),
    }
    for k in counters.STAT_KEYS:
        state[k] = counters.from_u64_pair(np_state[k], device)
    return state


def state_to_numpy(state: dict) -> dict:
    """This package's state in the JAX engine's numpy layout."""
    out = {
        "hist": state["hist"].cpu().numpy().view(np.uint32).copy(),
        "lanes": tuple(t.cpu().numpy().copy() for t in state["lanes"]),
    }
    for k in counters.STAT_KEYS:
        lo, hi = counters.to_u64_pair(state[k])
        out[k] = (np.uint32(lo), np.uint32(hi))
    return out
