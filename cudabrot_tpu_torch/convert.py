"""Carry engine state between the JAX engine and this package's.

The JAX engine's state, brought to numpy (``jax.tree.map(np.asarray,
state)``), is a dict: ``"hist"`` (H, W) uint32, ``"lanes"`` the lane-state
tuple ((R, 128) float32/int32: 10 arrays at float32, the 16 of
``ExtLaneState`` at extended precision), at extended precision ``"dfc"``
(the (9,) float32 constants of the df32 replay), and one (lo, hi) uint32
pair per stat key. This package keeps the same fields as tensors: the
histogram as int32 holding the same bits, the lanes as a LaneState or
ExtLaneState, each stat as an int64 total. Converting either way loses
nothing, so both engines can start from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from cudabrot_tpu_torch.ops.classify import LaneState
from cudabrot_tpu_torch.ops.classify_ext import I32_FIELDS, ExtLaneState
from cudabrot_tpu_torch.utils import counters


def state_from_jax(np_state: dict, device="cpu") -> dict:
    """The JAX engine's numpy state as this package's state on ``device``.
    The lane tuple's length tells the float32 state from the extended."""
    hist = np.ascontiguousarray(np_state["hist"], dtype=np.uint32)
    lane_cls = next(
        (c for c in (LaneState, ExtLaneState)
         if len(c._fields) == len(np_state["lanes"])), None)
    if lane_cls is None:
        raise ValueError(
            f"lane state has {len(np_state['lanes'])} arrays; want "
            f"{len(LaneState._fields)} (float32) or "
            f"{len(ExtLaneState._fields)} (extended)"
        )
    lanes = []
    for name, a in zip(lane_cls._fields, np_state["lanes"]):
        a = np.ascontiguousarray(a)
        want = np.int32 if name in I32_FIELDS else np.float32
        if a.dtype != want:
            raise ValueError(f"lane field {name} is {a.dtype}, want {want}")
        lanes.append(torch.from_numpy(a.copy()).to(device))
    state = {
        "hist": torch.from_numpy(hist.view(np.int32).copy()).to(device),
        "lanes": lane_cls(*lanes),
    }
    if "dfc" in np_state:
        dfc = np.ascontiguousarray(np_state["dfc"], dtype=np.float32)
        state["dfc"] = torch.from_numpy(dfc.copy()).to(device)
    for k in counters.STAT_KEYS:
        state[k] = counters.from_u64_pair(np_state[k], device)
    return state


def state_to_numpy(state: dict) -> dict:
    """This package's state in the JAX engine's numpy layout."""
    out = {
        "hist": state["hist"].cpu().numpy().view(np.uint32).copy(),
        "lanes": tuple(t.cpu().numpy().copy() for t in state["lanes"]),
    }
    if "dfc" in state:
        out["dfc"] = state["dfc"].cpu().numpy().copy()
    for k in counters.STAT_KEYS:
        lo, hi = counters.to_u64_pair(state[k])
        out[k] = (np.uint32(lo), np.uint32(hi))
    return out
