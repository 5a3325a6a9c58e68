"""Carry engine state between the JAX engine and this package's.

The JAX engine's state, brought to numpy (``jax.tree.map(np.asarray,
state)``), is a dict: ``"hist"`` (H, W) uint32, ``"lanes"`` the lane-state
tuple ((R, 128) float32/int32: 10 arrays at float32, the 16 of
``ExtLaneState`` at extended precision; with ``--sampler mh`` the 20 of
``MhLaneState`` or the 24 of ``ExtMhLaneState``, whose last two are the
(visit_slots, R, 128) reservoirs), at extended precision without MH
``"dfc"`` (the (9,) float32 constants of the df32 replay), and one (lo, hi)
uint32 pair per stat key (MH engines carry four more). This package keeps
the same fields as tensors: the histogram as int32 holding the same bits,
the lanes as the lane-state tuple of the same name, each stat as an int64
total. Converting either way loses
nothing, so both engines can start from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from cudabrot_tpu_torch.ops.classify import LaneState
from cudabrot_tpu_torch.ops import classify_ext, classify_mh
from cudabrot_tpu_torch.ops.classify_ext import ExtLaneState
from cudabrot_tpu_torch.ops.classify_mh import ExtMhLaneState, MhLaneState
from cudabrot_tpu_torch.utils import counters

_LANE_CLASSES = (LaneState, ExtLaneState, MhLaneState, ExtMhLaneState)
_I32_FIELDS = set(classify_ext.I32_FIELDS) | set(classify_mh.I32_FIELDS)


def _stat_keys(state: dict) -> tuple:
    mh = tuple(k for k in counters.MH_STAT_KEYS if k in state)
    return counters.STAT_KEYS + mh


def state_from_jax(np_state: dict, device="cpu") -> dict:
    """The JAX engine's numpy state as this package's state on ``device``.
    The lane tuple's length tells the four lane states apart."""
    hist = np.ascontiguousarray(np_state["hist"], dtype=np.uint32)
    lane_cls = next(
        (c for c in _LANE_CLASSES
         if len(c._fields) == len(np_state["lanes"])), None)
    if lane_cls is None:
        raise ValueError(
            f"lane state has {len(np_state['lanes'])} arrays; want "
            + ", ".join(f"{len(c._fields)} ({c.__name__})"
                        for c in _LANE_CLASSES)
        )
    lanes = []
    for name, a in zip(lane_cls._fields, np_state["lanes"]):
        a = np.ascontiguousarray(a)
        want = np.int32 if name in _I32_FIELDS else np.float32
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
    for k in _stat_keys(np_state):
        state[k] = counters.from_u64_pair(np_state[k], device)
    return state


def state_to_numpy(state: dict) -> dict:
    """This package's state in the JAX engine's numpy layout. On the card
    it synchronizes the device first: the engine's fused replay may still
    be adding to the histogram and its count on a side stream."""
    if state["hist"].is_cuda:
        torch.cuda.synchronize(state["hist"].device)
    out = {
        "hist": state["hist"].cpu().numpy().view(np.uint32).copy(),
        "lanes": tuple(t.cpu().numpy().copy() for t in state["lanes"]),
    }
    if "dfc" in state:
        out["dfc"] = state["dfc"].cpu().numpy().copy()
    for k in _stat_keys(state):
        lo, hi = counters.to_u64_pair(state[k])
        out[k] = (np.uint32(lo), np.uint32(hi))
    return out
