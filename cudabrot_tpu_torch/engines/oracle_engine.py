"""The plain PyTorch oracle as an engine of the render loop.

Port of ``cudabrot_tpu/engines/oracle_engine.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from cudabrot_tpu_torch.config import ConfigError, RenderConfig
from cudabrot_tpu_torch.ops import oracle, prng
from cudabrot_tpu_torch.utils.device import resolve_device

STAT_KEYS = (
    "samples", "culled", "in_band", "iters", "points", "wasted", "dropped",
)


class OracleEngine:
    """Vectorized sampler in plain tensor operations (ops/oracle.py), in
    float32 or float64. The ground truth the CUDA engine is checked
    against, and a usable engine on any device."""

    name = "oracle"

    def __init__(self, cfg: RenderConfig, device=None):
        cfg.options.validate()
        if cfg.options.hist_dtype != "uint32":
            raise ConfigError(
                "uint64 histograms are supported by the cuda engine's "
                "host-replay path only (the oracle accumulates on-device "
                "in uint32)."
            )
        self.cfg = cfg
        self.device = resolve_device(device, cfg.device_index)
        #: A worst-case bound, not a count: samples that escape or are
        #: culled early execute fewer steps.
        self.steps_per_pass = (
            cfg.options.oracle_samples_per_pass
            * cfg.band.max_escape_iterations
        )
        if cfg.options.oracle_samples_per_pass > (1 << 24):
            raise ConfigError(
                "oracle_samples_per_pass must be at most 2^24; lower it or "
                "use the cuda engine"
            )

    def core(self, state: dict, pass_index: int, ordinal: int = 0) -> dict:
        """One pass on the state's device; updates ``state`` in place. The
        pass key is ``fold_in(fold_in(key(seed), ordinal), pass_index)``,
        as the CUDA engine's."""
        key = prng.pass_key(self.cfg.seed, ordinal, pass_index)
        _, stats = oracle.render_pass(state["hist"], key, self.cfg)
        per_pass = {
            "samples": stats.samples,
            "culled": stats.culled,
            "in_band": stats.in_band,
            "iters": stats.classify_iters,
            "points": stats.orbit_points,
            "wasted": stats.wasted_steps,
            "dropped": stats.replay_dropped,
        }
        for k in STAT_KEYS:
            state[k] += per_pass[k]
        return state

    def run_pass(self, state: dict, pass_index: int) -> dict:
        return self.core(state, pass_index)

    def memory_estimate(self) -> tuple[int, int]:
        cv = self.cfg.canvas
        hist = cv.num_pixels * 4
        batch = self.cfg.options.oracle_samples_per_pass * 40
        return hist + batch, hist + cv.num_pixels * 2

    def init_state(self, hist0: np.ndarray | None) -> dict:
        shape = self.cfg.canvas.shape
        if hist0 is None:
            hist = torch.zeros(shape, dtype=torch.int32, device=self.device)
        else:
            h = np.ascontiguousarray(hist0, dtype=np.uint32).view(np.int32)
            hist = torch.from_numpy(h.copy()).to(self.device)
        state = {"hist": hist}
        for k in STAT_KEYS:
            state[k] = torch.zeros((), dtype=torch.int64, device=self.device)
        return state

    def warmup(self, state: dict) -> None:
        """Nothing to build: the oracle has no kernel of its own."""

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def histogram(self, state: dict) -> np.ndarray:
        return state["hist"].cpu().numpy().view(np.uint32).copy()

    def stats(self, state: dict) -> dict:
        vals = {k: int(state[k].item()) for k in STAT_KEYS}
        return {
            "samples": vals["samples"],
            "culled": vals["culled"],
            "in_band": vals["in_band"],
            "classify_iters": vals["iters"],
            "orbit_points": vals["points"],
            "wasted_steps": vals["wasted"],
            "replay_dropped": vals["dropped"],
        }
