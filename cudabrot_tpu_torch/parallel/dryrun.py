"""Two passes of every multi-device engine at tiny shapes.

The counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``
(``:49-192``): the data-parallel engine at float32, at extended precision
and with Metropolis-Hastings chains, and the row-sharded engine, each for
two passes (the second carries the lane state), over ``n`` devices: CPU
devices with ``device="cpu"`` (the kernels' plain versions), cards
otherwise. The canvas height is not a multiple of ``n``, so the row
shards' padding is exercised. Run as
``python -m cudabrot_tpu_torch.parallel.dryrun N [cpu]``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from cudabrot_tpu_torch.config import (
    Canvas,
    EngineOptions,
    IterationBand,
    RenderConfig,
)
from cudabrot_tpu_torch.parallel.data_parallel import DataParallelEngine
from cudabrot_tpu_torch.parallel.sharded_hist import ShardedHistogramEngine


def _two_passes(engine) -> tuple[np.ndarray, dict]:
    state = engine.init_state(None)
    for p in range(2):
        state = engine.run_pass(state, p)
    return engine.histogram(state), engine.stats(state)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Runs the four engines; returns each one's histogram sum. Raises
    AssertionError when a histogram is empty or misshapen, or the row
    shards differ from the replicas."""
    height = 8 * n_devices + n_devices // 2
    opts = EngineOptions(lane_rows=2, steps_per_pass=128, steps_per_flush=16,
                         replay_capacity=4096, num_devices=n_devices)
    cfg = RenderConfig(
        canvas=Canvas(width=64, height=height),
        band=IterationBand(max_escape_iterations=32, min_escape_iterations=4),
        options=opts)
    win = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)
    runs = {
        "float32": cfg,
        "rows": cfg.replace(options=dataclasses.replace(
            opts, histogram_sharding="rows")),
        "extended": cfg.replace(
            band=IterationBand(max_escape_iterations=128,
                               min_escape_iterations=8),
            sample_domain=win,
            options=dataclasses.replace(opts, precision="extended")),
        "mh": cfg.replace(
            canvas=Canvas(width=64, height=height, min_real=-1.2,
                          max_real=-0.4, min_imag=-0.3, max_imag=0.5),
            band=IterationBand(max_escape_iterations=64,
                               min_escape_iterations=4),
            options=dataclasses.replace(opts, sampler="mh",
                                        replay_capacity=0)),
    }
    sums, hists = {}, {}
    for name, c in runs.items():
        kind = (ShardedHistogramEngine if name == "rows"
                else DataParallelEngine)
        hist, stats = _two_passes(kind(c, device=device))
        assert hist.shape == (height, 64), (name, hist.shape)
        assert int(hist.sum()) > 0, name
        assert stats["on_canvas_points"] == int(hist.sum()), name
        hists[name], sums[name] = hist, int(hist.sum())
    assert (hists["rows"] == hists["float32"]).all(), \
        "sharded histogram != replicated"
    return sums


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(dryrun_multichip(n, sys.argv[2] if len(sys.argv) > 2 else None))
