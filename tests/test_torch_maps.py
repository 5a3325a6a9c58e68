"""Whole renders of the two other maps, burning-ship and anti-buddhabrot,
through the port's cuda engine (CPU: the kernels' plain versions) against
the JAX Pallas engine (interpret mode, device replay) and against the
port's oracle.

The configurations are those of the JAX package's own equivalence tests
(tests/test_pallas_engine.py, ``test_burning_ship_statistical_equivalence
_with_oracle`` and ``test_anti_buddhabrot_statistical_equivalence_with
_oracle``), and so is the criterion: normalized histograms correlate
above 0.99. The port and the JAX engine draw the same samples at one seed
and geometry; the JAX kernel's jitted orbits are FMA-contracted on the
CPU, so a few lanes diverge (measured corr 0.99941 for burning-ship,
0.99983 for anti-buddhabrot). The oracle draws other samples (0.99662
and 0.99412).
"""

import jax
import numpy as np
import pytest
import torch

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.engines.pallas_engine import PallasEngine
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
from cudabrot_tpu_torch.engines.oracle_engine import OracleEngine
from cudabrot_tpu_torch.ops import launches

# One intra-op thread a test worker (see tests/test_torch_oracle.py).
torch.set_num_threads(1)

#: fractal: (canvas side, band (max, min), lane-steps a pass, passes,
#: oracle samples a pass), as the JAX tests render them.
MAPS = {
    "burning-ship": (32, (50, 3), 256, 8, 1 << 15),
    "anti-buddhabrot": (48, (80, 0), 512, 6, 1 << 14),
}


def _cfg(mod, fractal, **options):
    side, band, steps, _, _ = MAPS[fractal]
    return mod.RenderConfig(
        canvas=mod.Canvas(width=side, height=side),
        band=mod.IterationBand(max_escape_iterations=band[0],
                               min_escape_iterations=band[1]),
        fractal=fractal,
        options=mod.EngineOptions(**options),
    )


def _engine_options(mod, fractal):
    steps = MAPS[fractal][2]
    opts = dict(lane_rows=8, steps_per_pass=steps, steps_per_flush=16,
                replay_capacity=1 << 14)
    if mod is jcfg:
        opts.update(engine="pallas", replay="device", replay_chunk=64)
    return opts


def _render(eng, passes):
    state = eng.init_state(None)
    for p in range(passes):
        state = eng.run_pass(state, p)
    return eng.histogram(state), eng.stats(state)


def _corr(a, b) -> float:
    p = a.astype(np.float64) / a.sum()
    q = b.astype(np.float64) / b.sum()
    return float(np.corrcoef(p.ravel(), q.ravel())[0, 1])


@pytest.fixture(scope="module", params=sorted(MAPS))
def renders(request):
    """(fractal, {engine: (histogram, stats)}) of the cuda engine, the JAX
    Pallas engine and the port's oracle."""
    fractal = request.param
    passes, samples = MAPS[fractal][3], MAPS[fractal][4]
    launches.reset()
    port = _render(CudaEngine(_cfg(tcfg, fractal, **_engine_options(
        tcfg, fractal)), device="cpu"), passes)
    assert launches.COUNTS["classify_plain"] == passes
    assert launches.COUNTS["replay_deposit_plain"] == passes
    jeng = PallasEngine(_cfg(jcfg, fractal, **_engine_options(jcfg,
                                                                fractal)))
    state = jeng.init_state(None)
    for p in range(passes):
        state = jeng.run_pass(state, p)
    jax.block_until_ready(state)
    jax_run = jeng.histogram(state), jeng.stats(state)
    oracle = _render(OracleEngine(_cfg(
        tcfg, fractal, engine="oracle", oracle_samples_per_pass=samples),
        device="cpu"), passes)
    return fractal, {"cuda": port, "jax": jax_run, "oracle": oracle}


@pytest.mark.parametrize("other", ["jax", "oracle"])
def test_whole_render_correlates(renders, other):
    fractal, runs = renders
    (h, st), (ho, _) = runs["cuda"], runs[other]
    assert h.sum() > 0 and ho.sum() > 0
    assert st["on_canvas_points"] == h.sum()
    assert _corr(h, ho) > 0.99, (fractal, other, _corr(h, ho))


def test_map_semantics(renders):
    """Burning-ship culls nothing (no cardioid or bulb); anti-buddhabrot
    records exactly max_it points per emission, in the cuda engine and in
    the oracle, every one on the [-2, 2]^2 canvas, and proves interiors by
    Brent's cycle check."""
    fractal, runs = renders
    (h, st), (_, ost) = runs["cuda"], runs["oracle"]
    if fractal == "burning-ship":
        assert st["culled"] == 0 and ost["culled"] == 0
        assert runs["jax"][1]["culled"] == 0
        return
    max_it = MAPS[fractal][1][0]
    assert st["orbit_points"] == st["emitted"] * max_it > 0
    assert ost["orbit_points"] == ost["in_band"] * max_it > 0
    assert h.sum() == st["orbit_points"]
    assert st["cycles_detected"] > 0
    for s in (st, ost):
        assert 0.08 < s["in_band"] / s["samples"] < 0.12
