"""--sample-domain, the canvas emit filter and the driver's overflow
warning through the port's engines (CPU: the kernels' plain versions).

The engine cases of the JAX package's tests/test_sample_domain.py and
tests/test_emit_filter.py, on their configurations: the cuda engine
samples the window and nothing else; on a restricted window it agrees with
the port's oracle and with the JAX Pallas engine (interpret mode) as a
distribution; the emission model's window boost is capped; gating
emissions on canvas visits leaves the oracle's and the df32 engine's
histograms bitwise as they were, and the host replay's within 2%; a
render whose emissions overflow the replay capacity says so. The cases
of those files that other port tests already hold are named in
CHANGES.md.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.engines.pallas_engine import PallasEngine
from cudabrot_tpu_torch import cli, driver
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.engines import make_engine
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine, Tuning
from cudabrot_tpu_torch.engines.oracle_engine import OracleEngine
from tests.test_emit_filter import _BAND, _CROP

# One intra-op thread a test worker (see tests/test_torch_oracle.py).
torch.set_num_threads(1)

DOMAIN = (-1.5, 0.5, -1.0, 1.0)
#: tests/test_emit_filter.py's seahorse-valley crop and band.
CROP = dataclasses.asdict(_CROP)
CROP_BAND = (_BAND.max_escape_iterations, _BAND.min_escape_iterations)


def _cfg(mod, canvas=None, band=(50, 3), top=None, **opt):
    """tests/test_sample_domain.py's engine configuration in either
    package (the JAX one on its Pallas engine, device replay)."""
    base = dict(lane_rows=8, steps_per_pass=256, steps_per_flush=16,
                replay_capacity=1 << 14)
    base.update(opt)
    if mod is jcfg and base.get("engine") != "oracle":
        base.update(engine="pallas", replay_chunk=64)
        base.setdefault("replay", "device")
    return mod.RenderConfig(
        canvas=mod.Canvas(**(canvas or dict(width=32, height=32))),
        band=mod.IterationBand(max_escape_iterations=band[0],
                               min_escape_iterations=band[1]),
        options=mod.EngineOptions(**base), **(top or {}))


def _oracle_opts(samples):
    return dict(engine="oracle", oracle_samples_per_pass=samples)


def _render(eng, passes):
    state = eng.init_state(None)
    for p in range(passes):
        state = eng.run_pass(state, p)
    return eng.histogram(state), eng.stats(state)


def _corr(a, b) -> float:
    p = a.astype(np.float64) / a.sum()
    q = b.astype(np.float64) / b.sum()
    return float(np.corrcoef(p.ravel(), q.ravel())[0, 1])


def _band_fraction(st) -> float:
    return st["in_band"] / (st["samples"] - st["culled"])


# -- --sample-domain (tests/test_sample_domain.py) ------------------------


def test_emissions_seeded_in_domain():
    """Every compacted emission's c lies inside the window: the refill's
    24-bit map honours its lo and span (test_sample_domain.py:124)."""
    eng = CudaEngine(_cfg(tcfg, top=dict(sample_domain=DOMAIN)),
                     device="cpu")
    state = eng.init_state(None)
    seen = 0
    for p in range(6):
        (cr, ci, it), _, _ = eng.classify_and_compact(state, p)
        live = it >= 0
        seen += int(live.sum())
        assert bool((cr[live] >= DOMAIN[0]).all()
                    and (cr[live] < DOMAIN[1]).all())
        assert bool((ci[live] >= DOMAIN[2]).all()
                    and (ci[live] < DOMAIN[3]).all())
    assert seen > 0


def test_all_escaping_domain_is_all_in_band():
    """A window wholly outside |c| <= 2 escapes at index 0: with min 0
    every draw is in band and none is culled, except each lane's first,
    placeholder refill (test_sample_domain.py:143)."""
    cfg = _cfg(tcfg, band=(10, 0), top=dict(sample_domain=(2.5, 3.0, 2.5,
                                                           3.0)))
    _, stats = _render(CudaEngine(cfg, device="cpu"), 3)
    assert stats["culled"] == 0
    assert stats["in_band"] > 0
    assert stats["samples"] - stats["in_band"] == cfg.options.lane_rows * 128


@pytest.mark.parametrize("other", ["oracle", "jax"])
def test_statistical_equivalence_on_restricted_domain(other):
    """The engine's 24-bit grid and the oracle's uniform draws map the
    window independently, yet agree as distributions: in-band fractions
    within 5%, normalized histograms corr > 0.99 (test_sample_domain.py:161);
    the JAX Pallas engine, drawing the same samples, to the same
    criterion."""
    top = dict(sample_domain=DOMAIN)
    h, st = _render(CudaEngine(_cfg(tcfg, top=top), device="cpu"), 8)
    if other == "oracle":
        ho, sto = _render(OracleEngine(_cfg(
            tcfg, top=top, **_oracle_opts(1 << 15)), device="cpu"), 8)
    else:
        ho, sto = _render(PallasEngine(_cfg(jcfg, top=top)), 8)
    assert abs(_band_fraction(st) / _band_fraction(sto) - 1) < 0.05
    assert _corr(h, ho) > 0.99, _corr(h, ho)


def test_tuning_boost_capped_at_16x():
    """The emission model boosts a window's rate by at most 16x, so a
    0.01-area window tunes as a 1.0-area one, and still tighter than the
    full domain (test_sample_domain.py:244)."""
    band = tcfg.IterationBand(max_escape_iterations=5000,
                              min_escape_iterations=500)
    tiny = Tuning(tcfg.RenderConfig(
        band=band, sample_domain=(-0.76, -0.66, 0.0, 0.1)))
    unit = Tuning(tcfg.RenderConfig(
        band=band, sample_domain=(-1.0, 0.0, 0.0, 1.0)))
    assert tiny.steps_per_flush == unit.steps_per_flush
    assert tiny.steps_per_pass == unit.steps_per_pass
    assert tiny.replay_capacity == unit.replay_capacity
    full = Tuning(tcfg.RenderConfig(band=band))
    assert tiny.steps_per_flush <= full.steps_per_flush


def test_overflow_drop_warning():
    """A replay capacity far below the band's emission rate drops more
    than 1% of the in-band samples, and the driver says so
    (test_sample_domain.py:271, its 24x24 canvas, band [0, 30) and
    capacity 128)."""
    cfg = _cfg(tcfg, canvas=dict(width=24, height=24), band=(30, 0),
               replay_capacity=128,
               top=dict(max_passes=3, seconds_to_run=-1.0))
    logs = []
    res = driver.run_render(cfg, log=logs.append, device="cpu")
    dropped, in_band = res.stats["replay_dropped"], res.stats["in_band"]
    assert dropped > 0.01 * in_band
    warning = [s for s in logs if "overflowed the emission capacity" in s]
    assert len(warning) == 1, logs
    assert f"{dropped} of {in_band} in-band samples" in warning[0]


# -- the canvas emit filter (tests/test_emit_filter.py) --------------------


def _crop_cfg(emit_filter, **opt):
    opts = dict(steps_per_pass=512, steps_per_flush=32)
    opts.update(opt)
    return _cfg(tcfg, canvas=CROP, band=CROP_BAND, emit_filter=emit_filter,
                **opts)


def test_oracle_gated_bitwise_equals_ungated():
    """test_emit_filter.py:114: the oracle's gate drops only orbits that
    deposit nothing."""
    runs = [_render(OracleEngine(_crop_cfg(
        f, **_oracle_opts(1 << 14), oracle_replay_capacity=1 << 14),
        device="cpu"), 3) for f in ("any", "canvas")]
    (h_any, s_any), (h_gate, s_gate) = runs
    assert h_any.sum() > 0
    np.testing.assert_array_equal(h_gate, h_any)
    assert 0 < s_gate["in_band"] < s_any["in_band"]


def test_host_replay_gated_statistically_identical():
    """test_emit_filter.py:87: with the host replay, gated and ungated
    renders differ by at most 2% of the mass (the JAX bound: its native
    replay contracts its own arithmetic; the port's replays f32 payloads
    strictly, so only bin edges can move a point)."""
    runs = [_render(make_engine(_crop_cfg(f, replay="host"),
                                device="cpu"), 4)
            for f in ("any", "canvas")]
    (h_any, s_any), (h_gate, s_gate) = runs
    assert s_any["replay"] == s_gate["replay"] == "host"
    assert h_any.sum() > 0
    diff = np.abs(h_any.astype(np.int64) - h_gate.astype(np.int64)).sum()
    assert diff <= max(2, 0.02 * h_any.sum()), (diff, h_any.sum())
    assert 0 < s_gate["emitted"] < s_any["emitted"]


def test_extended_gated_bitwise_equals_ungated():
    """test_emit_filter.py:134: the df32 engine's gate on a canvas that
    crops a corner of the plane, samples from a 1e-6 window: the replay is
    the classify trajectory, so gating loses nothing that deposits."""
    win = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)
    canvas = dict(width=32, height=32, min_real=-2.0, max_real=0.0,
                  min_imag=0.0, max_imag=2.0)
    runs = []
    for f in ("any", "canvas"):
        cfg = _cfg(tcfg, canvas=canvas, band=(400, 20),
                   top=dict(sample_domain=win), precision="extended",
                   emit_filter=f, steps_per_pass=512, steps_per_flush=32)
        runs.append(_render(CudaEngine(cfg, device="cpu"), 3))
    (h_any, s_any), (h_gate, s_gate) = runs
    assert s_any["replay_dropped"] == 0 == s_gate["replay_dropped"]
    assert h_any.sum() > 0
    np.testing.assert_array_equal(h_gate, h_any)
    assert s_gate["emitted"] <= s_any["emitted"]


def test_cli_emit_filter(tmp_path):
    """test_emit_filter.py:176: an oracle crop with --emit-filter canvas
    through the port's CLI writes its PGM."""
    out = tmp_path / "crop.pgm"
    rc = cli.main(["-w", "24", "-h", "24", "-m", "120", "-c", "10",
                   "--min-real", "-0.78", "--max-real", "-0.72",
                   "--min-imag", "0.05", "--max-imag", "0.11",
                   "--passes", "1", "-t", "-1", "--engine", "oracle",
                   "--emit-filter", "canvas", "-o", str(out)],
                  device="cpu")
    assert rc == 0
    assert out.read_bytes().startswith(b"P5\n24 24\n65535\n")
