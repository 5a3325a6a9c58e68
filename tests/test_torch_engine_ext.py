"""The cudabrot_tpu_torch engine at extended precision (CPU: the df32
kernels' plain versions) vs the JAX Pallas engine (interpret mode, device
replay) and vs the port's float64 oracle.

Exact where the inputs are identical: state conversion both ways, the
runtime constants, geometry and the visit window. Statistical for the whole
slice: the engines draw the same Threefry samples at one seed and geometry,
but the JAX kernel's jitted df32 orbits are FMA-contracted on the CPU, so
a few borderline escapes flip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.engines import pallas_engine as jpe
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch import convert
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine, Tuning
from cudabrot_tpu_torch.ops import launches
from cudabrot_tpu_torch.utils import counters

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)


def _run(eng, state, passes, start=0):
    for p in range(start, start + passes):
        state = eng.run_pass(state, p)
    return state

_CX, _CY = -0.743643887037151, 0.131825904205330
#: Just outside the set: every sample escapes in ~56 steps.
FAST = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)


def _window(span):
    return (_CX - span / 2, _CX + span / 2, _CY - span / 2, _CY + span / 2)


def _ext_cfg(mod, win=FAST, canvas=None, band=(400, 20), **opt):
    base = dict(precision="extended", lane_rows=8, steps_per_pass=512,
                steps_per_flush=32, replay_capacity=1 << 14)
    base.update(opt)
    if mod is jcfg:
        base.update(engine="pallas", replay="device", replay_chunk=64)
    return mod.RenderConfig(
        canvas=mod.Canvas(**(canvas or dict(width=48, height=48))),
        band=mod.IterationBand(max_escape_iterations=band[0],
                               min_escape_iterations=band[1]),
        sample_domain=win,
        options=mod.EngineOptions(**base),
    )


def test_extended_engine_is_deterministic_and_accounts():
    runs = []
    for _ in range(2):
        eng = CudaEngine(_ext_cfg(tcfg), device="cpu")
        launches.reset()
        st = _run(eng, eng.init_state(None), 3)
        assert launches.COUNTS["classify_ext_plain"] == 3
        assert launches.COUNTS["replay_deposit_ext_plain"] == 3
        assert launches.COUNTS["classify_plain"] == 0
        runs.append((eng.histogram(st), eng.stats(st)))
    (h1, s1), (h2, s2) = runs
    np.testing.assert_array_equal(h1, h2)
    assert s1 == s2
    assert h1.sum() == s1["on_canvas_points"] > 0
    assert s1["emitted"] > 0 and s1["replay_dropped"] == 0
    assert s1["classify_iters"] + s1["wasted_steps"] == 3 * 512 * 8 * 128
    assert tuple(eng.init_state(None)["dfc"].shape) == (9,)


def test_extended_state_conversion_round_trip_and_continuation():
    """A state made by the JAX engine (extended, device replay) converts
    into the port without loss and back, and both engines continue it for
    two passes: same samples, so counters and histograms stay close (the
    JAX kernel's fused multiply-adds flip a few borderline escapes)."""
    jeng = jpe.PallasEngine(_ext_cfg(jcfg))
    teng = CudaEngine(_ext_cfg(tcfg), device="cpu")
    js = _run(jeng, jeng.init_state(None), 2)
    np_state = jax.tree.map(np.asarray, js)
    ts = convert.state_from_jax(np_state)
    assert len(ts["lanes"]) == 16 and type(ts["lanes"]).__name__ == "ExtLaneState"
    back = convert.state_to_numpy(ts)
    assert set(back) == set(np_state)
    np.testing.assert_array_equal(back["hist"], np_state["hist"])
    assert back["dfc"].tobytes() == np_state["dfc"].tobytes()
    for name, a, b in zip(ts["lanes"]._fields, back["lanes"],
                          np_state["lanes"]):
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    for k in counters.STAT_KEYS:
        assert tuple(map(int, back[k])) == tuple(map(int, np_state[k])), k
    # The port's own initial constants are the JAX engine's.
    assert teng.init_state(None)["dfc"].numpy().tobytes() == \
        np_state["dfc"].tobytes()

    js, ts = _run(jeng, js, 2, start=2), _run(teng, ts, 2, start=2)
    jh, th = jeng.histogram(js), teng.histogram(ts)
    jst, tst = jeng.stats(js), teng.stats(ts)
    assert th.sum() == tst["on_canvas_points"]
    for k in ("samples", "in_band", "emitted", "orbit_points",
              "on_canvas_points"):
        assert abs(tst[k] / jst[k] - 1) < 0.01, (k, tst[k], jst[k])
    assert np.abs(jh.astype(np.int64) - th).sum() <= 0.02 * jh.sum()
    # And the port's state goes back into the JAX engine.
    back = convert.state_to_numpy(ts)
    js2 = {k: (tuple(jnp.asarray(a) for a in v) if k == "lanes"
               else jax.tree.map(jnp.asarray, v)) for k, v in back.items()}
    js2 = _run(jeng, js2, 1, start=4)
    assert jeng.stats(js2)["samples"] > tst["samples"]


def test_extended_statistical_equivalence_with_float64_oracle():
    """In-band fraction and orbit mass per in-band sample of the port's
    df32 engine match the port's float64 oracle on a deep window, within
    15% (the JAX package's criterion; different sample streams). Census
    correction: the persistent sampler counts each lane's initial dummy
    draw as a finished sample, so the lane count is subtracted. Measured:
    in-band ratio 1.066, mass ratio 0.983."""
    from cudabrot_tpu_torch.engines.oracle_engine import OracleEngine

    win = _window(2e-7)
    canvas = dict(width=32, height=32, min_real=win[0], max_real=win[1],
                  min_imag=win[2], max_imag=win[3])
    lane_rows = 16
    eng = CudaEngine(_ext_cfg(tcfg, win, canvas, band=(2000, 50),
                              lane_rows=lane_rows, steps_per_pass=1024,
                              steps_per_flush=64, replay_capacity=1 << 13),
                     device="cpu")
    st = _run(eng, eng.init_state(None), 8)
    pstats = eng.stats(st)
    assert eng.histogram(st).sum() == pstats["on_canvas_points"]
    ocfg = tcfg.RenderConfig(
        canvas=tcfg.Canvas(**canvas), sample_domain=win,
        band=tcfg.IterationBand(max_escape_iterations=2000,
                                min_escape_iterations=50),
        options=tcfg.EngineOptions(engine="oracle", precision="extended",
                                   oracle_samples_per_pass=1 << 13))
    oeng = OracleEngine(ocfg, device="cpu")
    ostats = oeng.stats(_run(oeng, oeng.init_state(None), 2))
    assert pstats["culled"] == 0 and ostats["culled"] == 0
    p_band = pstats["in_band"] / (pstats["samples"] - lane_rows * 128)
    o_band = ostats["in_band"] / ostats["samples"]
    assert abs(p_band / o_band - 1) < 0.15, (p_band, o_band)
    p_mass = pstats["orbit_points"] / max(pstats["emitted"], 1)
    o_mass = ostats["orbit_points"] / max(ostats["in_band"], 1)
    assert abs(p_mass / o_mass - 1) < 0.15, (p_mass, o_mass)


def test_extended_emit_filter_pads_the_window_on_both_sides():
    """hi-only visit tests carry ~2^-24 slop: the extended window is padded
    by max(4 pixels, 2^-21) on both sides (the JAX engine's), and gating
    still loses nothing that deposits."""
    win = _window(1e-5)
    canvas = dict(width=32, height=32, min_real=win[0], max_real=win[1],
                  min_imag=win[2], max_imag=win[3])
    kw = dict(band=(2000, 50), steps_per_pass=1024, steps_per_flush=64,
              replay_capacity=1 << 13, lane_rows=16)
    gated = CudaEngine(_ext_cfg(tcfg, win, canvas, emit_filter="canvas",
                                **kw), device="cpu")
    jgated = jpe.PallasEngine(_ext_cfg(jcfg, win, canvas,
                                       emit_filter="canvas", **kw))
    assert gated.visit_window == jgated.visit_window
    pad = 4 * 1e-5 / 32  # 4 pixels, above the f32 quantum 2^-21
    np.testing.assert_allclose(
        gated.visit_window,
        (win[0] - pad, win[1] + pad, win[2] - pad, win[3] + pad), rtol=1e-12)
    tiny = _window(2e-7)
    narrow = CudaEngine(_ext_cfg(tcfg, tiny, dict(
        width=32, height=32, min_real=tiny[0], max_real=tiny[1],
        min_imag=tiny[2], max_imag=tiny[3]), emit_filter="canvas"),
        device="cpu")
    assert narrow.visit_window[0] == tiny[0] - 2.0 ** -21
    f32 = CudaEngine(tcfg.RenderConfig(options=tcfg.EngineOptions(
        emit_filter="canvas", lane_rows=2)), device="cpu")
    assert f32.visit_window[0] == -2.0  # the f32 window pads above only
    plain = CudaEngine(_ext_cfg(tcfg, win, canvas, **kw), device="cpu")
    hg = gated.histogram(sg := _run(gated, gated.init_state(None), 2))
    hp = plain.histogram(sp := _run(plain, plain.init_state(None), 2))
    np.testing.assert_array_equal(hg, hp)
    assert hp.sum() > 0
    assert gated.stats(sg)["emitted"] <= plain.stats(sp)["emitted"]


def test_extended_tuning_and_refusals():
    """Auto geometry at the deep-zoom configuration: a function of the
    configuration alone; the f32 lane-step budget; the op counts of the
    df32 kernel pick the inner window at sparse bands."""
    win = _window(1e-5)
    cfg = tcfg.RenderConfig(
        canvas=tcfg.Canvas(width=1000, height=1000, min_real=win[0],
                           max_real=win[1], min_imag=win[2],
                           max_imag=win[3]),
        band=tcfg.IterationBand(max_escape_iterations=20000,
                                min_escape_iterations=500),
        sample_domain=win,
        options=tcfg.EngineOptions(precision="extended"))
    tn = Tuning(cfg)
    assert tn.extended and tn.lanes == 262144
    # The df32 kernel is scored at every band (no emission-heavy shortcut
    # to U = 1): a window of four.
    assert (tn.steps_per_flush, tn.inner_unroll, tn.steps_per_pass,
            tn.replay_capacity) == (512, 4, 4096, 1 << 21)
    f32 = Tuning(dataclasses.replace(cfg, options=tcfg.EngineOptions()))
    assert not f32.extended and f32.steps_per_pass == tn.steps_per_pass
    sparse = Tuning(tcfg.RenderConfig(
        band=tcfg.IterationBand(max_escape_iterations=20000,
                                min_escape_iterations=2000),
        options=tcfg.EngineOptions(precision="extended")))
    assert sparse.inner_unroll == 4  # f32 picks 8: the df32 step dominates
    eng = CudaEngine(cfg, device="cpu")
    dev_bytes, _ = eng.memory_estimate()
    f32_bytes, _ = CudaEngine(
        dataclasses.replace(cfg, options=tcfg.EngineOptions()),
        device="cpu").memory_estimate()
    assert dev_bytes - f32_bytes == (
        262144 * 6 * 4  # six more lane-state words
        + (tn.emission_slots - f32.emission_slots) * 36
        + (tn.replay_capacity - f32.replay_capacity) * 12)
    with pytest.raises(tcfg.ConfigError, match="--engine oracle"):
        CudaEngine(dataclasses.replace(cfg, options=tcfg.EngineOptions(
            precision="float64")), device="cpu")
    with pytest.raises(tcfg.ConfigError, match="thin escape tracking"):
        tcfg.EngineOptions(precision="extended",
                           escape_tracking="step").validate()
    # A device share at extended precision: refused where the engine is
    # built, with the JAX engine's message.
    with pytest.raises(tcfg.ConfigError, match="replay-device-share does "
                       "not apply to extended-precision renders"):
        CudaEngine(dataclasses.replace(cfg, options=tcfg.EngineOptions(
            precision="extended", replay="host", replay_device_share=0.5)),
            device="cpu")
    with pytest.raises(ValueError, match="lane state has 3 arrays"):
        convert.state_from_jax({"hist": np.zeros((2, 2), np.uint32),
                                "lanes": (1, 2, 3)})


def test_cpu_engine_replays_on_the_calling_stream():
    """The fused replay's side streams exist on the card only: a CPU
    engine has none, and waiting for them is a no-op."""
    eng = CudaEngine(_ext_cfg(tcfg), device="cpu")
    assert eng.replay_streams == []
    eng.wait_replay()
