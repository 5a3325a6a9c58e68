"""The cudabrot_tpu_torch engine (CPU: the kernels' plain versions) vs the
JAX Pallas engine (interpret mode, device replay).

Bitwise where the inputs are identical: compaction of given emission
arrays (both branches), state conversion, stat keys. Statistical for the
whole slice: both engines draw the same Threefry samples at one seed and
geometry, but the JAX kernel's jitted orbits are FMA-contracted on the
CPU, so a few lanes diverge.
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
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine, Tuning, compact
from cudabrot_tpu_torch.ops import launches, prng
from cudabrot_tpu_torch.utils import counters


def _cfg(mod, canvas=(32, 32), band=(50, 3), **opt):
    base = dict(lane_rows=8, steps_per_pass=256, steps_per_flush=16,
                replay_capacity=1 << 14)
    base.update(opt)
    if mod is jcfg:
        base.update(engine="pallas", replay="device")
    return mod.RenderConfig(
        canvas=mod.Canvas(width=canvas[0], height=canvas[1]),
        band=mod.IterationBand(max_escape_iterations=band[0],
                               min_escape_iterations=band[1]),
        options=mod.EngineOptions(**base),
    )


def _run(eng, state, passes, start=0):
    for p in range(start, start + passes):
        state = eng.run_pass(state, p)
    return state


@pytest.mark.parametrize("max_it,capacity", [
    (100, 1024),     # packed 11-bit key sorts; capacity overflow thinned
    (100, 8192),     # packed; everything fits
    (2000, 1024),    # max_it + 1 >= 1024: stable argsort branch
])
def test_compaction_matches_jax(monkeypatch, max_it, capacity):
    rows, chunks, seed, pass_index = 4, 8, 99, 3
    rng = np.random.default_rng(max_it + capacity)
    emit_c = rng.uniform(-2, 2, (chunks, 2, rows, 128)).astype(np.float32)
    emit_it = rng.integers(0, max_it, (chunks, rows, 128)).astype(np.int32)
    emit_it[rng.uniform(size=emit_it.shape) < 0.4] = -1
    cfg = _cfg(jcfg, band=(max_it, 1), lane_rows=rows,
               steps_per_pass=chunks * 16, replay_capacity=capacity)
    cfg = dataclasses.replace(cfg, seed=seed)
    eng = jpe.PallasEngine(cfg)

    def fake_classify(state, *a, **k):
        return jpe.pk.ClassifyResult(
            state=state, emit_c=jnp.asarray(emit_c),
            emit_it=jnp.asarray(emit_it),
            stats=jnp.zeros((5, rows, 128), jnp.int32))

    monkeypatch.setattr(jpe.pk, "classify_pass", fake_classify)
    _, (jcr, jci, jit, _, _) = eng._classify_and_compact(
        eng.init_state(None), pass_index, ordinal=jnp.uint32(0))
    cr, ci, it, n_valid = compact(
        torch.from_numpy(emit_c), torch.from_numpy(emit_it),
        prng.pass_key(seed, 0, pass_index), capacity, max_it)
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(cr.numpy().view(np.int32),
                                  np.asarray(jcr).view(np.int32))
    np.testing.assert_array_equal(ci.numpy().view(np.int32),
                                  np.asarray(jci).view(np.int32))
    assert int(n_valid) == int((emit_it >= 0).sum())


def test_state_conversion_round_trip():
    eng = jpe.PallasEngine(_cfg(jcfg))
    js = jax.tree.map(np.asarray, _run(eng, eng.init_state(None), 2))
    # A counter above 2^32 survives the (lo, hi) <-> int64 conversion.
    js["points"] = (np.uint32(7), np.uint32(3))
    back = convert.state_to_numpy(convert.state_from_jax(js))
    np.testing.assert_array_equal(back["hist"], js["hist"])
    assert back["hist"].dtype == np.uint32
    for a, b in zip(back["lanes"], js["lanes"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in counters.STAT_KEYS:
        assert tuple(map(int, back[k])) == tuple(map(int, js[k])), k
    assert counters.value(convert.state_from_jax(js)["points"]) == (3 << 32) + 7


def test_stats_keys_match_jax():
    jeng = jpe.PallasEngine(_cfg(jcfg))
    teng = CudaEngine(_cfg(tcfg), device="cpu")
    jstats = jeng.stats(_run(jeng, jeng.init_state(None), 1))
    tstats = teng.stats(_run(teng, teng.init_state(None), 1))
    assert set(tstats) == set(jstats)
    assert counters.STAT_KEYS == jpe.STAT_KEYS
    lane_steps = 256 * 8 * 128
    assert tstats["classify_iters"] + tstats["wasted_steps"] == lane_steps
    assert tstats["replay"] == "device"


def test_engine_continues_a_jax_render():
    """Both engines resume one JAX state for two more passes: the
    histograms and counters stay close (FMA drift only)."""
    jeng = jpe.PallasEngine(_cfg(jcfg))
    teng = CudaEngine(_cfg(tcfg), device="cpu")
    js = _run(jeng, jeng.init_state(None), 2)
    ts = convert.state_from_jax(jax.tree.map(np.asarray, js))
    js, ts = _run(jeng, js, 2, start=2), _run(teng, ts, 2, start=2)
    jh, th = jeng.histogram(js), teng.histogram(ts)
    assert np.corrcoef(jh.ravel(), th.ravel())[0, 1] > 0.999
    jst, tst = jeng.stats(js), teng.stats(ts)
    for k in ("samples", "in_band", "emitted", "orbit_points"):
        assert abs(tst[k] / jst[k] - 1) < 0.01, (k, tst[k], jst[k])
    same_c = (np.asarray(js["lanes"][0]) == ts["lanes"].cr.numpy()).mean()
    assert same_c >= 0.97, same_c


def test_whole_slice_statistical_vs_jax_engine():
    """The criteria of test_pallas_engine's oracle equivalence: mass per
    emission and in-band fraction within 5%, normalized-histogram corr >
    0.99. Same seed and geometry, so the engines draw the same samples:
    measured corr 0.999998, mass and fraction ratios within 0.05%."""
    jeng = jpe.PallasEngine(_cfg(jcfg))
    teng = CudaEngine(_cfg(tcfg), device="cpu")
    jh = jeng.histogram(js := _run(jeng, jeng.init_state(None), 8))
    launches.reset()
    th = teng.histogram(ts := _run(teng, teng.init_state(None), 8))
    assert launches.COUNTS["classify_plain"] == 8
    assert launches.COUNTS["replay_deposit_plain"] == 8
    jst, tst = jeng.stats(js), teng.stats(ts)
    assert tst["on_canvas_points"] == th.sum() > 0
    j_rate = jh.sum() / max(jst["emitted"], 1)
    t_rate = th.sum() / max(tst["emitted"], 1)
    assert abs(t_rate / j_rate - 1) < 0.05, (t_rate, j_rate)
    j_band = jst["in_band"] / (jst["samples"] - jst["culled"])
    t_band = tst["in_band"] / (tst["samples"] - tst["culled"])
    assert abs(t_band / j_band - 1) < 0.05, (t_band, j_band)
    p = th.astype(np.float64) / th.sum()
    q = jh.astype(np.float64) / jh.sum()
    assert np.corrcoef(p.ravel(), q.ravel())[0, 1] > 0.99


def test_emit_filter_canvas_is_bitwise_invisible():
    """Gating emissions on canvas visits drops only orbits that deposit
    nothing: the classify trajectory is the replay trajectory (both round
    each operation once). On the JAX emit-filter test's seahorse crop and
    geometry (tests/test_emit_filter.py), the gated render is bitwise the
    ungated one."""
    canvas = tcfg.Canvas(width=40, height=40, min_real=-0.78,
                         max_real=-0.72, min_imag=0.05, max_imag=0.11)
    runs = []
    for filt in ("any", "canvas"):
        cfg = dataclasses.replace(
            _cfg(tcfg, band=(300, 20), steps_per_pass=512,
                 steps_per_flush=32, emit_filter=filt),
            canvas=canvas)
        eng = CudaEngine(cfg, device="cpu")
        st = _run(eng, eng.init_state(None), 4)
        runs.append((eng.histogram(st), eng.stats(st)))
    (h_any, s_any), (h_gate, s_gate) = runs
    assert s_any["replay_dropped"] == 0 == s_gate["replay_dropped"]
    assert h_any.sum() > 0
    np.testing.assert_array_equal(h_gate, h_any)
    assert s_gate["samples"] == s_any["samples"]
    assert 0 < s_gate["emitted"] < s_any["emitted"]


def test_lane_state_persists_across_passes():
    """Orbits longer than one pass finish in a later one (no truncation)."""
    cfg = _cfg(tcfg, band=(2000, 300), steps_per_pass=128,
               replay_capacity=1 << 12)
    eng = CudaEngine(cfg, device="cpu")
    assert eng.stats(_run(eng, eng.init_state(None), 12))["in_band"] > 0


@pytest.mark.parametrize("band,flush,unroll,steps,capacity", [
    ((100, 20), 128, 1, 4096, 1 << 23),
    ((20000, 2000), 4096, 8, 4096, 1 << 14),
])
def test_tuning_h100_geometry(band, flush, unroll, steps, capacity):
    """Auto geometry starts from the H100: 262,144 lanes, 2^30 lane-steps
    per pass; it depends on the configuration alone (no device input), so
    CPU and CUDA runs draw the same streams."""
    cfg = tcfg.RenderConfig(band=tcfg.IterationBand(
        max_escape_iterations=band[0], min_escape_iterations=band[1]))
    tn = Tuning(cfg)
    assert tn.lanes == 262144
    assert (tn.steps_per_flush, tn.inner_unroll, tn.steps_per_pass,
            tn.replay_capacity) == (flush, unroll, steps, capacity)
    eng = CudaEngine(cfg, device="cpu")
    assert vars(eng.tuning) == vars(tn)
    pinned = Tuning(_cfg(tcfg, inner_unroll=4, replay_capacity=5000))
    assert (pinned.steps_per_pass, pinned.steps_per_flush, pinned.inner_unroll,
            pinned.replay_capacity) == (256, 16, 4, 5000)
