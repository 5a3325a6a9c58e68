"""The Metropolis-Hastings branch of cudabrot_tpu_torch's engine on the CPU
(plain versions of the kernels): the port's forms of the engine-level tests
of tests/test_mh.py, the geometry it tunes, and the state's way to and from
the JAX engine.

Exact accounting is the backbone: every deposited count is a fixed-point
importance weight in 1/256 units, so the histogram total equals the
deposited-mass tally exactly, and a run is bitwise reproducible at a fixed
seed. The statistical contract (an MH render is the uniform render's
measure) is in tests/test_torch_mh_measure.py.
"""

import jax
import numpy as np
import pytest
import torch

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.engines.pallas_engine import PallasEngine
from cudabrot_tpu.engines.pallas_engine import Tuning as JaxTuning
from cudabrot_tpu_torch import convert
from cudabrot_tpu_torch.config import (
    Canvas,
    ConfigError,
    EngineOptions,
    IterationBand,
    RenderConfig,
)
from cudabrot_tpu_torch.engines import make_engine
from cudabrot_tpu_torch.engines.cuda_engine import (
    MAX_REPLAY_CAPACITY,
    CudaEngine,
    Tuning,
)
from cudabrot_tpu_torch.ops import classify_mh as cmh
from cudabrot_tpu_torch.ops import launches
from cudabrot_tpu_torch.utils import counters

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

CROP = dict(width=40, height=40, min_real=-0.78, max_real=-0.72,
            min_imag=0.05, max_imag=0.11)
BAND = dict(max_escape_iterations=300, min_escape_iterations=20)
_SEAHORSE = (-0.743643887, 0.131825904)


def _mh_cfg(options=None, canvas=None, band=None, **kw):
    opts = dict(sampler="mh", lane_rows=8, mh_burnin_passes=1,
                steps_per_flush=128, steps_per_pass=2048)
    opts.update(options or {})
    return RenderConfig(
        canvas=Canvas(**(canvas or CROP)),
        band=IterationBand(**(band or BAND)), seconds_to_run=-1.0,
        options=EngineOptions(**opts), **kw)


def _deep_cfg(span, sampler="mh", max_it=1500, min_it=50, **options):
    """The deep crops of tests/test_mh.py: a span-wide canvas at the
    seahorse valley over a sample domain 4x as wide, df32 orbit."""
    cx, cy = _SEAHORSE
    h = span / 2.0
    opts = dict(sampler=sampler, precision="extended", lane_rows=2,
                steps_per_pass=4096, steps_per_flush=256, inner_unroll=4)
    if sampler == "mh":
        opts["mh_burnin_passes"] = 0
    opts.update(options)
    return RenderConfig(
        canvas=Canvas(width=32, height=32, min_real=cx - h, max_real=cx + h,
                      min_imag=cy - h, max_imag=cy + h),
        band=IterationBand(max_escape_iterations=max_it,
                           min_escape_iterations=min_it),
        sample_domain=(cx - 2 * span, cx + 2 * span,
                       cy - 2 * span, cy + 2 * span),
        seconds_to_run=-1.0, options=EngineOptions(**opts))


def _run(cfg, passes, flush_after=()):
    eng = CudaEngine(cfg, device="cpu")
    state = eng.init_state(None)
    for p in range(passes):
        state = eng.run_pass(state, p)
        if p in flush_after:
            eng.histogram(state)
    return eng.histogram(state), eng.stats(state), state


# ------------------------------------------------------------ the gates


def test_make_engine_gates():
    with pytest.raises(ConfigError, match="cuda engine only"):
        make_engine(_mh_cfg(options={"engine": "oracle"}), device="cpu")
    # uint64 and --replay host deposit on the host; a device share has no
    # replay to split (the JAX messages).
    for opts in ({"hist_dtype": "uint64"}, {"replay": "host"}):
        assert make_engine(_mh_cfg(options=opts),
                           device="cpu").replay_mode == "host"
    with pytest.raises(ConfigError, match="no replay to split"):
        make_engine(_mh_cfg(options={"replay_device_share": 0.5}),
                    device="cpu")
    # MH runs data-parallel, never on row shards (the JAX message).
    with pytest.raises(ConfigError, match="incompatible with row-sharded"):
        make_engine(_mh_cfg(options={"num_devices": 2,
                                     "histogram_sharding": "rows"}),
                    device="cpu")
    assert make_engine(_mh_cfg(options={"num_devices": 2}),
                       device="cpu").name == "dp(cuda)"
    with pytest.raises(ConfigError, match="hardware generator"):
        _mh_cfg(options={"refill_rng": "hardware_rw"})
    eng = make_engine(_mh_cfg(), device="cpu")
    assert eng.name == "cuda" and eng.mh and eng.weight_scale == 256
    assert not make_engine(
        RenderConfig(options=EngineOptions(lane_rows=1, steps_per_pass=64,
                                           steps_per_flush=32)),
        device="cpu").mh


# ---------------------------------------------------------- the geometry


def test_tuning_mh_flush_window_and_capacity():
    """The flush window aims at one retirement per lane and is at least 8
    mean in-band orbits long (the JAX engine's rule); capacity is exactly
    one emission per lane per flush window."""
    shallow = Tuning(_mh_cfg(options={"steps_per_flush": 0,
                                      "steps_per_pass": 0}))
    jshallow = JaxTuning(jcfg.RenderConfig(
        canvas=jcfg.Canvas(**CROP), band=jcfg.IterationBand(**BAND),
        options=jcfg.EngineOptions(sampler="mh", lane_rows=8)))
    assert shallow.mh and jshallow.mh
    assert shallow.steps_per_flush == jshallow.steps_per_flush
    deep_band = dict(max_escape_iterations=20000, min_escape_iterations=500)
    deep = Tuning(_mh_cfg(band=deep_band, options={
        "steps_per_flush": 0, "steps_per_pass": 0, "lane_rows": 2048}))
    assert deep.steps_per_flush == 16384 == JaxTuning(jcfg.RenderConfig(
        band=jcfg.IterationBand(**deep_band),
        options=jcfg.EngineOptions(sampler="mh"))).steps_per_flush
    assert deep.inner_unroll > 1  # no U=1 shortcut for MH
    for tn in (shallow, deep):
        windows = tn.steps_per_pass // tn.steps_per_flush
        assert tn.steps_per_pass % tn.steps_per_flush == 0
        assert tn.emission_slots == windows * tn.lanes
        assert tn.replay_capacity >= tn.emission_slots
    assert deep.replay_capacity == deep.emission_slots == 262144


def test_tuning_mh_shortens_the_pass_at_the_capacity_ceiling():
    tn = Tuning(_mh_cfg(options={"lane_rows": 2048, "steps_per_flush": 32,
                                 "steps_per_pass": 32 * 64}))
    assert tn.replay_capacity == MAX_REPLAY_CAPACITY
    assert tn.emission_slots == MAX_REPLAY_CAPACITY
    assert tn.steps_per_pass == 32 * (MAX_REPLAY_CAPACITY // tn.lanes)


def test_memory_estimate_counts_the_reservoirs():
    small = CudaEngine(_mh_cfg(options={"mh_visit_slots": 2}), device="cpu")
    wide = CudaEngine(_mh_cfg(options={"mh_visit_slots": 32}), device="cpu")
    dev_s, host_s = small.memory_estimate()
    dev_w, host_w = wide.memory_estimate()
    assert host_s == host_w > 0
    per_slot = (2 * small.lanes + small.tuning.emission_slots) * 4
    assert dev_w - dev_s == 30 * per_slot


# ------------------------------------------------------------ accounting


def test_mass_accounting_and_determinism():
    launches.reset()
    h1, s1, _ = _run(_mh_cfg(), 3)
    assert launches.COUNTS["classify_mh_plain"] == 3
    assert launches.COUNTS["mh_deposit_plain"] == 3  # 2 passes + the tail
    assert launches.COUNTS["classify_mh"] == launches.COUNTS["mh_deposit"] == 0
    assert s1["weight_scale"] == cmh.WEIGHT_SCALE == 256
    assert int(h1.sum()) == s1["on_canvas_points"] == s1["mh_deposited"] > 0
    assert s1["mh_lost_weight"] == 0 and s1["replay_dropped"] == 0
    assert s1["mh_accepts"] > 0 and s1["replay"] == "device"
    for k in ("mh_merges", "mh_merged_rep", "emitted", "orbit_points"):
        assert s1[k] >= 0
    assert s1["orbit_points"] <= 8 * (s1["emitted"] + 8 * 128)
    h2, s2, _ = _run(_mh_cfg(), 3)
    np.testing.assert_array_equal(h1, h2)
    assert s1 == s2
    h3, _, _ = _run(_mh_cfg(seed=99), 3)
    assert not np.array_equal(h1, h3)


def test_stats_keys_match_jax():
    """The MH engine reports the JAX MH engine's stats under the same
    names, and the first pass's orbit-independent totals agree exactly:
    every lane-step is counted as useful or wasted in both."""
    import cudabrot_tpu.engines.pallas_engine as jpe

    opts = dict(sampler="mh", lane_rows=8, mh_burnin_passes=0,
                steps_per_flush=128, steps_per_pass=1024, inner_unroll=4)
    jeng = PallasEngine(jcfg.RenderConfig(
        canvas=jcfg.Canvas(**CROP), band=jcfg.IterationBand(**BAND),
        seconds_to_run=-1.0, options=jcfg.EngineOptions(**opts)))
    jstats = jeng.stats(jeng.run_pass(jeng.init_state(None), 0))
    _, tstats, _ = _run(_mh_cfg(options=opts), 1)
    assert set(tstats) == set(jstats)
    assert counters.MH_STAT_KEYS == jpe.MH_STAT_KEYS
    lane_steps = 1024 * 8 * 128
    for st in (jstats, tstats):
        assert st["classify_iters"] + st["wasted_steps"] == lane_steps
        assert st["weight_scale"] == 256 and st["mh_lost_weight"] == 0
        assert st["on_canvas_points"] == st["mh_deposited"]


def test_burnin_discards_early_deposits():
    h0, _, _ = _run(_mh_cfg(options={"mh_burnin_passes": 0}), 3)
    h2, _, _ = _run(_mh_cfg(options={"mh_burnin_passes": 2}), 3)
    assert int(h0.sum()) > int(h2.sum()) > 0


def test_burnin_only_run_deposits_nothing():
    """A run that never leaves burn-in leaves a zero histogram: tenure mass
    gathered during burn-in must not leak through the tail flush."""
    h, s, state = _run(_mh_cfg(options={"mh_burnin_passes": 1}), 1)
    assert int(h.sum()) == 0 and s["mh_deposited"] == 0
    assert s["mh_accepts"] > 0
    assert int(state["lanes"].rep.sum()) == 0


def test_tail_flush_is_additive_at_any_call_point():
    """Reading the histogram mid-run splits every live tenure in two. The
    chains do not notice (acceptance never reads rep), so the lane state
    ends bitwise equal but for rep's history; each split tenure deposits
    floor(a) + floor(b) in place of floor(a + b), so the total falls short
    by less than one unit per split, never more."""
    cfg = _mh_cfg(options={"mh_rep_cap": 32767})
    h_end, s_end, st_end = _run(cfg, 4)
    h_mid, s_mid, st_mid = _run(cfg, 4, flush_after=(1, 2))
    for s, h in ((s_end, h_end), (s_mid, h_mid)):
        assert int(h.sum()) == s["mh_deposited"] == s["on_canvas_points"]
    for f in cmh.MhLaneState._fields:
        if f != "rep":
            assert torch.equal(getattr(st_end["lanes"], f),
                               getattr(st_mid["lanes"], f)), f
    assert s_end["mh_accepts"] == s_mid["mh_accepts"]
    short = s_end["mh_deposited"] - s_mid["mh_deposited"]
    assert 0 <= short <= 2 * 8 * 128, short
    # Reading twice in a row adds nothing the second time.
    eng = CudaEngine(cfg, device="cpu")
    state = eng.init_state(None)
    for p in range(2):
        eng.run_pass(state, p)
    np.testing.assert_array_equal(eng.histogram(state), eng.histogram(state))


def test_reservoir_merge_conserves_mass():
    """A short flush window forces pending-slot collisions; they are
    merges, so the accounting stays exact and no weight is lost."""
    h, s, _ = _run(_mh_cfg(options={"steps_per_flush": 64,
                                    "mh_burnin_passes": 0}), 4)
    assert s["mh_merges"] > 0 and s["mh_merged_rep"] >= s["mh_merges"]
    assert int(h.sum()) == s["on_canvas_points"] == s["mh_deposited"] > 0
    assert s["mh_lost_weight"] == 0


def test_explicit_capacity_below_one_slot_per_lane_window_is_refused():
    """An MH drop would lose weighted mass, so an explicit capacity must
    hold every emission slot of the pass: a smaller one is refused, and an
    ample one renders bitwise what the auto capacity renders."""
    base = {"mh_burnin_passes": 0}
    slots = Tuning(_mh_cfg(options=base)).emission_slots
    with pytest.raises(ConfigError, match="emission slots"):
        Tuning(_mh_cfg(options={**base, "replay_capacity": slots - 1}))
    h_auto, s_auto, _ = _run(_mh_cfg(options=base), 3)
    h_ample, s_ample, _ = _run(
        _mh_cfg(options={**base, "replay_capacity": 2 * slots}), 3)
    np.testing.assert_array_equal(h_auto, h_ample)
    assert s_auto == s_ample and s_auto["replay_dropped"] == 0


@pytest.mark.parametrize("fractal,canvas,band", [
    ("anti-buddhabrot",
     dict(width=40, height=40, min_real=-0.6, max_real=0.1, min_imag=-0.4,
          max_imag=0.3),
     dict(max_escape_iterations=64, min_escape_iterations=0)),
    ("burning-ship",
     dict(width=40, height=40, min_real=-1.8, max_real=-1.6, min_imag=-0.1,
          max_imag=0.1), None),
])
def test_other_fractals(fractal, canvas, band):
    h, s, _ = _run(_mh_cfg(fractal=fractal, canvas=canvas, band=band), 3)
    assert int(h.sum()) == s["on_canvas_points"] > 0
    assert s["mh_accepts"] > 0
    if fractal == "burning-ship":
        assert s["cycles_detected"] == 0


def test_bridge_seeds_tiny_window_from_full_domain():
    """A window 2.5e-7 of the sample domain's area: seeding by restarts
    that land on the visiting set is hopeless; with the in-band epsilon the
    chains seed on the in-band set and walk to the filaments, so deposits
    appear within a few passes."""
    h, s, _ = _run(_mh_cfg(
        canvas=dict(width=40, height=40, min_real=-0.7446, max_real=-0.7426,
                    min_imag=0.1309, max_imag=0.1329),
        options={"steps_per_pass": 8192}), 4)
    assert s["mh_accepts"] > 0
    assert int(h.sum()) == s["on_canvas_points"] > 0


# ----------------------------------------------------------- extended MH


def test_ext_mh_accounting_and_determinism():
    """Extended MH at a 2e-5 window, far below f32's usable floor."""
    cfg = _deep_cfg(2e-5, max_it=3000, min_it=100)
    launches.reset()
    h1, s1, _ = _run(cfg, 3)
    assert launches.COUNTS["classify_ext_mh_plain"] == 3
    assert int(h1.sum()) == s1["on_canvas_points"] == s1["mh_deposited"] > 0
    assert s1["replay_dropped"] == 0 and s1["weight_scale"] == 256
    h2, _, _ = _run(cfg, 3)
    np.testing.assert_array_equal(h1, h2)


def test_ext_mh_signal_dominates_uniform_at_deep_window():
    """The point of deep-zoom MH: at a 1e-4 window even a sample domain 4x
    the window starves uniform sampling; MH deposits orders of magnitude
    more mass at equal passes (the JAX test asks for 50x)."""
    mh_h, _, _ = _run(_deep_cfg(1e-4), 6)
    un_h, un_s, _ = _run(_deep_cfg(1e-4, sampler="uniform",
                                   replay_capacity=1 << 12), 6)
    assert un_s["replay_dropped"] == 0
    mh_mass = int(mh_h.sum()) / cmh.WEIGHT_SCALE
    assert mh_mass > 50 * max(int(un_h.sum()), 1), (mh_mass, int(un_h.sum()))


def test_ext_window_test_resolves_below_f32_ulp():
    """At spans below the f32 ulp of the centre the absolute f32 canvas
    bounds collapse to an empty interval. The df32 pass tests
    (z.hi - c.hi) + (z.lo - c.lo) against centre-relative bounds; positions
    +-2.5e-9 from the centre must fall inside a 1e-8 window, +-7e-9 outside,
    and land in the right column of a 10-pixel bin map."""
    from cudabrot_tpu_torch.ops import df32

    cx = _SEAHORSE[0]
    half = 0.5e-8
    assert np.float32(cx - half) == np.float32(cx + half)
    c_hi, c_lo = (torch.tensor(v, dtype=torch.float32)
                  for v in df32.from_float(cx))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    bin_map = (f32(-half), f32(-half), f32(10 / (2 * half)),
               f32(10 / (2 * half)), 10, 10)
    for offset, inside, col in ((2.5e-9, True, 7), (-2.5e-9, True, 2),
                                (7e-9, False, None), (-7e-9, False, None)):
        z_hi, z_lo = (f32(v) for v in df32.from_float(cx + offset))
        dr = (z_hi - c_hi) + (z_lo - c_lo)
        vis = (dr >= f32(-half)) & (dr < f32(half))
        assert bool(vis) == inside, (offset, float(dr))
        _, vb = cmh.record_visit(
            vis[None], dr[None], f32(0.0)[None],
            torch.zeros(1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32),
            torch.full((2, 1), -1, dtype=torch.int32), bin_map)
        assert int(vb[0, 0]) == (5 * 10 + col if inside else -1)


# ------------------------------------------- to and from the JAX engine


@pytest.mark.parametrize("ext", [False, True])
def test_convert_round_trip_and_continue_from_jax(ext):
    """A JAX MH state (one interpret-mode pass) converts to the port's
    state and back without loss, and the port's engine continues from it
    with exact accounting."""
    if ext:
        cfg = _deep_cfg(1e-3, max_it=1000, steps_per_pass=1024)
        cx, cy = _SEAHORSE
        jc = jcfg.RenderConfig(
            canvas=jcfg.Canvas(
                width=32, height=32, min_real=cx - 5e-4, max_real=cx + 5e-4,
                min_imag=cy - 5e-4, max_imag=cy + 5e-4),
            band=jcfg.IterationBand(max_escape_iterations=1000,
                                    min_escape_iterations=50),
            sample_domain=cfg.sample_domain, seconds_to_run=-1.0,
            options=jcfg.EngineOptions(
                sampler="mh", precision="extended", lane_rows=2,
                steps_per_pass=1024, steps_per_flush=256, inner_unroll=4,
                mh_burnin_passes=0))
    else:
        cfg = _mh_cfg(options={"mh_burnin_passes": 0, "inner_unroll": 4})
        jc = jcfg.RenderConfig(
            canvas=jcfg.Canvas(**CROP), band=jcfg.IterationBand(**BAND),
            seconds_to_run=-1.0,
            options=jcfg.EngineOptions(
                sampler="mh", lane_rows=8, steps_per_pass=2048,
                steps_per_flush=128, inner_unroll=4, mh_burnin_passes=0))
    jeng = PallasEngine(jc)
    jstate = jeng.run_pass(jeng.init_state(None), 0)
    np_state = jax.tree.map(np.asarray, jstate)
    state = convert.state_from_jax(np_state)
    lane_cls = cmh.ExtMhLaneState if ext else cmh.MhLaneState
    assert isinstance(state["lanes"], lane_cls)
    assert "dfc" not in state
    for k in counters.MH_STAT_KEYS:
        assert k in state
    back = convert.state_to_numpy(state)
    assert set(back) == set(np_state)
    np.testing.assert_array_equal(back["hist"], np_state["hist"])
    for f, a, b in zip(lane_cls._fields, back["lanes"], np_state["lanes"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for k in counters.STAT_KEYS + counters.MH_STAT_KEYS:
        assert tuple(int(v) for v in back[k]) == \
            tuple(int(v) for v in np_state[k]), k

    eng = CudaEngine(cfg, device="cpu")
    jstats = jeng.counter_stats(jstate)
    assert eng.stats(state)["mh_accepts"] == jstats["mh_accepts"]
    before = int(np_state["hist"].sum())
    for p in (1, 2):
        eng.run_pass(state, p)
    h, s = eng.histogram(state), eng.stats(state)
    assert int(h.sum()) == s["mh_deposited"] == s["on_canvas_points"] > before
    assert s["mh_accepts"] > jstats["mh_accepts"]
    # And back: a state of the port has the layout the JAX engine inits.
    fresh = jax.tree.map(np.asarray, jeng.init_state(None))
    out = convert.state_to_numpy(eng.init_state(None))
    for a, b in zip(out["lanes"], fresh["lanes"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_convert_rejects_unknown_lane_tuple():
    with pytest.raises(ValueError, match="MhLaneState"):
        convert.state_from_jax({"hist": np.zeros((2, 2), np.uint32),
                                "lanes": (np.zeros((1, 128)),) * 7})
