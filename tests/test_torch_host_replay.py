"""The port's host orbit replay (``cudabrot_tpu_torch/engines/host_replay.py``
and the host and hybrid modes of ``CudaEngine``) against the JAX package's
(``cudabrot_tpu/engines/host_replay.py``, ``PallasEngine.host_pass``).

Bitwise where the inputs are identical: each payload layout packed from one
compacted batch and decoded by each package's worker, the MH deposit, uint64
against uint32, the hybrid's accounting. Host mode against device mode: the
same samples, so every count but ``on_canvas_points`` is equal; the
histograms differ only where a point lies on a bin edge (the native replay
multiplies by a float32 reciprocal of the pitch, the port's device replay
divides), and at extended precision by the f64 replay's statistical
contract with the df32 one. Refusals keep the JAX package's messages.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.engines import host_replay as jhr
from cudabrot_tpu.engines import pallas_engine as jpe
from cudabrot_tpu.io import native as jnative
from cudabrot_tpu_torch import cli
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.engines import make_engine
from cudabrot_tpu_torch.engines import host_replay as thr
from cudabrot_tpu_torch.engines.cuda_engine import (
    CudaEngine,
    Tuning,
    mh_payload,
)
from cudabrot_tpu_torch.io import checkpoint as ckpt
from cudabrot_tpu_torch.io import native
from cudabrot_tpu_torch.ops import binning

pytestmark = pytest.mark.skipif(
    not jnative.available(), reason="the JAX package's native library "
    "is not built")

torch.set_num_threads(1)

_ZOOM = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)
_MH_WIN = (-0.7466, -0.7406, 0.1289, 0.1349)
_MH_DOMAIN = (-0.7676, -0.7196, 0.1079, 0.1559)

#: Small configurations of each payload layout: (kwargs of RenderConfig
#: minus options, options).
LAYOUTS = {
    "packed": (dict(), dict()),
    "f32": (dict(sample_domain=(-2.0, 1.0, -1.5, 1.5)), dict()),
    "extended": (dict(sample_domain=_ZOOM, band=(400, 20)),
                 dict(precision="extended", steps_per_pass=512,
                      steps_per_flush=32)),
    "mh": (dict(canvas=_MH_WIN, sample_domain=_MH_DOMAIN, band=(500, 50)),
           dict(sampler="mh", lane_rows=4, steps_per_pass=2048,
                steps_per_flush=256, replay_capacity=0, mh_burnin_passes=1)),
}


def _cfg(mod, layout="packed", **opt):
    top, o = LAYOUTS[layout]
    top = dict(top)
    base = dict(lane_rows=8, steps_per_pass=256, steps_per_flush=16,
                replay_capacity=1 << 14)
    base.update(o)
    base.update(opt)
    if mod is jcfg:
        base.setdefault("replay", "host")
        base.update(engine="pallas")
    band = top.pop("band", (60, 5))
    win = top.pop("canvas", None)
    canvas = (dict(width=40, height=40) if win is None else dict(
        width=40, height=40, min_real=win[0], max_real=win[1],
        min_imag=win[2], max_imag=win[3]))
    return mod.RenderConfig(
        canvas=mod.Canvas(**canvas),
        band=mod.IterationBand(max_escape_iterations=band[0],
                               min_escape_iterations=band[1]),
        options=mod.EngineOptions(**base), **top)


def _render(cfg, passes=3, hist0=None):
    eng = make_engine(cfg, device="cpu")
    state = eng.init_state(hist0)
    for p in range(passes):
        state = eng.run_pass(state, p)
    return eng.histogram(state), eng.stats(state), eng


HOST_KEYS = ("replay", "replay_fetch_seconds", "replay_busy_seconds",
             "on_canvas_points")


def _counts(stats):
    return {k: v for k, v in stats.items() if k not in HOST_KEYS}


def _batch(layout, k, seed=0):
    """A synthetic compacted batch of ``k`` slots in the layout's domain:
    (cr, ci, iters) or, for MH, (iters, rep, t, bins)."""
    rng = np.random.default_rng(seed)
    it = rng.integers(-1, 60, k).astype(np.int32)
    it[rng.uniform(size=k) < 0.3] = -1
    if layout == "mh":
        rep = rng.integers(0, 5000, k).astype(np.int32)
        t = (256 * rng.integers(0, 40, k) + rng.integers(0, 2, k)).astype(
            np.int32)
        bins = rng.integers(0, 1600, (8, k)).astype(np.int32)
        return it, rep, t, bins
    if layout in ("packed", "extended"):
        kk = rng.integers(0, 1 << 24, (2, k))
        c = (kk.astype(np.float32) if layout == "extended" else
             kk.astype(np.float32) * np.float32(2.0 ** -22) - np.float32(2.0))
        return c[0], c[1], it
    c = rng.uniform(-2, 2, (2, k)).astype(np.float32)
    return c[0], c[1], it


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("layout", ["packed", "f32", "extended", "mh"])
def test_payload_decodes_as_the_jax_worker(monkeypatch, layout):
    """One compacted batch, packed by each package's host_pass code and
    decoded by each package's worker: the decoded arrays are equal bit for
    bit (the packed layout's words are equal too)."""
    tcfg_, jcfg_ = _cfg(tcfg, layout, replay="host"), _cfg(jcfg, layout)
    teng = CudaEngine(tcfg_, device="cpu")
    jeng = jpe.PallasEngine(jcfg_)
    assert jeng._worker is not None and teng.replay_mode == "host"
    assert teng.tuning.packed_payload == (layout == "packed")
    k = 4096
    batch = _batch(layout, k)
    if layout == "mh":
        it, rep, t, bins = batch
        fake = (jnp.asarray(bins), None, jnp.asarray(it), jnp.asarray(rep),
                jnp.asarray(np.where(it >= 0, t, 0)))
        payload = mh_payload(*(torch.from_numpy(x) for x in batch))
    else:
        fake = (*(jnp.asarray(x) for x in batch), None, None)
        payload = teng.pack_payload(*(torch.from_numpy(x) for x in batch))
    monkeypatch.setattr(jeng, "_classify_and_compact",
                        lambda state, *a, **kw: (state, fake))
    _, jn_valid, jpayload = jeng.host_pass({}, 0, jnp.uint32(0))
    n_valid = torch.tensor(int((batch[2 if layout != "mh" else 0] >= 0)
                               .sum()))
    assert int(jn_valid) == int(n_valid)
    if layout == "packed":
        np.testing.assert_array_equal(payload.numpy().view(np.uint32),
                                      np.asarray(jpayload))
    got = teng._worker._fetch(thr.Staged(None, n_valid, payload))
    want = jeng._worker._fetch(jn_valid, jpayload)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_host_pass_layouts():
    """host_pass's payload per layout, shape and dtype, and its valid count
    (the decoded batch's valid slots); an MH burn-in pass ships nothing."""
    for layout, (dtype, rows) in (("packed", (torch.int32, 2)),
                                  ("f32", (torch.float32, 3)),
                                  ("mh", (torch.int32, 3 + 8))):
        eng = CudaEngine(_cfg(tcfg, layout, replay="host"), device="cpu")
        state = eng.init_state(None)
        if layout == "mh":
            assert eng.host_pass(state, 0) is None  # burn-in
        n_valid, payload = eng.host_pass(state, 1)
        assert payload.dtype == dtype and payload.shape[0] == rows
        decoded = eng._worker._fetch(thr.Staged(None, n_valid, payload))
        valid = payload[0] >= 0 if layout == "mh" else decoded[2] >= 0
        assert int(n_valid) == int(valid.sum()) > 0


def test_packed_round_trip_is_exact():
    """The two-word layout rebuilds the kernel's c bit for bit and the
    escape index losslessly (k * 2^-22 - 2 is the sample grid)."""
    eng = CudaEngine(_cfg(tcfg, "packed", replay="host"), device="cpu")
    cr, ci, it = _batch("packed", 8192, seed=4)
    it[:3] = (0xFFFE, 0, -1)
    got = eng._worker._fetch(thr.Staged(None, torch.tensor(1),
                                        eng.pack_payload(
                                            *(torch.from_numpy(x)
                                              for x in (cr, ci, it)))))
    np.testing.assert_array_equal(_bits(got[0]), _bits(cr))
    np.testing.assert_array_equal(_bits(got[1]), _bits(ci))
    np.testing.assert_array_equal(got[2], it)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_mh_deposit_numpy_matches_jax_and_the_plain_deposit(dtype):
    rng = np.random.default_rng(9)
    n, v, nbins = 3000, 8, 900
    bins = rng.integers(0, nbins, (v, n)).astype(np.int32)
    t = (256 * rng.integers(1, 60, n) + 1).astype(np.int32)
    t[rng.uniform(size=n) < 0.2] = rng.integers(0, 2)  # nothing to deposit
    rep = rng.integers(0, 1 << 15, n).astype(np.int32)
    a = np.zeros(nbins, dtype)
    b = np.zeros(nbins, dtype)
    ra = thr.mh_deposit_numpy(a, bins, t, rep)
    rb = jhr.mh_deposit_numpy(b, bins, t, rep)
    assert ra == rb and ra[0] > 0
    np.testing.assert_array_equal(a, b)
    plain = torch.zeros(nbins, dtype=torch.int32)
    _, deposits, mass = binning.mh_scatter(
        plain, torch.from_numpy(bins), torch.from_numpy(t),
        torch.from_numpy(rep))
    assert (int(mass.sum()), int(deposits.sum())) == ra
    np.testing.assert_array_equal(plain.numpy().view(np.uint32),
                                  a.astype(np.uint32))
    # t in [2, 256] (one visit outside the band): no mass, and one recorded
    # bin, as the device deposit counts it.
    edge = np.array([2, 256], np.int32)
    one = np.zeros(nbins, dtype)
    got = thr.mh_deposit_numpy(one, bins[:, :2], edge, rep[:2])
    _, deposits, mass = binning.mh_scatter(
        torch.zeros(nbins, dtype=torch.int32), torch.from_numpy(bins[:, :2]),
        torch.from_numpy(edge), torch.from_numpy(rep[:2]))
    assert got == (int(mass.sum()), int(deposits.sum())) == (0, 2)
    assert not one.any()


@pytest.mark.parametrize("kind", ["float32", "burning-ship", "extended",
                                  "mh"])
def test_host_mode_matches_device_mode(kind):
    """The same seed through the device and the host replay: every count
    but on_canvas_points bitwise, each histogram's sum its on-canvas
    points; the histograms equal but at bin edges (MH: bitwise, its
    deposit is integer arithmetic on both sides; extended: the f64 replay
    against df32, statistically)."""
    layout = {"extended": "extended", "mh": "mh"}.get(kind, "packed")
    extra = {"fractal": "burning-ship"} if kind == "burning-ship" else {}
    base = _cfg(tcfg, layout)
    if extra:
        base = dataclasses.replace(base, **extra)
    hd, sd, _ = _render(base)
    host = dataclasses.replace(base, options=dataclasses.replace(
        base.options, replay="host"))
    hh, sh, eng = _render(host)
    assert sh["replay"] == "host" and sd["replay"] == "device"
    assert _counts(sh) == _counts(sd)
    assert int(hh.sum(dtype=np.uint64)) == sh["on_canvas_points"] > 0
    moved = np.abs(hh.astype(np.int64) - hd.astype(np.int64)).sum() / 2
    if kind == "mh":
        np.testing.assert_array_equal(hh, hd)
        assert sh["mh_deposited"] == sh["on_canvas_points"]
    elif kind == "extended":
        assert abs(int(hh.sum()) - int(hd.sum())) <= 0.01 * hd.sum()
        assert np.corrcoef(hh.ravel(), hd.ravel())[0, 1] > 0.999
    else:
        assert moved <= 1e-3 * hd.sum()
    assert sh["replay_busy_seconds"] >= 0 and sh["replay_fetch_seconds"] >= 0


def test_host_mode_resume_preserves_mass():
    hist0 = np.full((40, 40), 7, np.uint32)
    hh, sh, eng = _render(_cfg(tcfg, replay="host"), passes=1, hist0=hist0)
    assert hh.min() >= 7
    assert int(hh.sum()) == 7 * hist0.size + sh["on_canvas_points"]
    # A new state starts from zero again: the worker is reset.
    state = eng.init_state(None)
    assert eng.histogram(state).sum() == 0


def test_uint64_resume_guard(tmp_path):
    cfg = _cfg(tcfg, hist_dtype="uint64")
    big = np.full(cfg.canvas.shape, 0x1_0000_0005, np.uint64)
    path = str(tmp_path / "u64.ckpt")
    ckpt.save(path, big, cfg, passes=3)
    loaded, meta = ckpt.load(path, cfg)
    assert loaded.dtype == np.uint64 and meta["dtype"] == "uint64"
    w32 = thr.HostReplayWorker(cfg.canvas, burning_ship=False)
    with pytest.raises(ValueError, match="uint64"):
        w32.add_resumed(loaded)
    w64 = thr.HostReplayWorker(cfg.canvas, burning_ship=False,
                               dtype=np.uint64)
    w64.add_resumed(np.full(cfg.canvas.shape, 9, np.uint32))
    assert int(w64.hist.min()) == 9
    # The engine resumes the uint64 counts and adds to them.
    hh, sh, _ = _render(cfg, passes=1, hist0=loaded)
    assert hh.dtype == np.uint64 and int(hh.min()) >= 0x1_0000_0005
    assert int(hh.sum()) == int(big.sum()) + sh["on_canvas_points"]


@pytest.mark.parametrize("layout", ["packed", "mh"])
def test_uint64_equals_uint32(layout):
    """uint64 histograms (auto resolves to the host replay) equal the
    uint32 host render bit for bit, counts too."""
    h32, s32, _ = _render(_cfg(tcfg, layout, replay="host"))
    h64, s64, eng = _render(_cfg(tcfg, layout, hist_dtype="uint64"))
    assert eng.replay_mode == "host"
    assert h32.dtype == np.uint32 and h64.dtype == np.uint64
    np.testing.assert_array_equal(h64, h32.astype(np.uint64))
    assert _counts(s64) == _counts(s32)
    assert s64["on_canvas_points"] == s32["on_canvas_points"] > 0


@pytest.mark.parametrize("share", [0.0, 0.5])
def test_hybrid_on_canvas_points_includes_device_share(share):
    """The device share's deposits count: on_canvas_points == the merged
    histogram's sum, every other count the device-mode render's."""
    _, sd, _ = _render(_cfg(tcfg))
    hh, sh, eng = _render(_cfg(tcfg, replay="host",
                               replay_device_share=share))
    assert sh["replay"] == ("hybrid" if share else "host")
    assert (eng.split_threshold > 0) == bool(share)
    assert eng.host_payload_slots <= eng.replay_capacity
    assert int(hh.sum()) == sh["on_canvas_points"] > 0
    assert _counts(sh) == _counts(sd)


def test_hybrid_holes_deposit_every_valid_slot():
    """The device part of a hybrid batch has -1 holes amid its
    longest-first order: the replay skips them and deposits every valid
    slot, so device + host parts equal one whole replay."""
    eng = CudaEngine(_cfg(tcfg, replay="host", replay_device_share=0.5),
                     device="cpu")
    state = eng.init_state(None)
    (cr, ci, it), _, _ = eng.classify_and_compact(state, 0)
    pos = torch.arange(it.numel())
    to_dev = (it < eng.split_threshold) | (pos >= eng.host_payload_slots)
    assert bool((it[~to_dev] >= 0).any()) and bool((it[to_dev] >= 0).any())
    kw = dict(canvas=eng.cfg.canvas, fractal=eng.fractal)
    whole = torch.zeros(1600, dtype=torch.int32)
    parts = torch.zeros(1600, dtype=torch.int32)
    n_whole = binning.replay_deposit(whole, cr, ci, it, **kw)
    n_dev = binning.replay_deposit(parts, cr, ci,
                                   torch.where(to_dev, it, -1), **kw)
    n_host = binning.replay_deposit(parts, cr, ci,
                                    torch.where(to_dev, -1, it), **kw)
    assert int(n_dev) + int(n_host) == int(n_whole)
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("band,share", [((100, 20), 0.3), ((2000, 50), 0.5),
                                        ((60, 5), 0.0), ((60000, 45000),
                                                         0.7)])
def test_split_geometry_matches_jax(band, share):
    """split_threshold and host_payload_slots: the JAX engine's formulas
    at the same band and capacity."""
    kw = dict(band=jcfg.IterationBand(max_escape_iterations=band[0],
                                      min_escape_iterations=band[1]))
    opts = dict(replay_capacity=1 << 16, steps_per_pass=4096,
                steps_per_flush=64, lane_rows=8)
    jt = jpe.Tuning(jcfg.RenderConfig(options=jcfg.EngineOptions(
        engine="pallas", replay_chunk=64, **opts), **kw))
    tt = Tuning(tcfg.RenderConfig(
        band=tcfg.IterationBand(max_escape_iterations=band[0],
                                min_escape_iterations=band[1]),
        options=tcfg.EngineOptions(**opts)))
    assert tt.split_threshold(share) == jt.split_threshold(share)
    theta = tt.split_threshold(share)
    assert tt.host_payload_slots(theta) == jt.host_payload_slots(theta)
    assert tt.packed_payload == jt.packed_payload


#: Configurations each package refuses, as (options, JAX replay_mode).
REFUSALS = [
    (dict(sampler="mh", replay_device_share=0.5), None),
    (dict(precision="extended", replay="host", replay_device_share=0.5),
     None),
    (dict(hist_dtype="uint64", replay="device"), None),
    (dict(hist_dtype="uint64", replay="host", replay_device_share=0.5),
     None),
]


@pytest.mark.parametrize("opts,mode", REFUSALS)
def test_refusals_keep_the_jax_messages(opts, mode):
    layout = "mh" if opts.get("sampler") == "mh" else (
        "extended" if opts.get("precision") == "extended" else "packed")
    o = {k: v for k, v in opts.items() if k not in ("sampler", "precision")}
    with pytest.raises(jcfg.ConfigError) as jerr:
        jpe.PallasEngine(_cfg(jcfg, layout, **o), replay_mode=mode)
    with pytest.raises(tcfg.ConfigError) as terr:
        CudaEngine(_cfg(tcfg, layout, **o), device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_oracle_refuses_uint64_by_the_jax_message():
    from cudabrot_tpu.engines.oracle_engine import OracleEngine as JOracle

    with pytest.raises(jcfg.ConfigError) as jerr:
        JOracle(_cfg(jcfg, engine="oracle", hist_dtype="uint64"))
    with pytest.raises(tcfg.ConfigError) as terr:
        make_engine(_cfg(tcfg, engine="oracle", hist_dtype="uint64"),
                    device="cpu")
    assert str(terr.value) == str(jerr.value).replace("pallas", "cuda")


def test_auto_replay_stays_on_the_device():
    """--replay auto is the device replay on every layout (the H100 has
    scatter hardware); uint64 alone resolves to the host."""
    for layout in LAYOUTS:
        assert CudaEngine(_cfg(tcfg, layout),
                          device="cpu").replay_mode == "device"
        assert CudaEngine(_cfg(tcfg, layout, hist_dtype="uint64"),
                          device="cpu").replay_mode == "host"


def test_worker_threads_follow_the_affinity():
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = os.cpu_count() or 1
    w = thr.HostReplayWorker(tcfg.Canvas(width=8, height=8),
                             burning_ship=False)
    assert w.num_threads == cores
    w.close()
    w4 = thr.HostReplayWorker(tcfg.Canvas(width=8, height=8),
                              burning_ship=False, num_threads=4)
    assert w4.num_threads == 4
    w4.close()


def test_cli_host_modes(tmp_path, capsys):
    """--replay host, --replay-device-share and --hist-dtype uint64 through
    cli.main on the CPU: the stats name the mode, the checkpoint keeps the
    dtype."""
    base = ["-w", "40", "-h", "30", "-m", "60", "-c", "5", "--lane-rows",
            "4", "--steps-per-pass", "128", "--steps-per-flush", "16",
            "--replay-capacity", "8192", "--passes", "2", "-t", "-1",
            "-o", str(tmp_path / "h.pgm")]
    import json

    for extra, replay, dtype in (
            (["--replay", "host"], "host", np.uint32),
            (["--replay", "host", "--replay-device-share", "0.5"], "hybrid",
             np.uint32),
            (["--hist-dtype", "uint64"], "host", np.uint64)):
        stats = tmp_path / "s.json"
        state = tmp_path / f"{replay}{np.dtype(dtype).itemsize}.ckpt"
        rc = cli.main([*base, *extra, "--stats-json", str(stats), "-s",
                       str(state)], device="cpu")
        assert rc == 0
        st = json.loads(stats.read_text())
        hist = np.load(state)["hist"]
        assert st["replay"] == replay and hist.dtype == dtype
        assert int(hist.sum()) == st["on_canvas_points"] > 0
    capsys.readouterr()


def test_unbuildable_library_fails_cleanly(monkeypatch, tmp_path, capsys):
    """--replay host when the native library cannot be built: exit code 1
    and the cause, no image, never a device replay in its place."""
    def broken():
        raise native.NativeError("g++ not found: test")

    monkeypatch.setattr(native, "load", broken)
    out = tmp_path / "x.pgm"
    rc = cli.main(["-w", "16", "-h", "16", "--lane-rows", "1",
                   "--steps-per-pass", "64", "--steps-per-flush", "16",
                   "--replay-capacity", "4096", "--passes", "1", "-t", "-1",
                   "--replay", "host", "-o", str(out)], device="cpu")
    assert rc == 1 and "g++ not found" in capsys.readouterr().out
    assert not out.exists()


def test_worker_under_contention_loses_no_update(monkeypatch):
    """Many more queued batches than cores, the interpreter switching
    threads every microsecond: the accumulator and the tallies equal one
    replay of all the batches (back-pressure holds at max_queue)."""
    import sys

    eng = CudaEngine(_cfg(tcfg, "f32", replay="host"), device="cpu")
    w = eng._worker
    batches = [_batch("f32", 2048, seed=s) for s in range(40)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for cr, ci, it in batches:
            w.submit(thr.Staged(None, torch.tensor(int((it >= 0).sum())),
                                eng.pack_payload(torch.from_numpy(cr),
                                                 torch.from_numpy(ci),
                                                 torch.from_numpy(it))))
            assert len(w._pending) <= w.max_queue
        w.drain()
    finally:
        sys.setswitchinterval(old)
    want = np.zeros(w.hist.shape, np.uint32)
    cv = eng.cfg.canvas
    hits, points = native.replay_scatter(
        np.concatenate([b[0] for b in batches]),
        np.concatenate([b[1] for b in batches]),
        np.concatenate([b[2] for b in batches]), want, strict=True,
        width=cv.width, height=cv.height, min_real=cv.min_real,
        min_imag=cv.min_imag, delta_real=cv.delta_real,
        delta_imag=cv.delta_imag)
    np.testing.assert_array_equal(w.hist, want)
    assert (w.hits, w.points) == (hits, points) and hits > 0
