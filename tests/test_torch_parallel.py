"""cudabrot_tpu_torch's multi-device rendering on the CPU: the sharded
quantizers, the RNG ordinals, the data-parallel engine
(``parallel/data_parallel.py``) and the device lists (``parallel/mesh.py``),
against the JAX package where it has the same function.

CPU devices stand in for cards, as the JAX tests' virtual CPU devices do:
``device="cpu"`` gives ``--devices N`` N CPU devices, each running the
kernels' plain versions with its own RNG ordinal. Everything merged from
integers is held bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.engines import pallas_engine as jpe
from cudabrot_tpu.ops import binning as jbinning
from cudabrot_tpu_torch import cli, driver, engines
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.config import (
    Canvas,
    ConfigError,
    EngineOptions,
    IterationBand,
    RenderConfig,
)
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
from cudabrot_tpu_torch.engines.oracle_engine import OracleEngine
from cudabrot_tpu_torch.ops import binning, df32, prng
from cudabrot_tpu_torch.parallel import mesh
from cudabrot_tpu_torch.parallel.data_parallel import (
    DataParallelEngine,
    sum_stats,
)
from cudabrot_tpu_torch.parallel.dryrun import dryrun_multichip
from cudabrot_tpu_torch.utils.device import DeviceError

torch.set_num_threads(1)

#: Tiny cuda-engine geometry (plain versions on the CPU).
GEOM = dict(lane_rows=2, steps_per_pass=128, steps_per_flush=16,
            replay_capacity=4096)
ZOOM = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)


def _cfg(n_dev=1, kind="oracle", **kw):
    """The JAX test's configuration (test_parallel._cfg) for ``kind``:
    the oracle, or the cuda engine at float32, extended precision or with
    Metropolis-Hastings chains."""
    opts = dict(num_devices=n_dev)
    cfg = dict(canvas=Canvas(width=32, height=32),
               band=IterationBand(max_escape_iterations=50,
                                  min_escape_iterations=5),
               seconds_to_run=-1.0, max_passes=2)
    if kind in ("oracle", "oracle-extended"):
        opts.update(engine="oracle", oracle_samples_per_pass=512)
        if kind == "oracle-extended":
            opts["precision"] = "extended"
            cfg.update(sample_domain=ZOOM, band=IterationBand(
                max_escape_iterations=128, min_escape_iterations=8))
    else:
        opts.update(GEOM)
        if kind == "extended":
            opts["precision"] = "extended"
            cfg.update(sample_domain=ZOOM, band=IterationBand(
                max_escape_iterations=128, min_escape_iterations=8))
        elif kind == "mh":
            opts.update(sampler="mh", replay_capacity=0,
                        steps_per_pass=256, steps_per_flush=64)
            cfg.update(canvas=Canvas(width=32, height=32, min_real=-1.2,
                                     max_real=-0.4, min_imag=-0.3,
                                     max_imag=0.5),
                       band=IterationBand(max_escape_iterations=64,
                                          min_escape_iterations=4))
    cfg.update(kw)
    return RenderConfig(options=EngineOptions(**opts), **cfg)


def _quiet(*_):
    pass


# -- the sharded quantizers -------------------------------------------------


def _points(canvas, n, seed):
    """Points over the canvas and a margin around it, on pixel edges too,
    with a random validity mask."""
    rng = np.random.default_rng(seed)
    re = rng.uniform(canvas.min_real - 0.3, canvas.max_real + 0.3, n)
    im = rng.uniform(canvas.min_imag - 0.3, canvas.max_imag + 0.3, n)
    edge = rng.integers(0, canvas.height + 2, n // 4)
    im[: n // 4] = canvas.min_imag + edge * canvas.delta_imag
    return (re.astype(np.float32), im.astype(np.float32),
            rng.uniform(size=n) < 0.9)


@pytest.mark.parametrize("height,shards", [(40, 4), (41, 4)])
@pytest.mark.parametrize("df", [False, True])
def test_sharded_quantizers_match_eager_jax(df, height, shards):
    """points_to_bin_ids_sharded and _df_sharded equal the JAX functions
    bitwise, called eagerly (jit rewrites the division:
    test_points_to_bin_ids_jit_edge_bound), over every shard of an even
    and an uneven split; the shards partition the whole canvas's ids."""
    canvas = Canvas(width=37, height=height, min_real=-1.9, max_real=0.7,
                    min_imag=-1.3, max_imag=1.1)
    jcanvas = jcfg.Canvas(width=37, height=height, min_real=-1.9,
                          max_real=0.7, min_imag=-1.3, max_imag=1.1)
    re, im, valid = _points(canvas, 4000, height)
    rps = -(-height // shards)
    if df:
        rel = (re * np.float32(2.0 ** -30)).astype(np.float32)
        iml = (im * np.float32(-2.0 ** -31)).astype(np.float32)
        mr, mi = (df32.from_float(v) for v in (canvas.min_real,
                                                 canvas.min_imag))
        tm = [tuple(torch.tensor(x) for x in m) for m in (mr, mi)]
        jm = [tuple(jnp.float32(x) for x in m) for m in (mr, mi)]
        t_args = [torch.from_numpy(x) for x in (re, rel, im, iml, valid)]
        j_args = [jnp.asarray(x) for x in (re, rel, im, iml, valid)]
        whole = binning.points_to_bin_ids_df(canvas, *t_args, *tm).numpy()
    else:
        t_args = [torch.from_numpy(x) for x in (re, im, valid)]
        j_args = [jnp.asarray(x) for x in (re, im, valid)]
        whole = binning.points_to_bin_ids(canvas, *t_args).numpy()
    merged = np.full(re.size, canvas.num_pixels, np.int64)
    for d in range(shards):
        r0 = d * rps
        if df:
            got = binning.points_to_bin_ids_df_sharded(
                canvas, *t_args, *tm, r0, rps).numpy()
            want = np.asarray(jbinning.points_to_bin_ids_df_sharded(
                jcanvas, *j_args, *jm, row_start=r0, row_count=rps))
        else:
            got = binning.points_to_bin_ids_sharded(
                canvas, *t_args, r0, rps).numpy()
            want = np.asarray(jbinning.points_to_bin_ids_sharded(
                jcanvas, *j_args, row_start=r0, row_count=rps))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        inside = got < rps * canvas.width
        merged[inside] = got[inside] + r0 * canvas.width
    np.testing.assert_array_equal(merged, whole)
    assert (whole < canvas.num_pixels).sum() > 1000


# -- RNG ordinals -----------------------------------------------------------


@pytest.mark.parametrize("ordinal", range(8))
def test_pass_key_folds_the_ordinal_as_jax(ordinal):
    for pass_index in (0, 5):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.key(1337), jnp.uint32(ordinal)),
            pass_index)
        assert tuple(int(v) for v in jax.random.key_data(key)) == (
            prng.pass_key(1337, ordinal, pass_index))


@pytest.mark.parametrize("ordinal", [1, 3])
def test_one_ordinal_matches_the_jax_engine(ordinal):
    """The port's one-device pass at a non-zero RNG ordinal against the JAX
    engine's core at that ordinal, with test_torch_engine's tolerance at
    ordinal 0 (the same samples; FMA drift only in the JAX orbits)."""
    base = dict(lane_rows=8, steps_per_pass=256, steps_per_flush=16,
                replay_capacity=1 << 14)

    def cfg(mod, **extra):
        return mod.RenderConfig(
            canvas=mod.Canvas(width=32, height=32),
            band=mod.IterationBand(max_escape_iterations=50,
                                   min_escape_iterations=3),
            options=mod.EngineOptions(**base, **extra))

    jeng = jpe.PallasEngine(cfg(jcfg, engine="pallas", replay="device"))
    core = jax.jit(jeng.core)
    js = jeng.init_state(None)
    teng = CudaEngine(cfg(tcfg), device="cpu")
    ts = teng.init_state(None)
    for p in range(2):
        js = core(js, jnp.uint32(p), jnp.uint32(ordinal))
        teng.core(ts, p, ordinal)
    jh, th = jeng.histogram(js), teng.histogram(ts)
    assert np.corrcoef(jh.ravel(), th.ravel())[0, 1] > 0.999
    jst, tst = jeng.stats(js), teng.stats(ts)
    for k in ("samples", "in_band", "emitted", "orbit_points"):
        assert abs(tst[k] / jst[k] - 1) < 0.01, (k, tst[k], jst[k])
    # A different ordinal is a different sample stream.
    t0 = CudaEngine(cfg(tcfg), device="cpu")
    s0 = t0.init_state(None)
    for p in range(2):
        t0.core(s0, p, 0)
    assert not np.array_equal(t0.histogram(s0), th)


# -- the data-parallel engine -----------------------------------------------


def _singles(cfg, ordinals):
    """Single-engine renders at the given ordinals, summed (uint32)."""
    total, stats = np.zeros(cfg.canvas.shape, np.uint32), []
    for ordinal in ordinals:
        eng = engines.single_engine(cfg, "cpu")
        state = eng.init_state(None)
        for p in range(cfg.max_passes):
            eng.core(state, p, ordinal)
        total += eng.histogram(state)
        stats.append(eng.stats(state))
    return total, sum_stats(stats)


@pytest.mark.parametrize("n_dev", [2, 3, 4])
@pytest.mark.parametrize("kind", ["oracle", "oracle-extended", "float32",
                                  "extended", "mh"])
def test_dp_equals_the_sum_of_single_device_renders(kind, n_dev):
    """The data-parallel histogram and stats equal the sum of the
    per-ordinal single-device renders bitwise (test_parallel.py:84):
    merging only reorders integer additions. With MH each device's tails
    are flushed at readback, as a single engine's are."""
    cfg = _cfg(n_dev, kind)
    res = driver.run_render(cfg, device="cpu", log=_quiet)
    assert res.engine_name.startswith("dp(")
    hist, stats = _singles(cfg, range(n_dev))
    np.testing.assert_array_equal(res.histogram, hist)
    assert res.stats == stats
    assert hist.sum() > 0
    if kind not in ("oracle", "oracle-extended"):
        assert stats["on_canvas_points"] == int(hist.sum())


def test_dp_engine_selected_and_accumulates():
    eng = engines.make_engine(_cfg(4), device="cpu")
    assert isinstance(eng, DataParallelEngine) and eng.num_devices == 4
    assert eng.name == "dp(oracle)"
    res = driver.run_render(_cfg(4), engine=eng, log=_quiet)
    assert res.histogram.shape == (32, 32) and res.histogram.sum() > 0
    # 4 devices x 2 passes x 512 samples
    assert res.stats["samples"] == 4 * 2 * 512
    assert isinstance(engines.make_engine(_cfg(1), device="cpu"),
                      OracleEngine)


def test_dp_devices_sample_independently():
    """Each device folds its own ordinal: a 2-device render is not twice a
    1-device one."""
    dp = driver.run_render(_cfg(2), device="cpu", log=_quiet)
    one = driver.run_render(_cfg(1), device="cpu", log=_quiet)
    assert not np.array_equal(dp.histogram, 2 * one.histogram)


@pytest.mark.parametrize("kind", ["oracle", "float32"])
def test_dp_deterministic(kind):
    a = driver.run_render(_cfg(4, kind), device="cpu", log=_quiet)
    b = driver.run_render(_cfg(4, kind), device="cpu", log=_quiet)
    np.testing.assert_array_equal(a.histogram, b.histogram)
    assert a.stats == b.stats


@pytest.mark.parametrize("kind", ["oracle", "mh"])
def test_dp_resume_preserves_mass(tmp_path, kind):
    """A resumed histogram goes into the replica of ordinal 0 only: the
    second render's histogram is the first's plus its own passes."""
    path = str(tmp_path / "dp.ckpt")
    cfg = _cfg(4, kind, inprogress_file=path)
    r1 = driver.run_render(cfg, device="cpu", log=_quiet)
    r2 = driver.run_render(cfg, device="cpu", log=_quiet)
    assert r2.histogram.sum() > r1.histogram.sum()
    assert (r2.histogram >= r1.histogram).all()


def test_dp_matches_the_jax_dp_render():
    """A whole data-parallel render over 2 devices against the JAX
    package's (pallas engine, interpret mode, device replay, 2 virtual CPU
    devices): the same samples per ordinal, so the normalized histograms
    correlate above 0.99 (ROADMAP queue 1 item 5, item 12's criterion)."""
    from cudabrot_tpu import driver as jdriver

    base = dict(lane_rows=8, steps_per_pass=256, steps_per_flush=16,
                replay_capacity=1 << 14, num_devices=2)

    def cfg(mod, **extra):
        return mod.RenderConfig(
            canvas=mod.Canvas(width=32, height=32),
            band=mod.IterationBand(max_escape_iterations=50,
                                   min_escape_iterations=3),
            seconds_to_run=-1.0, max_passes=3,
            options=mod.EngineOptions(**base, **extra))

    j = jdriver.run_render(cfg(jcfg, engine="pallas", replay="device"),
                           log=_quiet)
    t = driver.run_render(cfg(tcfg), device="cpu", log=_quiet)
    assert j.engine_name == "dp(pallas)" and t.engine_name == "dp(cuda)"
    p = t.histogram.astype(np.float64) / t.histogram.sum()
    q = j.histogram.astype(np.float64) / j.histogram.sum()
    assert np.corrcoef(p.ravel(), q.ravel())[0, 1] > 0.99
    for k in ("samples", "emitted"):
        assert abs(t.stats[k] / j.stats[k] - 1) < 0.01, k


def test_dryrun_multichip_on_cpu_devices():
    sums = dryrun_multichip(4, device="cpu")
    assert set(sums) == {"float32", "rows", "extended", "mh"}
    assert sums["rows"] == sums["float32"] > 0


# -- device lists -----------------------------------------------------------


def test_device_list_cpu():
    assert mesh.device_list(3, device="cpu") == [torch.device("cpu")] * 3
    assert mesh.device_list(None, device="cpu") == [torch.device("cpu")]
    with pytest.raises(ConfigError, match="at least 1"):
        mesh.device_list(0, device="cpu")


@pytest.fixture
def eight_cards(monkeypatch):
    """A host that reports eight cards (nothing is launched on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


def test_device_list_base_device(eight_cards):
    """-d N --devices M selects cards N..N+M-1, the JAX package's make_mesh
    with its messages; None takes every card from -d."""
    cards = [torch.device("cuda", i) for i in range(8)]
    assert mesh.device_list(2, base=1) == cards[1:3]
    assert mesh.device_list(None, base=6) == cards[6:]
    assert mesh.device_list(None) == cards
    with pytest.raises(DeviceError, match="Requested 4 devices starting at "
                       "device 6 but only 2 are available there."):
        mesh.device_list(4, base=6)
    with pytest.raises(DeviceError, match=r"Base device 8 not available "
                       r"\(8 devices present\)\."):
        mesh.device_list(1, base=8)
    devices, first, total = mesh.local_devices(3, base=2)
    assert devices == cards[2:5] and first == 0 and total == 3


def test_too_many_cards_is_an_error_not_fewer(monkeypatch, capsys):
    """--devices 2 on a one-card host exits 1 with the JAX package's
    message; it never renders on one card or on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = cli.main(["-w", "16", "-h", "16", "--devices", "2", "--passes",
                   "1", "-t", "-1", "-o", "/nonexistent/x.pgm"])
    assert rc == 1
    assert ("Requested 2 devices starting at device 0 but only 1 are "
            "available there.") in capsys.readouterr().out


def test_cli_renders_on_cpu_devices(tmp_path):
    """--devices 3 through cli.main on CPU devices: a valid PGM, and the
    stats record the data-parallel engine with on_canvas_points equal to
    the checkpoint's histogram sum."""
    import json

    from cudabrot_tpu_torch.io import checkpoint as ckpt

    out, st, ck = (str(tmp_path / n) for n in ("d.pgm", "d.json", "d.ckpt"))
    args = ["-w", "40", "-h", "30", "-m", "60", "-c", "5", "--lane-rows",
            "2", "--steps-per-pass", "128", "--steps-per-flush", "16",
            "--replay-capacity", "4096", "--passes", "2", "-t", "-1",
            "--devices", "3", "-o", out, "--stats-json", st, "-s", ck]
    assert cli.main(args, device="cpu") == 0
    stats = json.loads(open(st).read())
    assert stats["engine"] == "dp(cuda)"
    hist, meta = ckpt.load(ck, cli.parse_args(args)[0])
    assert stats["on_canvas_points"] == int(hist.sum()) > 0
    assert open(out, "rb").read().startswith(b"P5\n40 30\n65535\n")


def test_render_color_on_two_cpu_devices(tmp_path):
    """render-color forwards --devices (and --hist-sharding) to every
    band's render: two CPU devices a band, rows too, give one image."""
    from cudabrot_tpu_torch.io import png

    outs = []
    for extra in ([], ["--hist-sharding", "rows"]):
        out = str(tmp_path / f"c{len(extra)}.png")
        rc = cli.main(["render-color", "--mode", "hsl", "-w", "24", "-h",
                       "20", "--passes", "1", "--devices", "2",
                       "--lane-rows", "2", "--steps-per-pass", "128",
                       "--steps-per-flush", "16", "--replay-capacity",
                       "4096", "--band", "H:200:30:1:1", "--band",
                       "S:100:10:1:1", "--band", "L:400:100:1:1", "-o", out,
                       *extra], device="cpu")
        assert rc == 0
        outs.append(png.read_png(out))
    assert outs[0].shape == (20, 24, 3) and outs[0].max() > 0
    np.testing.assert_array_equal(outs[0], outs[1])


# -- the data-parallel host replay ------------------------------------------


def _host_singles(cfg, ordinals):
    """Single host-mode engines at the given ordinals, summed in the
    histogram's dtype; stats summed without the worker's seconds."""
    total, stats = None, []
    for ordinal in ordinals:
        eng = CudaEngine(cfg, device="cpu")
        state = eng.init_state(None)
        for p in range(cfg.max_passes):
            out = eng.host_pass(state, p, ordinal)
            if out is not None:
                eng._worker.submit(eng.stage(*out))
        h = eng.histogram(state)
        total = h if total is None else total + h
        stats.append(_no_seconds(eng.stats(state)))
    return total, sum_stats(stats)


def _no_seconds(stats):
    return {k: v for k, v in stats.items()
            if k not in ("replay_fetch_seconds", "replay_busy_seconds")}


@pytest.mark.parametrize("n_dev", [2, 3])
@pytest.mark.parametrize("kind,opts", [
    ("float32", dict(replay="host")),
    ("float32", dict(replay="host", replay_device_share=0.5)),
    ("float32", dict(hist_dtype="uint64")),
    ("extended", dict(replay="host")),
    ("mh", dict(replay="host")),
])
def test_dp_host_equals_the_sum_of_single_host_engines(kind, opts, n_dev):
    """The data-parallel host replay (one worker fed every device's
    payloads) equals single host-mode engines at the same ordinals, summed:
    histogram and every count bitwise."""
    cfg = _cfg(n_dev, kind)
    cfg = cfg.replace(options=dataclasses.replace(cfg.options, **opts))
    eng = engines.make_engine(cfg, device="cpu")
    assert eng.name == "dp-host(cuda)"
    res = driver.run_render(cfg, engine=eng, log=_quiet)
    hist, stats = _host_singles(cfg, range(n_dev))
    assert res.histogram.dtype == hist.dtype
    np.testing.assert_array_equal(res.histogram, hist)
    assert _no_seconds(res.stats) == stats
    assert stats["replay"] == ("hybrid" if "replay_device_share" in opts
                               else "host")
    assert int(hist.sum()) == stats["on_canvas_points"] > 0


def test_dp_host_counts_equal_dp_device():
    """The same samples through the device and the host replay over three
    devices: every count but on_canvas_points equal."""
    cfg = _cfg(3, "float32")
    dev = driver.run_render(cfg, device="cpu", log=_quiet)
    host = driver.run_render(cfg.replace(options=dataclasses.replace(
        cfg.options, replay="host")), device="cpu", log=_quiet)
    skip = ("replay", "on_canvas_points", "replay_fetch_seconds",
            "replay_busy_seconds")
    assert ({k: v for k, v in host.stats.items() if k not in skip}
            == {k: v for k, v in dev.stats.items() if k not in skip})


def test_dp_host_resume_counts_the_checkpoint_once(tmp_path):
    path = str(tmp_path / "dp.ckpt")
    cfg = _cfg(3, "float32", inprogress_file=path)
    cfg = cfg.replace(options=dataclasses.replace(cfg.options,
                                                  replay="host"))
    r1 = driver.run_render(cfg, device="cpu", log=_quiet)
    r2 = driver.run_render(cfg, device="cpu", log=_quiet)
    assert (int(r2.histogram.sum()) == int(r1.histogram.sum())
            + r2.stats["on_canvas_points"])
    assert (r2.histogram >= r1.histogram).all()
