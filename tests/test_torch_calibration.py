"""The port's machine calibration (``cudabrot_tpu_torch/utils/
calibration.py``): the file round trip and activation, ``--calibration``
through ``cli.main``, the hybrid share solve that reads it
(``Tuning.auto_device_share``) and the driver's drift warning."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch import cli, config, driver
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine, Tuning
from cudabrot_tpu_torch.utils import calibration

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    monkeypatch.delenv(calibration.ENV_VAR, raising=False)
    calibration.activate("")
    yield
    calibration.activate("")


def test_roundtrip_and_activate(tmp_path):
    cal = dataclasses.replace(calibration.DEFAULT,
                              host_replay_dram_rate=1.23e8,
                              classify_op_rate=4e12, source="test")
    path = str(tmp_path / "cal.json")
    calibration.save(path, cal)
    assert calibration.load(path) == cal
    active = calibration.activate(path)
    assert active.host_replay_dram_rate == 1.23e8
    assert calibration.active() is active
    assert calibration.activate("") is calibration.DEFAULT


def test_load_ignores_unknown_keys(tmp_path):
    path = tmp_path / "cal.json"
    path.write_text(json.dumps({
        "host_replay_dram_rate": 5e7, "probe_version": 3,
        "machine": {"card": "x"}, "step_cost_step": [1e-12, 2e-11]}))
    cal = calibration.load(str(path))
    assert cal.host_replay_dram_rate == 5e7
    assert cal.device_replay_rate == calibration.DEFAULT.device_replay_rate
    assert cal.source == str(path)
    path.write_text(json.dumps({"link_rate_bytes": "fast"}))
    with pytest.raises(ValueError, match="link_rate_bytes"):
        calibration.load(str(path))


def test_environment_variable(tmp_path, monkeypatch):
    """The port reads CUDABROT_TPU_TORCH_CALIBRATION, never the JAX
    package's CUDABROT_TPU_CALIBRATION."""
    path = tmp_path / "cal.json"
    calibration.save(str(path), dataclasses.replace(
        calibration.DEFAULT, pass_overhead_seconds=0.5))
    monkeypatch.setenv("CUDABROT_TPU_CALIBRATION", str(path))
    calibration.activate(None)
    assert calibration.active() is calibration.DEFAULT
    monkeypatch.setenv(calibration.ENV_VAR, str(path))
    assert calibration.activate(None).pass_overhead_seconds == 0.5


def _args(tmp_path, *extra):
    return ["-w", "40", "-h", "30", "-m", "60", "-c", "5", "--lane-rows",
            "4", "--steps-per-pass", "128", "--steps-per-flush", "16",
            "--replay-capacity", "8192", "--passes", "2", "-t", "-1",
            "-o", str(tmp_path / "c.pgm"), *extra]


def test_calibration_flag_through_cli(tmp_path, capsys):
    path = tmp_path / "cal.json"
    calibration.save(str(path), dataclasses.replace(
        calibration.DEFAULT, host_replay_llc_rate=3e8, source="probe"))
    stats = tmp_path / "s.json"
    rc = cli.main(_args(tmp_path, "--calibration", str(path), "--replay",
                        "host", "--stats-json", str(stats)), device="cpu")
    assert rc == 0
    assert calibration.active().source == "probe"
    assert json.loads(stats.read_text())["replay"] in ("host", "hybrid")
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    for name in (str(bad), str(tmp_path / "missing.json")):
        rc = cli.main(_args(tmp_path, "--calibration", name), device="cpu")
        assert rc == 1
        assert "Invalid calibration file" in capsys.readouterr().out


def _tuning(canvas=(1000, 1000), band=(100, 20), **opt):
    return Tuning(config.RenderConfig(
        canvas=config.Canvas(width=canvas[0], height=canvas[1]),
        band=config.IterationBand(max_escape_iterations=band[0],
                                  min_escape_iterations=band[1]),
        options=config.EngineOptions(**opt)))


BIG = 20000 * 15000 * 4


@pytest.mark.parametrize("kind", ["extended", "mh", "interior", "uint64"])
def test_share_is_zero_where_the_split_does_not_apply(kind):
    opt = {"extended": dict(precision="extended"), "mh": dict(sampler="mh"),
           "interior": {}, "uint64": dict(hist_dtype="uint64")}[kind]
    cfg = config.RenderConfig(
        canvas=config.Canvas(width=64, height=64),
        fractal="anti-buddhabrot" if kind == "interior" else "buddhabrot",
        options=config.EngineOptions(replay="host", **opt))
    eng = CudaEngine(cfg, device="cpu")
    assert eng.device_share == 0.0 and eng.split_threshold == 0
    if kind != "uint64":
        assert eng.tuning.auto_device_share(BIG) == 0.0
        assert eng.tuning.auto_device_share(1 << 20) == 0.0


@pytest.mark.parametrize("rates", [
    dict(host_replay_dram_rate=1e12, host_replay_llc_rate=1e12),
    dict(host_replay_dram_rate=1e5, host_replay_llc_rate=1e5),
    dict(device_replay_rate=1e15, link_rate_bytes=1e3),
    dict(classify_op_rate=1e6),
    {},
])
@pytest.mark.parametrize("hist_bytes", [1 << 22, BIG])
def test_share_never_above_0_9(tmp_path, rates, hist_bytes):
    path = str(tmp_path / "cal.json")
    calibration.save(path, dataclasses.replace(calibration.DEFAULT, **rates))
    calibration.activate(path)
    for band in ((100, 20), (8000, 1000), (20000, 2000)):
        s = _tuning(band=band).auto_device_share(hist_bytes)
        assert 0.0 <= s <= 0.9


def test_share_follows_the_calibrated_rates(tmp_path):
    """A host that replays very fast takes every orbit; a very slow one
    leaves the device the most the solve allows."""
    tn = _tuning(canvas=(20000, 15000), band=(8000, 1000))
    fast, slow = (str(tmp_path / f"{n}.json") for n in ("fast", "slow"))
    calibration.save(fast, dataclasses.replace(
        calibration.DEFAULT, host_replay_dram_rate=1e12))
    calibration.save(slow, dataclasses.replace(
        calibration.DEFAULT, host_replay_dram_rate=1e6))
    calibration.activate(fast)
    assert tn.auto_device_share(BIG) == 0.0
    calibration.activate(slow)
    assert tn.auto_device_share(BIG) == 0.9
    # Small canvases off the fused route keep every orbit on the host.
    assert tn.auto_device_share(1 << 22, "bigtiles") == 0.0


class _Worker:
    def __init__(self, points, seconds):
        self.points, self.replay_seconds = points, seconds


class _Engine:
    def __init__(self, worker):
        self._worker = worker


@pytest.mark.parametrize("ratio,fires", [(2.5, True), (0.3, True),
                                         (1.0, False), (1.9, False)])
def test_drift_warning(ratio, fires):
    """The driver warns when the worker's measured replay rate on a
    DRAM-sized canvas is 2x off the calibrated one; never on small
    canvases or short runs."""
    rate = calibration.active().host_replay_dram_rate
    worker = _Worker(int(rate * ratio * 2.0), 2.0)
    lines = []
    big = config.RenderConfig(canvas=config.Canvas(width=12000,
                                                   height=12000))
    driver._warn_calibration_drift(big, _Engine(worker), lines.append)
    assert bool(lines) == fires
    if fires:
        assert "Calibration drift" in lines[0]
    small = config.RenderConfig(canvas=config.Canvas(width=1000,
                                                     height=1000))
    lines.clear()
    driver._warn_calibration_drift(small, _Engine(worker), lines.append)
    driver._warn_calibration_drift(big, _Engine(_Worker(10, 0.1)),
                                   lines.append)
    driver._warn_calibration_drift(big, _Engine(None), lines.append)
    assert not lines


def test_defaults_are_the_cards():
    """The defaults name the card and host they were measured on, and carry
    none of the JAX package's TPU constants."""
    from cudabrot_tpu.utils import calibration as jcal

    d = calibration.DEFAULT
    assert d.host_replay_dram_rate != jcal.DEFAULT.host_replay_dram_rate
    assert d.device_replay_rate != jcal.DEFAULT.device_replay_rate
    assert d.link_rate_bytes != jcal.DEFAULT.link_rate_bytes
    assert "H100" in calibration.__doc__
    assert np.isfinite([d.classify_op_rate, d.pass_overhead_seconds]).all()
