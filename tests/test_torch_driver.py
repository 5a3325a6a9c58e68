"""The cudabrot_tpu_torch render loop on the CPU, mirroring
tests/test_driver.py: fixed pass counts, determinism, the time box,
checkpoint resume, periodic checkpoints and previews, and SIGINT."""

import os
import signal

import numpy as np

from cudabrot_tpu_torch import driver
from cudabrot_tpu_torch.config import (
    Canvas,
    EngineOptions,
    IterationBand,
    RenderConfig,
)
from cudabrot_tpu_torch.io import checkpoint as ckpt
from cudabrot_tpu_torch.io import png


def _cfg(**kw):
    defaults = dict(
        canvas=Canvas(width=32, height=32),
        band=IterationBand(max_escape_iterations=50, min_escape_iterations=5),
        seconds_to_run=-1.0,
        max_passes=2,
        options=EngineOptions(lane_rows=2, steps_per_pass=64,
                              steps_per_flush=16, replay_capacity=4096),
    )
    defaults.update(kw)
    return RenderConfig(**defaults)


def _render(cfg, log=lambda s: None):
    return driver.run_render(cfg, log=log, device="cpu")


def test_fixed_pass_render():
    logs = []
    res = _render(_cfg(), log=logs.append)
    assert res.passes == 2 and res.engine_name == "cuda"
    assert res.histogram.shape == (32, 32)
    assert res.histogram.dtype == np.uint32
    assert res.histogram.sum() == res.stats["on_canvas_points"] > 0
    assert res.stats["classify_iters"] + res.stats["wasted_steps"] == (
        2 * 64 * 256)
    assert res.stats["orbit_points"] >= res.histogram.sum()
    assert any("Calculating Buddhabrot." in line for line in logs)
    assert any("Buddhabrot passes took" in line for line in logs)
    assert any("Approximate memory needed" in line for line in logs)


def test_render_is_deterministic_and_seeded():
    a, b = _render(_cfg()), _render(_cfg())
    np.testing.assert_array_equal(a.histogram, b.histogram)
    assert a.stats == b.stats
    c = _render(_cfg(seed=999))
    assert not np.array_equal(a.histogram, c.histogram)


def test_time_boxed_render_stops():
    res = _render(_cfg(seconds_to_run=0.3, max_passes=None))
    assert res.passes >= 1
    assert res.elapsed_seconds < 30.0


def test_checkpoint_save_and_resume(tmp_path):
    path = str(tmp_path / "state.ckpt")
    cfg = _cfg(inprogress_file=path)
    r1 = _render(cfg)
    saved, meta = ckpt.load(path, cfg)
    np.testing.assert_array_equal(saved, r1.histogram)
    assert meta["passes"] == 2
    r2 = _render(cfg)
    assert r2.histogram.sum() > r1.histogram.sum()
    saved2, meta2 = ckpt.load(path, cfg)
    assert meta2["passes"] == 4
    np.testing.assert_array_equal(saved2, r2.histogram)


def test_periodic_checkpoint_and_preview(tmp_path):
    path = str(tmp_path / "periodic.ckpt")
    preview = str(tmp_path / "live.png")
    cfg = _cfg(inprogress_file=path, preview_file=preview, max_passes=4,
               checkpoint_interval=2)
    _render(cfg)
    assert ckpt.load(path, cfg)[1]["passes"] == 4
    img = png.read_png(preview)
    assert img.shape == (32, 32) and img.max() > 0
    assert not [p for p in tmp_path.iterdir() if p.name.endswith(".tmp")]


def test_sigint_interrupts_and_saves(tmp_path, monkeypatch):
    """SIGINT mid-render finishes the current pass, exits the loop and
    saves (cudabrot.cu:483, 756-760)."""
    path = str(tmp_path / "sig.ckpt")
    cfg = _cfg(seconds_to_run=60.0, max_passes=None, inprogress_file=path)
    calls = {"n": 0}
    orig = driver.time.monotonic

    def fake_monotonic():
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGINT)
        return orig()

    monkeypatch.setattr(driver.time, "monotonic", fake_monotonic)
    logs = []
    res = _render(cfg, log=logs.append)
    assert res.interrupted and res.passes >= 1
    assert any("Signal 2 received" in line for line in logs)
    assert ckpt.load(path, cfg)[1]["passes"] == res.passes


def test_pipeline_depth():
    assert driver.resolve_pipeline_depth(_cfg()) == 8
    cfg = _cfg(options=EngineOptions(pipeline_depth=3))
    assert driver.resolve_pipeline_depth(cfg) == 3
