"""The cudabrot_tpu_torch render loop on the CPU, mirroring
tests/test_driver.py: fixed pass counts, determinism, the time box,
checkpoint resume, periodic checkpoints and previews, and SIGINT."""

import os
import signal

import numpy as np
import pytest
import torch

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


def test_progress_line_reads_completed_passes(monkeypatch):
    """The progress line comes only right after a group's synchronize, and
    its rate is the lane-steps of the passes completed there over the time
    to it (an engine whose passes complete at synchronize only, on a fake
    clock: 0.25 s to enqueue a pass, 1 s to synchronize)."""
    clock = {"t": 100.0}

    class Engine:
        name = "fake"
        device = torch.device("cpu")
        steps_per_pass = 1000

        def __init__(self):
            self.issued = self.done = 0

        def memory_estimate(self):
            return 0, 0

        def init_state(self, hist0):
            return {}

        def warmup(self, state):
            pass

        def run_pass(self, state, pass_index):
            self.issued += 1
            clock["t"] += 0.25
            return state

        def synchronize(self):
            clock["t"] += 1.0
            self.done = self.issued

        def histogram(self, state):
            return np.zeros((32, 32), np.uint32)

        def stats(self, state):
            return {}

    monkeypatch.setattr(driver.time, "monotonic", lambda: clock["t"])
    engine = Engine()
    lines = []

    def log(msg):
        if msg.startswith("  pass "):
            lines.append((msg, engine.done))

    cfg = _cfg(max_passes=7, progress_interval=1e-9,
               options=EngineOptions(pipeline_depth=2))
    driver.run_render(cfg, engine=engine, log=log)
    assert [int(m.split()[1].rstrip(":")) for m, _ in lines] == [2, 4, 6]
    for msg, done in lines:
        passes = int(msg.split()[1].rstrip(":"))
        assert done == passes
        # 0.25 s a pass and 1 s a group of two: 0.75 s a completed pass.
        assert msg == (f"  pass {passes}: {0.75 * passes:.1f}s elapsed, "
                       f"~{1000 / 0.75:.3e} lane-steps/s")


class _WaitEngine:
    """An engine that logs the driver's waits: ``sync_group`` where the
    class has it, ``synchronize`` always."""

    name = "fake"
    device = torch.device("cpu")
    steps_per_pass = 1

    def __init__(self):
        self.calls = []

    def memory_estimate(self):
        return 0, 0

    def init_state(self, hist0):
        return {}

    def warmup(self, state):
        pass

    def run_pass(self, state, pass_index):
        self.calls.append(("pass", pass_index))
        return state

    def synchronize(self):
        self.calls.append(("synchronize",))

    def histogram(self, state):
        return np.zeros((32, 32), np.uint32)

    def stats(self, state):
        return {}


class _GroupEngine(_WaitEngine):
    def sync_group(self):
        self.calls.append(("sync_group",))


@pytest.mark.parametrize("engine_cls, group_wait", [
    (_GroupEngine, "sync_group"), (_WaitEngine, "synchronize")],
    ids=["sync_group", "synchronize"])
def test_group_end_wait_and_final_synchronize(engine_cls, group_wait):
    """Each pipeline_depth-th pass ends in the engine's group wait
    (``sync_group`` where it has one, else ``synchronize``), and the
    render ends in one full ``synchronize``."""
    engine = engine_cls()
    cfg = _cfg(max_passes=7, options=EngineOptions(pipeline_depth=3))
    res = driver.run_render(cfg, engine=engine, log=lambda s: None)
    assert res.passes == 7
    calls = engine.calls
    waits = [i for i, c in enumerate(calls) if c[0] != "pass"]
    assert [calls[i - 1] for i in waits[:-1]] == [("pass", 2), ("pass", 5)]
    assert [calls[i] for i in waits] == [(group_wait,)] * 2 + [
        ("synchronize",)]
    assert waits[-1] == len(calls) - 1 and calls[-2] == ("pass", 6)
