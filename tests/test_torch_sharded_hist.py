"""cudabrot_tpu_torch's row-sharded histogram engine
(``parallel/sharded_hist.py``) on CPU devices: the kernels' plain versions
with the replay's row window.

Row windows partition the canvas, so for the same seeds the sharded
histogram equals the replicated data-parallel one bit for bit
(``tests/test_sharded_hist.py:40-69`` of the JAX package), on both deposit
routes, with an uneven split and across a resume.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch import driver, engines
from cudabrot_tpu_torch.config import (
    Canvas,
    ConfigError,
    EngineOptions,
    IterationBand,
    RenderConfig,
)
from cudabrot_tpu_torch.ops import launches
from cudabrot_tpu_torch.parallel.data_parallel import DataParallelEngine
from cudabrot_tpu_torch.parallel.sharded_hist import ShardedHistogramEngine

torch.set_num_threads(1)

ZOOM = (-0.75 - 5e-7, -0.75 + 5e-7, 0.055 - 5e-7, 0.055 + 5e-7)


def _cfg(n_dev, sharding="rows", height=32, precision="float32",
         scatter="auto", **kw):
    opts = dict(lane_rows=2, steps_per_pass=128, steps_per_flush=16,
                replay_capacity=4096, num_devices=n_dev,
                histogram_sharding=sharding, precision=precision,
                scatter=scatter)
    cfg = dict(canvas=Canvas(width=32, height=height),
               band=IterationBand(max_escape_iterations=40,
                                  min_escape_iterations=3),
               seconds_to_run=-1.0, max_passes=2)
    if precision == "extended":
        cfg.update(sample_domain=ZOOM, band=IterationBand(
            max_escape_iterations=128, min_escape_iterations=8))
    cfg.update(kw)
    return RenderConfig(options=EngineOptions(**opts), **cfg)


def _render(cfg):
    return driver.run_render(cfg, device="cpu", log=lambda *_: None)


def test_engine_selected():
    eng = engines.make_engine(_cfg(4), device="cpu")
    assert isinstance(eng, ShardedHistogramEngine)
    assert eng.rows_per_shard == 8 and eng.name == "sharded(cuda)"
    eng = engines.make_engine(_cfg(3, height=31), device="cpu")
    assert eng.rows_per_shard == 11 and eng.padded_rows == 33
    # The oracle has no row window: rows fall back to replicas, as the JAX
    # package's registry does for its oracle.
    oracle = dataclasses.replace(_cfg(2).options, engine="oracle")
    assert isinstance(engines.make_engine(
        _cfg(2).replace(options=oracle), device="cpu"), DataParallelEngine)


@pytest.mark.parametrize("precision,scatter", [
    ("float32", "auto"), ("float32", "bigtiles"),
    ("extended", "auto"), ("extended", "bigtiles")])
def test_sharded_matches_replicated_exactly(precision, scatter):
    """Rows == replicas bit for bit, with every stat; on-canvas points ==
    histogram sum (the shards' counters count their own rows once)."""
    launches.reset()
    sharded = _render(_cfg(4, "rows", precision=precision, scatter=scatter))
    ext = "_ext" if precision == "extended" else ""
    kernel = (f"replay_ids{ext}" if scatter == "bigtiles"
              else f"replay_deposit{ext}")
    assert launches.COUNTS[f"{kernel}_plain"] == 4 * 2
    replicated = _render(_cfg(4, "replicated", precision=precision,
                              scatter=scatter))
    assert sharded.histogram.sum() > 0
    np.testing.assert_array_equal(sharded.histogram, replicated.histogram)
    st = dict(sharded.stats)
    assert st.pop("histogram_sharding") == "rows"
    assert st == replicated.stats
    assert st["on_canvas_points"] == int(sharded.histogram.sum())


@pytest.mark.parametrize("n_dev,height", [(8, 30), (3, 41), (4, 5)])
def test_uneven_row_split(n_dev, height):
    """Height not divisible by the devices (shards past the canvas's end
    too): the padded rows never reach the output, and the histogram is
    the replicas'."""
    res = _render(_cfg(n_dev, "rows", height=height))
    assert res.histogram.shape == (height, 32)
    assert res.histogram.sum() > 0
    ref = _render(_cfg(n_dev, "replicated", height=height))
    np.testing.assert_array_equal(res.histogram, ref.histogram)


def test_sharded_resume(tmp_path):
    """A resumed histogram is split into the shards: resuming rows and
    resuming replicas from the same checkpoint give the same histogram."""
    out = {}
    for sharding in ("rows", "replicated"):
        path = str(tmp_path / f"{sharding}.ckpt")
        cfg = _cfg(4, sharding, height=30, inprogress_file=path)
        r1 = _render(cfg)
        r2 = _render(cfg)
        assert r2.histogram.sum() > r1.histogram.sum()
        out[sharding] = r2.histogram
    np.testing.assert_array_equal(out["rows"], out["replicated"])


def test_sharded_deterministic():
    a = _render(_cfg(4, "rows"))
    b = _render(_cfg(4, "rows"))
    np.testing.assert_array_equal(a.histogram, b.histogram)


class _LongestFirst(ShardedHistogramEngine):
    """Re-sorts each gathered batch by descending orbit length (stable;
    unused slots, iters -1, last), as ``chip_smoke.py`` phase 10 does to
    time it."""

    @staticmethod
    def gather(batches, dev):
        cr, ci, it = ShardedHistogramEngine.gather(batches, dev)
        order = torch.sort(it, descending=True, stable=True).indices
        return cr[order], ci[order], it[order]


def test_resort_changes_no_bit():
    """Re-sorting the gathered batch longest first only reorders the
    replay's integer adds."""
    cfg = _cfg(3, height=31)
    hists = []
    for cls in (_LongestFirst, ShardedHistogramEngine):
        eng = cls(cfg, device="cpu")
        state = eng.init_state(None)
        for p in range(2):
            eng.run_pass(state, p)
        hists.append((eng.histogram(state), eng.stats(state)))
    np.testing.assert_array_equal(hists[0][0], hists[1][0])
    assert hists[0][1] == hists[1][1]
    it = torch.tensor([3, -1, 7, 7, 0], dtype=torch.int32)
    cr = torch.arange(5, dtype=torch.float32)
    r, _, i = _LongestFirst.gather([(cr, cr, it)], "cpu")
    assert i.tolist() == [7, 7, 3, 0, -1] and r.tolist() == [2, 3, 0, 4, 1]


@pytest.mark.parametrize("resume", [False, True])
def test_init_state_allocates_no_canvas(monkeypatch, resume):
    """Every device's state is built at its shard's size: no tensor of the
    whole canvas is made on the way (the shards exist so that a canvas
    larger than one device's memory fits)."""
    cfg = _cfg(4, height=30).replace(canvas=Canvas(width=256, height=250))
    eng = ShardedHistogramEngine(cfg, device="cpu")
    hist0 = np.arange(250 * 256, dtype=np.uint32).reshape(250, 256)
    sizes = []
    for name in ("zeros", "empty", "full", "from_numpy", "tensor"):
        make = getattr(torch, name)

        def spy(*a, _make=make, **k):
            t = _make(*a, **k)
            sizes.append(t.numel())
            return t

        monkeypatch.setattr(torch, name, spy)
    states = eng.init_state(hist0 if resume else None)
    monkeypatch.undo()
    assert sizes and max(sizes) <= eng.rows_per_shard * 256 < 250 * 256
    assert [tuple(st["hist"].shape) for st in states] == [(63, 256)] * 4
    if resume:
        np.testing.assert_array_equal(eng.histogram(states), hist0)
    else:
        assert eng.histogram(states).shape == (250, 256)
        assert not eng.histogram(states).any()


def test_mh_with_rows_is_refused():
    cfg = RenderConfig(options=EngineOptions(
        sampler="mh", num_devices=2, histogram_sharding="rows"))
    with pytest.raises(ConfigError, match="incompatible with row-sharded"):
        engines.make_engine(cfg, device="cpu")
