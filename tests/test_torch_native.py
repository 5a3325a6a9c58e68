"""The port's binding of the native host replay (``cudabrot_tpu_torch/io/
native.py``) against the JAX package's (``cudabrot_tpu/io/native.py``).

The port builds ``csrc/tpubrot_native.cpp`` with g++ into
``build/cudabrot_tpu_torch/``; the JAX package loads its ``make -C csrc``
build. Both compile the same source with the same flags, so every entry
point must agree bitwise: uint32 and uint64 bins, the strict and the
contracted f32 orbit, the burning-ship fold, one thread and four. The
strict replay equals the port's plain ``replay_deposit`` except at bin
edges, where the native replay multiplies by a float32 reciprocal of the
pitch and the port's device replay divides; the difference is counted and
bounded.
"""

import numpy as np
import pytest
import torch

from cudabrot_tpu.io import native as jnative
from cudabrot_tpu_torch.config import Canvas
from cudabrot_tpu_torch.io import native
from cudabrot_tpu_torch.models import fractals
from cudabrot_tpu_torch.ops import binning

pytestmark = pytest.mark.skipif(
    not jnative.available(), reason="the JAX package's native library "
    "is not built")

torch.set_num_threads(1)

CANVAS = Canvas(width=64, height=48, min_real=-2.0, max_real=1.0,
                min_imag=-1.2, max_imag=1.2)
KW = dict(width=CANVAS.width, height=CANVAS.height,
          min_real=CANVAS.min_real, min_imag=CANVAS.min_imag,
          delta_real=CANVAS.delta_real, delta_imag=CANVAS.delta_imag)


def _band_samples(n, max_it=120, min_it=2, seed=0, ship=False):
    """In-band samples of a strict float32 escape loop: (cr, ci, iters),
    iters = -1 out of band."""
    rng = np.random.default_rng(seed)
    cr = rng.uniform(-2, 2, n).astype(np.float32)
    ci = rng.uniform(-2, 2, n).astype(np.float32)
    zr, zi = cr.copy(), ci.copy()
    esc = np.full(n, -1, np.int32)
    two = np.float32(2.0)
    with np.errstate(over="ignore", invalid="ignore"):
        for s in range(max_it):
            ar, ai = (np.abs(zr), np.abs(zi)) if ship else (zr, zi)
            zr, zi = (ar * ar - ai * ai) + cr, (two * ar) * ai + ci
            hit = (esc < 0) & ~(zr * zr + zi * zi <= 4.0)
            esc[hit] = s
    esc = np.where((esc >= min_it) & (esc < max_it), esc, -1)
    return cr, ci, esc.astype(np.int32)


@pytest.fixture(scope="module")
def batch():
    cr, ci, it = _band_samples(6000)
    keep = it >= 0
    # Tiled so four threads each get the >= 1024 samples the native
    # replay needs before it splits a batch.
    reps = -(-4 * 1024 * 2 // int(keep.sum()))
    return tuple(np.tile(x[keep], reps) for x in (cr, ci, it))


def test_port_build_loads():
    lib = native.load()
    path = native.lib_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "cudabrot_tpu_torch")
    assert "csrc" not in path.parent.parts
    assert native.supports_f64()
    for name in native.ENTRY_POINTS:
        assert hasattr(lib, name)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("ship", [False, True])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_replay_scatter_matches_jax(batch, dtype, strict, ship, threads):
    cr, ci, it = batch
    if ship:
        cr, ci, it = _band_samples(9000, ship=True, seed=3)
    a = np.zeros(CANVAS.shape, dtype)
    b = np.zeros(CANVAS.shape, dtype)
    ra = native.replay_scatter(cr, ci, it, a, burning_ship=ship,
                               num_threads=threads, strict=strict, **KW)
    rb = jnative.replay_scatter(cr, ci, it, b, burning_ship=ship,
                                num_threads=threads, strict=strict, **KW)
    assert ra == rb and ra[0] > 0
    assert ra[1] == int((it[it >= 0].astype(np.int64) + 1).sum())
    np.testing.assert_array_equal(a, b)
    assert int(a.sum(dtype=np.uint64)) == ra[0]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("ship", [False, True])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_replay_scatter_f64_matches_jax(batch, dtype, ship, threads):
    cr, ci, it = (batch[0].astype(np.float64) + 1e-9,
                  batch[1].astype(np.float64), batch[2])
    a = np.zeros(CANVAS.shape, dtype)
    b = np.zeros(CANVAS.shape, dtype)
    ra = native.replay_scatter_f64(cr, ci, it, a, burning_ship=ship,
                                   num_threads=threads, **KW)
    rb = jnative.replay_scatter_f64(cr, ci, it, b, burning_ship=ship,
                                    num_threads=threads, **KW)
    assert ra == rb and ra[0] > 0
    np.testing.assert_array_equal(a, b)


def test_invalid_lanes_and_empty_batch():
    hist = np.zeros(CANVAS.shape, np.uint32)
    cr = np.array([2.5, 0.3], np.float32)
    ci = np.array([0.0, 0.1], np.float32)
    it = np.array([-1, 0], np.int32)  # the first lane is inactive
    hits, points = native.replay_scatter(cr, ci, it, hist, strict=True, **KW)
    assert points == 1 and hits == int(hist.sum()) <= 1
    empty = np.zeros(0, np.float32)
    assert native.replay_scatter(empty, empty, np.zeros(0, np.int32), hist,
                                 **KW) == (0, 0)
    assert native.replay_scatter_f64(empty.astype(np.float64),
                                     empty.astype(np.float64),
                                     np.zeros(0, np.int32), hist,
                                     **KW) == (0, 0)
    with pytest.raises(ValueError, match="width x height"):
        native.replay_scatter(cr, ci, it, np.zeros((3, 3), np.uint32), **KW)
    with pytest.raises(ValueError, match="uint32 or uint64"):
        native.replay_scatter(cr, ci, it, np.zeros(CANVAS.shape, np.int32),
                              **KW)


def test_uint64_accumulates_past_the_uint32_range():
    hist = np.full(CANVAS.shape, 0xFFFFFFFF, np.uint64)
    cr, ci, it = _band_samples(512, seed=5)
    hits, _ = native.replay_scatter(cr, ci, it, hist, strict=True, **KW)
    assert hits > 0 and int(hist.max()) > 0xFFFFFFFF
    assert int(hist.sum(dtype=np.uint64)) == 0xFFFFFFFF * hist.size + hits


def test_strict_replay_vs_plain_replay_deposit():
    """The strict native replay follows the port's orbit bitwise, so only
    points on a bin edge may land differently: the counts of replayed
    points are equal, and the mass placed differently (half the L1
    distance of the histograms: each moved point once) is below 1e-4 of
    the histogram's (an edge is within an ulp of the bin coordinate)."""
    canvas = Canvas(width=1000, height=1000)
    cr, ci, it = _band_samples(200_000, max_it=100, min_it=20, seed=7)
    keep = it >= 0
    cr, ci, it = cr[keep], ci[keep], it[keep]
    host = np.zeros(canvas.shape, np.uint32)
    hits, points = native.replay_scatter(
        cr, ci, it, host, strict=True, width=canvas.width,
        height=canvas.height, min_real=canvas.min_real,
        min_imag=canvas.min_imag, delta_real=canvas.delta_real,
        delta_imag=canvas.delta_imag)
    dev = torch.zeros(canvas.num_pixels, dtype=torch.int32)
    dev_hits = binning.replay_deposit_plain(
        dev, torch.from_numpy(cr), torch.from_numpy(ci),
        torch.from_numpy(it), canvas=canvas,
        fractal=fractals.get_fractal("buddhabrot"))
    dev = dev.numpy().view(np.uint32).reshape(canvas.shape)
    assert points == int((it.astype(np.int64) + 1).sum())
    l1 = int(np.abs(host.astype(np.int64) - dev.astype(np.int64)).sum())
    assert abs(hits - int(dev_hits)) <= l1
    assert 0 < l1 / 2 < 1e-4 * hits, (l1, hits)


def test_missing_compiler_is_an_error(monkeypatch, tmp_path):
    """No g++, or a g++ that fails: NativeError naming the cause, never a
    fallback."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "lib_path",
                        lambda: tmp_path / "libtpubrot_native-test.so")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(native.NativeError, match="g\\+\\+ not found"):
        native.load()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeError, match="failed to run"):
        native.load()
    fake = tmp_path / "false-cxx"
    fake.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(native.NativeError, match="exit 3"):
        native.load()
    assert not any(tmp_path.glob("*.so"))
