"""cudabrot_tpu_torch tone mapping, image files and checkpoints vs the JAX
package: bitwise images and bytes, and checkpoints that resume across
the two packages in both directions."""

import dataclasses

import numpy as np
import pytest

from cudabrot_tpu import config as jcfg
from cudabrot_tpu.io import checkpoint as jckpt
from cudabrot_tpu.io import pgm as jpgm
from cudabrot_tpu.io import png as jpng
from cudabrot_tpu.ops import tonemap as jtone
from cudabrot_tpu_torch import config as tcfg
from cudabrot_tpu_torch.io import checkpoint as tckpt
from cudabrot_tpu_torch.io import pgm as tpgm
from cudabrot_tpu_torch.io import png as tpng
from cudabrot_tpu_torch.ops import tonemap as ttone


def _hist(shape=(48, 64), seed=0, high=5000):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, high, shape).astype(np.uint32)
    h[rng.uniform(size=shape) < 0.3] = 0
    return h


@pytest.mark.parametrize("gamma", [1.0, 2.2, 1.5, 0.5, 0.0, -1.0])
def test_tonemap_matches_jax(gamma):
    h = _hist()
    ref = jtone.tonemap_hist(h, gamma)
    got = ttone.tonemap(h, gamma)
    np.testing.assert_array_equal(got.image, np.asarray(ref.image))
    assert got.image.dtype == np.uint16
    assert got.max_count == int(ref.max_count)
    assert got.linear_scale == float(ref.linear_scale)
    assert int(got.image.max()) == 65535  # exact white at the max count


@pytest.mark.parametrize("h", [
    np.zeros((5, 7), np.uint32),                       # empty histogram
    np.full((3, 3), 0xFFFFFFFF, np.uint32),            # uint32 ceiling
    _hist(high=1 << 30).astype(np.uint64) * 7,         # uint64 counts
])
def test_tonemap_edges_match_jax(h):
    ref = jtone.tonemap_hist(h, 2.2)
    got = ttone.tonemap(h, 2.2)
    np.testing.assert_array_equal(got.image, np.asarray(ref.image))
    assert got.max_count == int(ref.max_count)
    assert got.linear_scale == float(ref.linear_scale)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_pgm_bytes_match_jax(tmp_path, dtype):
    img = _hist(seed=1, high=np.iinfo(dtype).max).astype(dtype)
    jpgm.write_pgm(str(tmp_path / "j.pgm"), img)
    tpgm.write_pgm(str(tmp_path / "t.pgm"), img)
    assert (tmp_path / "j.pgm").read_bytes() == (tmp_path / "t.pgm").read_bytes()
    np.testing.assert_array_equal(tpgm.read_pgm(str(tmp_path / "t.pgm")), img)


@pytest.mark.parametrize("shape", [(48, 64), (48, 64, 3)])
def test_png_bytes_match_jax(tmp_path, shape):
    img = np.random.default_rng(2).integers(0, 65535, shape).astype(np.uint16)
    jpng.write_png(str(tmp_path / "j.png"), img)
    tpng.write_png(str(tmp_path / "t.png"), img)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "t.png")), img)


def _cfgs(**kw):
    """The same render in both packages' config classes."""
    canvas = dict(width=64, height=48, min_real=-1.5, max_real=1.0)
    band = dict(max_escape_iterations=200, min_escape_iterations=10)
    return tuple(
        m.RenderConfig(canvas=m.Canvas(**canvas),
                       band=m.IterationBand(**band), seed=5, **kw)
        for m in (jcfg, tcfg)
    )


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    jc, tc = _cfgs()
    h = _hist(seed=3, high=1 << 31)
    path = str(tmp_path / "ck.npz")
    (jckpt if writer == "jax" else tckpt).save(path, h, jc if writer == "jax"
                                              else tc, 17)
    for mod, cfg in ((jckpt, jc), (tckpt, tc)):
        hist, meta = mod.load(path, cfg)
        np.testing.assert_array_equal(hist, h)
        assert hist.dtype == np.uint32 and meta["passes"] == 17
    # Both packages write the same metadata for the same render.
    assert tckpt._metadata(tc, 17) == jckpt._metadata(jc, 17)


def test_checkpoint_guards_match_jax(tmp_path):
    """A mismatched canvas is refused by both packages with one message;
    a reference raw dump loads in both."""
    jc, tc = _cfgs()
    path = str(tmp_path / "ck.npz")
    tckpt.save(path, _hist(seed=4), tc, 1)
    other_t = dataclasses.replace(tc, canvas=tcfg.Canvas(width=64, height=48))
    other_j = dataclasses.replace(jc, canvas=jcfg.Canvas(width=64, height=48))
    with pytest.raises(tckpt.CheckpointError) as et:
        tckpt.load(path, other_t)
    with pytest.raises(jckpt.CheckpointError) as ej:
        jckpt.load(path, other_j)
    assert str(et.value) == str(ej.value)
    raw = tmp_path / "raw.bin"
    h = _hist(seed=5)
    h.astype("<u4").tofile(raw)
    np.testing.assert_array_equal(tckpt.load(str(raw), tc)[0], h)
