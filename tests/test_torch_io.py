"""cudabrot_tpu_torch tone mapping, image files and checkpoints vs the JAX
package: bitwise images and bytes, and checkpoints that resume across
the two packages in both directions."""

import dataclasses

import numpy as np
import pytest
import torch

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

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)


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


_DEEP = (-0.7436488870, -0.7436388870, 0.1318209042, 0.1318309042)


def _deep_cfgs(precision, engine="auto"):
    """One deep-zoom render in both packages' config classes."""
    return tuple(
        m.RenderConfig(
            canvas=m.Canvas(width=64, height=48, min_real=_DEEP[0],
                            max_real=_DEEP[1], min_imag=_DEEP[2],
                            max_imag=_DEEP[3]),
            band=m.IterationBand(max_escape_iterations=2000,
                                 min_escape_iterations=50),
            sample_domain=_DEEP, seed=5,
            options=m.EngineOptions(precision=precision, engine=engine))
        for m in (jcfg, tcfg)
    )


@pytest.mark.parametrize("have,want", [
    ("extended", "float32"), ("float32", "extended"), ("float64", "float32"),
])
def test_checkpoint_precision_guard(tmp_path, have, want):
    """Resuming across precision classes (float32 against extended or
    float64) is a CheckpointError that names the precision, the same in
    both packages."""
    path = str(tmp_path / "ck.npz")
    engine = "oracle" if "float64" in (have, want) else "auto"
    tckpt.save(path, _hist(), _deep_cfgs(have, engine)[1], 3)
    jc, tc = _deep_cfgs(want, engine)
    with pytest.raises(tckpt.CheckpointError, match="precision") as et:
        tckpt.load(path, tc)
    assert repr(have) in str(et.value) and repr(want) in str(et.value)
    with pytest.raises(jckpt.CheckpointError) as ej:
        jckpt.load(path, jc)
    assert str(et.value) == str(ej.value)


def test_extended_checkpoint_resumes_across_packages(tmp_path):
    """A checkpoint the JAX package wrote at extended precision resumes on
    the port at extended and, the same resolution class, at float64 on the
    oracle; through the CLI the mismatch is a clean message, not a
    traceback."""
    from cudabrot_tpu_torch import cli

    jc, tc = _deep_cfgs("extended")
    h = _hist(seed=8)
    path = str(tmp_path / "ck.npz")
    jckpt.save(path, h, jc, 9)
    hist, meta = tckpt.load(path, tc)
    np.testing.assert_array_equal(hist, h)
    assert meta["passes"] == 9 and meta["precision"] == "extended"
    assert tckpt._metadata(tc, 9) == jckpt._metadata(jc, 9)
    np.testing.assert_array_equal(
        tckpt.load(path, _deep_cfgs("float64", "oracle")[1])[0], h)

    argv = ["-w", "64", "-h", "48", "-m", "2000", "-c", "50",
            "--min-real", repr(_DEEP[0]), "--max-real", repr(_DEEP[1]),
            "--min-imag", repr(_DEEP[2]), "--max-imag", repr(_DEEP[3]),
            "--sample-domain", ",".join(map(repr, _DEEP)), "--seed", "5",
            "--lane-rows", "2", "--steps-per-pass", "256",
            "--steps-per-flush", "64", "--passes", "1", "-t", "-1",
            "-s", path, "-o", str(tmp_path / "x.pgm")]
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv, device="cpu")  # float32 against extended
    assert rc == 1
    assert "precision 'extended'" in buf.getvalue()
    assert "Traceback" not in buf.getvalue()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([*argv, "--precision", "extended"], device="cpu")
    assert rc == 0
    hist2, meta2 = tckpt.load(path, tc)
    assert meta2["passes"] == 10
    assert int(hist2.sum(dtype=np.uint64)) >= int(h.sum(dtype=np.uint64))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("have,want", [("mh", "uniform"), ("uniform", "mh")])
def test_checkpoint_weight_scale_guard(tmp_path, writer, have, want):
    """An MH histogram counts in 1/256 units, a uniform one in raw points:
    resuming one as the other is a CheckpointError with the same message in
    both packages, whichever package wrote the file; the matching sampler
    resumes in both, and both write the same metadata (weight_scale 256
    with --sampler mh, else 1)."""
    def cfgs(sampler):
        return tuple(
            dataclasses.replace(c, options=m.EngineOptions(sampler=sampler))
            for c, m in zip(_cfgs(), (jcfg, tcfg)))

    jh, th = cfgs(have)
    jw, tw = cfgs(want)
    assert tckpt._metadata(th, 4) == jckpt._metadata(jh, 4)
    assert tckpt._metadata(th, 4)["weight_scale"] == (
        256 if have == "mh" else 1)
    path = str(tmp_path / "ck.npz")
    h = _hist(seed=6)
    if writer == "jax":
        jckpt.save(path, h, jh, 4)
    else:
        tckpt.save(path, h, th, 4)
    for mod, cfg in ((jckpt, jh), (tckpt, th)):
        hist, meta = mod.load(path, cfg)
        np.testing.assert_array_equal(hist, h)
        assert meta["passes"] == 4
    with pytest.raises(tckpt.CheckpointError,
                       match="matching --sampler") as et:
        tckpt.load(path, tw)
    with pytest.raises(jckpt.CheckpointError) as ej:
        jckpt.load(path, jw)
    assert str(et.value) == str(ej.value)
    assert "1/256" in str(et.value)
