"""The port's render-color (cudabrot_tpu_torch.color) on the CPU, against
the JAX package's (cudabrot_tpu.color).

The combine functions are numpy copies: on the same seeded inputs they
equal the JAX module's bitwise, and save_rgb writes the same bytes. The
bands render through the port's engines (``device="cpu"``: the kernels'
plain versions): interleaved and sequential band histograms are bitwise
equal and the PNGs byte-identical, through the oracle and through the cuda
engine at a small geometry. The port's oracle equals the eager JAX oracle
bitwise, so an oracle colour render through the port writes the same band
PGMs and PNG as ``cudabrot_tpu.color.main`` under ``jax.disable_jit()``.
"""

import jax
import numpy as np
import pytest
import torch

from cudabrot_tpu import color as jcolor
from cudabrot_tpu_torch import cli, color
from cudabrot_tpu_torch.io import pgm
from cudabrot_tpu_torch.io import png as png_io
from cudabrot_tpu_torch.ops import launches

torch.set_num_threads(1)


def _gray(rng, dtype, shape=(37, 53)):
    if dtype == np.float32:
        return rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


def _combine(mod, case, rng):
    """One copied function of ``mod`` on ``case``'s seeded inputs; the
    image cases write a file and return its bytes."""
    if case == "normalize":
        return [mod.normalize(_gray(rng, d)) for d in
                (np.uint8, np.uint16, np.float32)] + [
            mod.normalize(np.full((8, 8), 7, np.uint16))]
    if case == "combine_rgb":
        return mod.combine_rgb([(_gray(rng, np.uint16), "blue"),
                                (_gray(rng, np.uint8), "lime"),
                                (_gray(rng, np.float32), "orange")])
    if case == "hsl_to_rgb":
        h, s, l_ = (rng.uniform(0, 1, (41, 29)) for _ in range(3))
        return mod.hsl_to_rgb(h, s, l_)
    if case == "combine_hsl":
        return mod.combine_hsl(_gray(rng, np.uint16), _gray(rng, np.uint16),
                               _gray(rng, np.float32), adjust_hue=0.3)
    path = case.path
    mod.save_rgb(str(path), rng.uniform(0, 1, (23, 31, 3)))
    written = path.with_name(path.name[:-2]) if path.name.endswith(
        "16") else path
    return written.read_bytes()


class _Save:
    def __init__(self, path):
        self.path = path


@pytest.mark.parametrize("case", ["normalize", "combine_rgb", "hsl_to_rgb",
                                  "combine_hsl", "save_rgb", "save_rgb16"])
def test_combine_functions_bitwise_vs_jax(case, tmp_path):
    """The copied numpy functions equal cudabrot_tpu.color's on the same
    seeded inputs bit for bit (save_rgb: identical file bytes, 8-bit and
    16-bit)."""
    args = {"save_rgb": lambda who: _Save(tmp_path / f"{who}.png"),
            "save_rgb16": lambda who: _Save(tmp_path / f"{who}.png16")}
    out = []
    for who, mod in (("port", color), ("jax", jcolor)):
        c = args[case](who) if case in args else case
        out.append(_combine(mod, c, np.random.default_rng(17)))
    got, want = out
    if isinstance(got, bytes):
        assert got == want and len(got) > 100
        return
    got, want = (x if isinstance(x, list) else [x] for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


#: The JAX test's interleave case (tests/test_color.py), and the cuda
#: engine at a small geometry.
ORACLE_RGB = ["--mode", "rgb", "-w", "20", "-h", "20", "--engine", "oracle",
              "--passes", "2", "--band", "blue:40:4:1.0:600",
              "--band", "lime:60:10:1.0:600", "--band", "red:90:30:1.0:600",
              "--keep-bands"]
CUDA_HSL = ["--mode", "hsl", "-w", "24", "-h", "20", "--lane-rows", "2",
            "--steps-per-pass", "256", "--steps-per-flush", "32",
            "--replay-capacity", "2048", "--passes", "3", "--normalize",
            "--band", "H:200:20:-1:600", "--band", "S:60:5:-1:600",
            "--band", "L:400:100:-1:600", "--keep-bands"]


@pytest.mark.parametrize("argv,keys,engine", [
    (ORACLE_RGB, ("blue", "lime", "red"), "oracle"),
    (CUDA_HSL, ("H", "S", "L"), "cuda"),
])
def test_interleaved_matches_sequential_bitwise(tmp_path, monkeypatch, argv,
                                                keys, engine):
    """--interleave gives every band the histogram and stats of the
    sequential loop, bit for bit, and the same PNG bytes: the bands are
    independent renders."""
    monkeypatch.chdir(tmp_path)
    runs = []
    real = color.render_bands

    def keep(*a, **k):
        runs.append(real(*a, **k))
        return runs[-1]

    monkeypatch.setattr(color, "render_bands", keep)
    for mode in ("seq", "il"):
        launches.reset()
        rc = cli.main(["render-color", *argv, "-o", f"{mode}.png",
                       *(["--interleave"] if mode == "il" else [])],
                      device="cpu")
        assert rc == 0
        if engine == "cuda":
            assert launches.COUNTS["classify_plain"] == 3 * len(keys)
            assert launches.COUNTS["replay_deposit_plain"] == 3 * len(keys)
        for k in keys:
            (tmp_path / f"band_{k}.pgm").rename(tmp_path / f"{mode}_{k}.pgm")
    seq, il = runs
    for k in keys:
        assert seq[k].engine_name == il[k].engine_name == engine
        np.testing.assert_array_equal(seq[k].histogram, il[k].histogram)
        assert seq[k].stats == il[k].stats
        total = int(seq[k].histogram.sum())
        assert total == seq[k].stats.get("on_canvas_points", total) > 0
        assert (tmp_path / f"seq_{k}.pgm").read_bytes() == \
            (tmp_path / f"il_{k}.pgm").read_bytes()
    assert (tmp_path / "seq.png").read_bytes() == \
        (tmp_path / "il.png").read_bytes()
    assert png_io.read_png(str(tmp_path / "il.png")).shape == (
        *seq[keys[0]].histogram.shape, 3)


def test_render_color_extended_deep_zoom(tmp_path, monkeypatch):
    """--precision extended and --sample-domain forward through the colour
    pipeline (the JAX test's colour deep-zoom case, README 'Deep zoom')."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "dz.png")
    win = "-0.7500005,-0.7499995,0.0549995,0.0550005"
    rc = cli.main(["render-color", "--mode", "hsl", "-o", out, "-w", "16",
                   "-h", "16", "--engine", "oracle", "--precision",
                   "extended", "--sample-domain", win, "--passes", "1",
                   "--band", "H:40:5:1.0:1", "--band", "S:80:40:1.0:1",
                   "--band", "L:160:50:1.0:1"], device="cpu")
    assert rc == 0
    assert png_io.read_png(out).shape == (16, 16, 3)


def test_oracle_color_render_bytes_equal_eager_jax(tmp_path, monkeypatch):
    """A 20x20 oracle render of three bands through the port writes the
    band PGMs and the PNG of cudabrot_tpu.color.main run eagerly
    (jax.disable_jit()) byte for byte."""
    argv = ["--mode", "rgb", "-w", "20", "-h", "20", "--engine", "oracle",
            "--passes", "1", "--band", "blue:30:4:2.0:600",
            "--band", "lime:40:10:1.0:600", "--band", "red:50:20:2.5:600",
            "--keep-bands", "--normalize"]
    files = {}
    for who in ("port", "jax"):
        d = tmp_path / who
        d.mkdir()
        monkeypatch.chdir(d)
        if who == "port":
            rc = color.main([*argv, "-o", "c.png"], device="cpu")
        else:
            with jax.disable_jit():
                rc = jcolor.main([*argv, "-o", "c.png"])
        assert rc == 0
        files[who] = {n: (d / n).read_bytes() for n in (
            "c.png", "band_blue.pgm", "band_lime.pgm", "band_red.pgm")}
    assert files["port"] == files["jax"]
    assert pgm.read_pgm(str(tmp_path / "port" / "band_blue.pgm")).max() > 0
