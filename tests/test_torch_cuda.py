"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (the kernels build at first
use) and skips elsewhere; run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a CUDA machine
need not have; this file needs only PyTorch.)

Both sides round every operation once and add integers exactly, so every
comparison is bitwise — including a whole engine pass on the card against
the same pass on the CPU.
"""

import itertools

import numpy as np
import pytest
import torch

from cudabrot_tpu_torch import config
from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
from cudabrot_tpu_torch.models.fractals import FRACTALS
from cudabrot_tpu_torch.ops import binning, launches, prng
from cudabrot_tpu_torch.ops import classify as cls

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize(
    "name,thin,visit,use_bits",
    [(n, t, v, b) for n, t, v, b in itertools.product(
        sorted(FRACTALS), (True, False), (False, True), (False, True))
     if t or not v],
)
def test_classify_kernel_matches_plain(cuda, name, thin, visit, use_bits):
    rows, steps, flush, unroll = 16, 128, 32, 4
    kw = dict(fractal=FRACTALS[name], min_it=10, max_it=300,
              steps_per_pass=steps, steps_per_flush=flush,
              inner_unroll=unroll, thin_tracking=thin,
              visit_window=(-1.5, 0.5, -1.0, 1.0) if visit else None)
    state = cls.init_lane_state(rows, cuda)
    cls.classify_pass(state, (5, 6), **kw)  # carried, mid-flight state
    a = cls.LaneState(*(t.clone() for t in state))
    b = cls.LaneState(*(t.clone() for t in state))
    bits = None
    if use_bits:
        shape = (steps // flush, flush // unroll, 2, rows, 128)
        bits = torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=cuda)
    launches.reset()
    ra = cls.classify_pass(a, (7, 8), bits, **kw)
    assert launches.COUNTS["classify"] == 1
    rb = cls.classify_pass_plain(
        b, 7, 8, bits, fractal=kw["fractal"], min_it=10, max_it=300,
        chunks=steps // flush, windows=flush // unroll, unroll=unroll,
        thin=thin, detect=FRACTALS[name].cycle_detect,
        sample_domain=config.SAMPLE_DOMAIN, visit_window=kw["visit_window"])
    for x, y in zip(ra.state, rb.state):
        assert _same(x, y)
    assert _same(ra.emit_c, rb.emit_c)
    assert _same(ra.emit_it, rb.emit_it)
    assert _same(ra.stats, rb.stats)


@pytest.mark.parametrize("n", [1, 1000, 1 << 23])
def test_threefry_bits_kernel_matches_plain(cuda, n):
    key = prng.fold_in(prng.key(1337), 0x7711)
    assert torch.equal(prng.bits(key, n, cuda), prng.bits_plain(key, n, cuda))


@pytest.mark.parametrize("w,h", [(1000, 1000), (6000, 4500)])
def test_deposit_ids_kernel_matches_plain(cuda, w, h):
    nbins = w * h
    ids = torch.randint(0, nbins + 1, (1 << 22,), dtype=torch.int32,
                        device=cuda)
    hk = torch.zeros(nbins, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    binning.deposit_ids(hk, ids)
    binning.deposit_ids_plain(hp, ids)
    assert torch.equal(hk, hp)


@pytest.mark.parametrize("name", sorted(FRACTALS))
def test_replay_deposit_kernel_matches_plain(cuda, name):
    canvas = config.Canvas(width=300, height=200, min_real=-2.0,
                           max_real=1.0, min_imag=-1.2, max_imag=1.2)
    g = torch.Generator(device=cuda).manual_seed(3)
    k = 1 << 16
    cr = torch.rand(k, generator=g, device=cuda) * 3.0 - 2.0
    ci = torch.rand(k, generator=g, device=cuda) * 3.0 - 1.5
    it = torch.randint(-1, 200, (k,), generator=g, device=cuda,
                       dtype=torch.int32)
    it = torch.sort(it, descending=True).values
    hk = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=cuda)
    hp = torch.zeros_like(hk)
    hits_k = binning.replay_deposit(hk, cr, ci, it, canvas=canvas,
                                    fractal=FRACTALS[name])
    hits_p = binning.replay_deposit_plain(hp, cr, ci, it, canvas=canvas,
                                          fractal=FRACTALS[name])
    assert torch.equal(hk, hp)
    assert int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum())


def test_engine_pass_on_card_matches_cpu(cuda):
    """Three engine passes on the card equal the same passes on the CPU
    bitwise: histogram, lane state and every counter."""
    cfg = config.RenderConfig(
        canvas=config.Canvas(width=64, height=48),
        options=config.EngineOptions(lane_rows=8, steps_per_pass=256,
                                     steps_per_flush=32,
                                     replay_capacity=1 << 14),
    )
    runs = []
    for dev in (cuda, "cpu"):
        eng = CudaEngine(cfg, device=dev)
        st = eng.init_state(None)
        for p in range(3):
            st = eng.run_pass(st, p)
        runs.append((eng.histogram(st), eng.stats(st), st["lanes"]))
    (hg, sg, lg), (hc, sc, lc) = runs
    np.testing.assert_array_equal(hg, hc)
    assert sg == sc
    for x, y in zip(lg, lc):
        assert _same(x, y)
