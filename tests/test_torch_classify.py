"""The classify pass's plain version vs the JAX Pallas kernel (interpret
mode), from one carried lane state.

Both draw the same Threefry words (or the same given bits), cull and band
alike, and round every operation once — but the JAX kernel runs jitted on
XLA's CPU backend, which contracts z^2 + c into fused multiply-adds. A
lane whose orbit sits near the escape radius can then finish one step
apart, shifting its later draws. So the test requires exact equality of
the emission slots (escape index and c, bit for bit) for >= 99% of them
(measured 99.12-100% over the cases below), of the end-of-pass lane
state for >= 97% of lanes (a diverged lane stays diverged for the rest of
the pass; measured 98.05-100%), and per-pass stat totals within 2% or 5
counts (measured at most 0.8%, 3 cycles). The card holds the CUDA kernel
to this plain version bitwise (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.models import fractals as jfr
from cudabrot_tpu.ops import pallas_kernels as pk
from cudabrot_tpu_torch import convert
from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.ops import launches
from cudabrot_tpu_torch.utils import counters

# The suite runs in several worker processes at once: one intra-op thread
# each keeps PyTorch's thread pools from oversubscribing the cores (two
# workers spinning on eight cores made a 4 s oracle pass take 386 s).
torch.set_num_threads(1)

ROWS = 2
STEPS = 256


def _start_state(fr, kw):
    """A mid-flight lane state: one JAX pass from the all-dead start,
    carried into the port through convert.state_from_jax."""
    lanes = pk.classify_pass(pk.init_lane_state(ROWS),
                             jnp.asarray([11, 22], jnp.uint32), fractal=fr,
                             interpret=True, **kw).state
    np_state = {"hist": np.zeros((4, 4), np.uint32),
                "lanes": tuple(np.asarray(a) for a in lanes)}
    for k in counters.STAT_KEYS:
        np_state[k] = (np.uint32(0), np.uint32(0))
    return lanes, convert.state_from_jax(np_state)["lanes"]


def _slots_equal(jc, jit, tc, tit):
    """Per emission slot: same escape index, and (when valid) the same c
    bit for bit."""
    jc, tc = np.asarray(jc).view(np.int32), tc.numpy().view(np.int32)
    jit, tit = np.asarray(jit), tit.numpy()
    same_c = (jc[:, 0] == tc[:, 0]) & (jc[:, 1] == tc[:, 1])
    return (jit == tit) & ((jit < 0) | same_c)


CASES = [
    # (fractal, band, flush, unroll, thin, rng)
    ("buddhabrot", (5, 60), 32, 1, False, "threefry"),
    ("buddhabrot", (5, 60), 32, 4, True, "threefry"),
    ("buddhabrot", (20, 300), 64, 8, True, "bits"),
    ("buddhabrot", (20, 300), 64, 2, False, "bits"),
    ("burning-ship", (5, 60), 32, 4, True, "threefry"),
    ("anti-buddhabrot", (5, 60), 32, 2, True, "threefry"),
]


@pytest.mark.parametrize("name,band,flush,unroll,thin,rng", CASES)
def test_classify_matches_jax_kernel(name, band, flush, unroll, thin, rng):
    kw = dict(min_it=band[0], max_it=band[1], steps_per_pass=STEPS,
              steps_per_flush=flush, inner_unroll=unroll, thin_tracking=thin)
    j_lanes, t_lanes = _start_state(jfr.FRACTALS[name], kw)
    seed = (0x9E3779B9, 0x7F4A7C15)
    chunks, windows = STEPS // flush, flush // unroll
    bits = None
    if rng == "bits":
        bits = np.random.default_rng(4).integers(
            0, 2**32, (chunks, windows, 2, ROWS, 128), dtype=np.uint64
        ).astype(np.uint32)
    ref = pk.classify_pass(
        j_lanes, jnp.asarray(seed, jnp.uint32),
        None if bits is None else jnp.asarray(bits),
        fractal=jfr.FRACTALS[name], interpret=True, **kw)
    launches.reset()
    got = cls.classify_pass(
        t_lanes, seed,
        None if bits is None else torch.from_numpy(bits.view(np.int32)),
        fractal=tfr.FRACTALS[name], **kw)
    assert launches.COUNTS["classify_plain"] == 1
    assert launches.COUNTS["classify"] == 0

    assert got.emit_c.shape == ref.emit_c.shape
    assert got.emit_it.shape == ref.emit_it.shape
    assert got.stats.shape == ref.stats.shape
    slots = _slots_equal(ref.emit_c, ref.emit_it, got.emit_c, got.emit_it)
    assert slots.mean() >= 0.99, slots.mean()
    for f in ("cr", "ci", "it", "dead"):
        same = np.asarray(getattr(ref.state, f)) == getattr(got.state, f).numpy()
        assert same.mean() >= 0.97, (f, same.mean())
    ref_st = np.asarray(ref.stats).sum(axis=(1, 2))
    got_st = got.stats.numpy().sum(axis=(1, 2))
    np.testing.assert_allclose(got_st, ref_st, rtol=0.02, atol=5)
    assert (np.asarray(ref.emit_it) >= 0).sum() > 0


def test_classify_validation():
    fr = tfr.FRACTALS["buddhabrot"]
    kw = dict(fractal=fr, min_it=5, max_it=60, steps_per_pass=64,
              steps_per_flush=32)
    with pytest.raises(ValueError, match="multiple of steps_per_flush"):
        cls.classify_pass(cls.init_lane_state(1), (1, 2), **{
            **kw, "steps_per_pass": 48})
    with pytest.raises(ValueError, match="visit_window requires"):
        cls.classify_pass(cls.init_lane_state(1), (1, 2), **kw,
                          visit_window=(-1.0, 1.0, -1.0, 1.0))
    with pytest.raises(ValueError, match="bits has wrong shape"):
        cls.classify_pass(cls.init_lane_state(1), (1, 2),
                          torch.zeros((1, 2, 3), dtype=torch.int32), **kw)
