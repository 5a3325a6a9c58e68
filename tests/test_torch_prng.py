"""cudabrot_tpu_torch randomness and per-lane arithmetic vs the JAX package.

Bitwise throughout: Threefry-2x32 and JAX's key derivation are integer
functions, and the domain map, cull and step are compared against the
JAX functions run eagerly (one XLA op per call, so no fused multiply-add
contraction) — the rounding the TPU kernels and the port both use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudabrot_tpu.models import fractals as jfr
from cudabrot_tpu.ops import pallas_kernels as pk
from cudabrot_tpu_torch.models import fractals as tfr
from cudabrot_tpu_torch.ops import prng


def _bits32(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def test_threefry2x32_matches_jax():
    from jax._src import prng as jprng

    k0, k1 = 0xDEADBEEF, 0x12345678
    x0 = np.arange(4096, dtype=np.uint32)
    x1 = np.arange(4096, 8192, dtype=np.uint32)
    ref = np.asarray(jprng.threefry_2x32(
        jnp.asarray([k0, k1], jnp.uint32), jnp.asarray(np.concatenate([x0, x1]))
    ))
    y0, y1 = prng.threefry2x32(
        k0, k1, torch.from_numpy(x0.astype(np.int64)),
        torch.from_numpy(x1.astype(np.int64)),
    )
    np.testing.assert_array_equal(y0.numpy(), ref[:4096].astype(np.int64))
    np.testing.assert_array_equal(y1.numpy(), ref[4096:].astype(np.int64))
    # The scalar (host) form gives the same words.
    assert prng.threefry2x32(k0, k1, 17, 4096 + 17) == (
        int(ref[17]), int(ref[4096 + 17]))


@pytest.mark.parametrize("seed", [0, 1337, 7, (1 << 40) + 5])
def test_key_fold_in_bits_match_jax(seed):
    key = jax.random.key(seed)
    assert tuple(int(v) for v in jax.random.key_data(key)) == prng.key(seed)
    for data in (0, 1, 0x7711, 0xFFFFFFFF):
        folded = jax.random.key_data(jax.random.fold_in(key, data))
        assert tuple(int(v) for v in folded) == prng.fold_in(
            prng.key(seed), data)
    ref = np.asarray(jax.random.bits(key, (3000,), jnp.uint32))
    got = prng.bits(prng.key(seed), 3000).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("pass_index", [0, 3, 1000])
def test_pass_key_matches_engine_derivation(pass_index):
    """The engine's refill key words: bits(fold_in(fold_in(key(seed),
    ordinal), pass), (2,)) (pallas_engine._classify_and_compact)."""
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.key(1337), jnp.uint32(0)), pass_index)
    ref = [int(v) for v in jax.random.bits(key, (2,), jnp.uint32)]
    assert prng.bits_host(prng.pass_key(1337, 0, pass_index), 2) == ref


@pytest.mark.parametrize(
    "lo,span", [(-2.0, 4.0), (-0.75, 0.013), (0.3, 1e-5), (-1.9, 3.1)]
)
def test_u32_to_domain_matches_jax(lo, span):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    ref = pk._u32_to_domain(jnp.asarray(bits), lo, span)
    got = prng.u32_to_domain(torch.from_numpy(bits.astype(np.int64)), lo, span)
    np.testing.assert_array_equal(got.numpy().view(np.int32), _bits32(ref))


@pytest.mark.parametrize("name", sorted(tfr.FRACTALS))
def test_step_and_cull_match_jax(name):
    rng = np.random.default_rng(2)
    zr, zi, cr, ci = (rng.uniform(-2.2, 2.2, 200_000).astype(np.float32)
                      for _ in range(4))
    j = jfr.FRACTALS[name]
    t = tfr.FRACTALS[name]
    ref = jfr.step(j, *(jnp.asarray(a) for a in (zr, zi, cr, ci)))
    got = tfr.step(t, *(torch.from_numpy(a) for a in (zr, zi, cr, ci)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy().view(np.int32), _bits32(r))
    ref_m = jfr.cull_mask(j, jnp.asarray(cr), jnp.asarray(ci))
    got_m = tfr.cull_mask(t, torch.from_numpy(cr), torch.from_numpy(ci))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
