"""Threefry-2x32 (20 rounds) and JAX's key derivation, frozen.

The renderer draws every sample from this counter-based generator, keyed
the way ``jax.random`` keys it in partitionable mode. The reference keeps
its own copy, so that nothing it computes comes from the program:

  * ``key(s)`` = ``(s >> 32, s & 0xFFFFFFFF)`` for a 64-bit seed;
  * ``fold_in(k, d)`` = ``threefry2x32(k, (0, d))``;
  * ``bits(k, n)`` = ``x0 ^ x1`` with ``(x0, x1) = threefry2x32(k, (0,
    iota(n)))``.

Words are Python ints or int64 tensors holding uint32 values; every sum
and shift is masked back to 32 bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round block function on two key and two counter words."""
    ks = (k0, k1, (k0 ^ k1 ^ PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(k[0], k[1], 0, int(data) & MASK32)


def bits(k: tuple[int, int], n: int, device) -> torch.Tensor:
    """``n`` uint32 words as an int64 tensor."""
    counter = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k[0], k[1], torch.zeros_like(counter), counter)
    return x0 ^ x1


def bits_host(k: tuple[int, int], n: int) -> list[int]:
    return [a ^ b for a, b in (threefry2x32(k[0], k[1], 0, j)
                               for j in range(n))]


def pass_key(seed: int, ordinal: int, pass_index: int) -> tuple[int, int]:
    """The key of one pass of one device: fold_in(fold_in(key(seed),
    ordinal), pass_index)."""
    return fold_in(fold_in(key(seed), ordinal), pass_index)
