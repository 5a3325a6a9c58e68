"""Threefry-2x32 and JAX's key derivation, bit-exact, without JAX.

The engine derives every pass's refill key the way the JAX engine does
(``jax.random.fold_in(fold_in(key(seed), ordinal), pass)`` then
``bits(key, (2,))``), so the port draws the same samples as the reference
from the same seed. JAX's threefry PRNG (partitionable mode) reduces to
three identities on the 20-round Threefry-2x32 block function:

  * ``key(s)`` = ``(s >> 32, s & 0xFFFFFFFF)``;
  * ``fold_in(k, d)`` = ``threefry2x32(k, (0, d))``, and ``split(k)`` is
    its first two children, ``fold_in(k, 0)`` and ``fold_in(k, 1)``;
  * ``bits(k, (n,))`` = ``x0 ^ x1`` with ``(x0, x1) = threefry2x32(k,
    (0, iota(n)))``.

``threefry2x32`` works on Python ints (scalar key derivation on the host)
and on int64 tensors holding uint32 values (PyTorch has no full uint32
arithmetic): every sum and shift is masked back to 32 bits. The CUDA
kernels carry their own uint32 copy (``csrc/orbit.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from cudabrot_tpu_torch.ops import _build, launches

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (the rotation and key-injection schedule of
    ``jax._src.prng.threefry2x32``). Keys and counters are ints or int64
    tensors of uint32 values; returns two of the same."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` as its two key words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(k, data)`` for a uint32 ``data``."""
    return threefry2x32(k[0], k[1], 0, int(data) & MASK32)


def split(k: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """``jax.random.split(k)``: two child keys."""
    return fold_in(k, 0), fold_in(k, 1)


def bits(k: tuple[int, int], n: int, device="cpu") -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` as an int64 tensor of uint32
    values (n < 2^32). On a CUDA device the ``threefry_bits`` kernel
    (``csrc/classify.cu``) computes it; on the CPU, ``bits_plain``."""
    if n >= 1 << 32:
        raise ValueError("bits: at most 2^32 - 1 words")
    device = torch.device(device)
    if device.type == "cpu":
        return bits_plain(k, n, device)
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.cb_threefry_bits(k[0], k[1], n, _build.ptr(out),
                                  _build.stream_of(out))
    _build.check(rc, "threefry_bits kernel")
    launches.COUNTS["threefry_bits"] += 1
    return out


def bits_plain(k: tuple[int, int], n: int, device="cpu") -> torch.Tensor:
    """``bits`` with int64 tensor arithmetic."""
    launches.COUNTS["threefry_bits_plain"] += 1
    counter = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k[0], k[1], torch.zeros_like(counter), counter)
    return x0 ^ x1


def _lib():
    lib = _build.load("classify")
    if lib.cb_threefry_bits.argtypes is None:
        lib.cb_threefry_bits.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cb_threefry_bits.restype = ctypes.c_int
    return lib


def bits_host(k: tuple[int, int], n: int) -> list[int]:
    """``bits`` for a handful of words, as Python ints (no tensors)."""
    return [a ^ b for a, b in (threefry2x32(k[0], k[1], 0, j)
                               for j in range(n))]


def pass_key(seed: int, ordinal: int, pass_index: int) -> tuple[int, int]:
    """The engine's per-pass key: ``fold_in(fold_in(key(seed), ordinal),
    pass_index)`` (pallas_engine._classify_and_compact)."""
    return fold_in(fold_in(key(seed), ordinal), pass_index)


def uniform(k: tuple[int, int], n: int, dtype, lo: float, hi: float,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, (n,), dtype, lo, hi)`` for float32 or
    float64, bit for bit: random mantissa bits under exponent 0 give a
    float in [1, 2); minus one, times the span, plus ``lo``, clamped at
    ``lo``. float32 takes the top 23 bits of ``bits``; float64 the top 52
    of the 64-bit word ``x0 << 32 | x1``. The bounds round to ``dtype``
    first and the span is their difference in ``dtype``, as in JAX."""
    device = torch.device(device)
    if dtype == torch.float32:
        mant = (bits(k, n, device) >> 9) | 0x3F800000
        floats = mant.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        counter = torch.arange(n, dtype=torch.int64, device=device)
        x0, x1 = threefry2x32(k[0], k[1], torch.zeros_like(counter), counter)
        floats = ((x0 << 20) | (x1 >> 12) | 0x3FF0000000000000).view(
            torch.float64)
    else:
        raise ValueError(f"uniform: unsupported dtype {dtype}")
    lo_t = torch.tensor(lo, dtype=dtype, device=device)
    hi_t = torch.tensor(hi, dtype=dtype, device=device)
    return torch.maximum(lo_t, (floats - 1.0) * (hi_t - lo_t) + lo_t)


def u32_to_domain(bits_u32: torch.Tensor, lo: float, span: float):
    """uint32 random words -> uniform float32 in [lo, lo + span): the top
    24 bits, exact in int32 and in the f32 mantissa, times 2^-24
    (``pallas_kernels._u32_to_domain``). ``lo``/``span`` round to f32
    first, as the kernel's constants do."""
    u24 = (bits_u32 >> 8).to(torch.int32)
    u = u24.to(torch.float32) * 5.9604644775390625e-08  # 2^-24
    return u * f32(span, u.device) + f32(lo, u.device)


def f32(value: float, device) -> torch.Tensor:
    """``value`` rounded to a float32 0-dim tensor on ``device``.
    Arithmetic with it is tensor-tensor, which PyTorch does not rewrite
    (its CUDA division may turn a Python scalar divisor into a reciprocal
    multiply, which rounds differently)."""
    return torch.tensor(value, dtype=torch.float32, device=device)
