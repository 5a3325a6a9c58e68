"""Double-float (df32) arithmetic on tensors: ~48-bit-mantissa reals as
(hi, lo) float32 pairs, for the extended-precision deep-zoom path.

Port of ``cudabrot_tpu/ops/df32.py``. Plain f32 quantizes orbit positions
at ulp(|z|) <= 2^-22 near |z| = 2, so canvases narrower than ~1e-4 band;
a hi+lo float32 pair carries ~2^-48 relative precision and extends usable
canvas widths by about nine decades in pure f32 arithmetic. A df value is
the pair (hi, lo) with hi = RN(hi + lo).

Error-free transformations hold only when every product and sum rounds
once. Eager PyTorch runs one kernel per operation and never contracts a
multiply into an add, and the CUDA kernels spell every operation with
``__fmul_rn``/``__fadd_rn`` (``csrc/df32.cuh``), so neither needs the JAX
module's runtime-zero seal ``p = a*b + zero`` — a guard against XLA's FMA
contraction — and both drop it: ``p = RN(a*b)``. The functions therefore
take no ``zero`` operand. The one observable difference is the sign of a
product that is exactly zero (``-0.0 + 0.0`` is ``+0.0``); against the
JAX functions called with ``zero = -0.0``, an identity for every value,
these agree bit for bit (tests/test_torch_df32.py). A product's error is
``RN(a*b - p)``, what one fused multiply-add ``fmaf(a, b, -p)`` returns
and the CUDA header computes: in float64 the product of two floats and
its difference from ``p`` are exact, so the one rounding is the
conversion back, and the bits are the FMA's everywhere (signed zeros,
subnormal errors, overflow, NaN). Wherever the product does not overflow
and its error is not subnormal, this is the JAX module's Veltkamp-split
error bit for bit. ``split`` stays the JAX module's bitmask Veltkamp
split, whose halves multiply exactly.

Overflow/NaN: once a component overflows (escaped orbits coasting to the
window edge), hi propagates inf/NaN through every operation; ``mag2 <= 4``
is then false, so NaN counts as escaped.

Every function takes and returns float32 tensors (broadcastable).
"""

from __future__ import annotations

import numpy as np
import torch

#: int32 view of the bit mask 0xFFFFF000 that clears the low 12 mantissa
#: bits.
_SPLIT_MASK = -4096


def two_sum(a, b):
    """s, e with s = RN(a + b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """s, e with s + e == a + b exactly, requiring |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Bitmask Veltkamp split: a == hi + lo with a 12-bit-mantissa hi and
    lo exact by Sterbenz. Truncating widens |lo| to < 2^-11 |a|; all
    partial products of two halves still fit 24 bits exactly."""
    hi = (a.view(torch.int32) & _SPLIT_MASK).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """p, e with p = RN(a * b) and e = RN(a * b - p), fmaf(a, b, -p):
    p + e == a * b exactly wherever the product does not overflow and the
    error is not subnormal."""
    p = a * b
    e = (a.double() * b.double() - p.double()).float()
    return p, e


def two_prod_sqr(a):
    """two_prod(a, a)."""
    return two_prod(a, a)


def add(ah, al, bh, bl):
    """(ah, al) + (bh, bl) -> renormalized df pair."""
    s, e = two_sum(ah, bh)
    e = e + (al + bl)
    return quick_two_sum(s, e)


def add_f(ah, al, b):
    """(ah, al) + float32 b -> renormalized df pair."""
    s, e = two_sum(ah, b)
    e = e + al
    return quick_two_sum(s, e)


def sub(ah, al, bh, bl):
    """(ah, al) - (bh, bl) -> renormalized df pair."""
    return add(ah, al, -bh, -bl)


def mul(ah, al, bh, bl):
    """(ah, al) * (bh, bl) -> renormalized df pair (drops al*bl, below
    2^-48 relative: the standard double-double multiply)."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return quick_two_sum(p, e)


def sqr(ah, al):
    """(ah, al)^2 -> renormalized df pair."""
    p, e = two_prod_sqr(ah)
    e = e + 2.0 * (ah * al)
    return quick_two_sum(p, e)


def neg(ah, al):
    return -ah, -al


def abs_(ah, al):
    """|(ah, al)|: the sign is carried by hi, so both components flip
    where hi is negative."""
    flip = ah < 0.0
    return torch.where(flip, -ah, ah), torch.where(flip, -al, al)


def from_float(x: float) -> tuple[float, float]:
    """Split a Python float (f64) into df32 (hi, lo) Python floats;
    hi + lo reproduces x to ~2^-48 relative."""
    hi = float(np.float32(x))
    lo = float(np.float32(x - hi))
    return hi, lo


def to_float64(hi, lo):
    """Exact f64 value of a df pair, as numpy (tests and host checks)."""

    def f64(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float64)

    return f64(hi) + f64(lo)


def complex_sqr_add(zr, zrl, zi, zil, crh, crl, cih, cil, *,
                    fold_abs: bool = False):
    """One df32 iteration of z <- f(z) + c for the quadratic family
    (f = z^2, or the burning ship's fold-then-square with ``fold_abs``).

    Returns (nzr, nzrl, nzi, nzil, mag2); mag2 is the f32 |z'|^2 of the
    new point from the hi parts (the escape test needs ~1e-3 accuracy).
    """
    if fold_abs:
        zr, zrl = abs_(zr, zrl)
        zi, zil = abs_(zi, zil)
    r2h, r2l = sqr(zr, zrl)
    i2h, i2l = sqr(zi, zil)
    xh, xl = mul(zr, zrl, zi, zil)
    nzr, nzrl = add(r2h, r2l, -i2h, -i2l)
    nzr, nzrl = add(nzr, nzrl, crh, crl)
    # Doubling a df pair is exact (power-of-two scale of both parts).
    nzi, nzil = add(xh + xh, xl + xl, cih, cil)
    mag2 = nzr * nzr + nzi * nzi
    return nzr, nzrl, nzi, nzil, mag2
