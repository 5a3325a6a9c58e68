"""Fractal iteration-map registry, on tensors.

The same registry as ``cudabrot_tpu.models.fractals``: the Mandelbrot map
z <- z^2 + c (cudabrot.cu:331-333), the burning-ship fold (cudabrot.cu:
327-330) and the anti-Buddhabrot's interior emission. Every function is
one PyTorch elementwise op per arithmetic operation, so each product and
sum is rounded once (no fused multiply-add) — the rounding the CUDA
kernels reproduce with ``__fmul_rn``/``__fadd_rn`` (``csrc/orbit.cuh``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FractalMap:
    """A quadratic escape-time system rendered Buddhabrot-style."""

    name: str
    #: Fold absolute values onto z before each step (burning ship).
    fold_abs: bool
    #: Apply the closed-form cardioid/period-2-bulb rejection tests (true
    #: Mandelbrot map only, cudabrot.cu:397-399).
    use_cull: bool
    #: Whether Brent cycle detection is sound (attracting interior cycles).
    cycle_detect: bool
    #: "escape" replays in-band escaping orbits (the Buddhabrot);
    #: "interior" replays non-escaping ones (the anti-Buddhabrot).
    emit: str = "escape"

    @property
    def kernel_id(self) -> int:
        """Index of this map in the CUDA kernels' fractal template."""
        return _KERNEL_IDS[self.name]


def step(fractal: FractalMap, zr, zi, cr, ci):
    """One iteration z <- f(z) + c (cudabrot.cu:327-333)."""
    if fractal.fold_abs:
        zr = torch.abs(zr)
        zi = torch.abs(zi)
    new_zr = zr * zr - zi * zi + cr
    new_zi = 2.0 * zr * zi + ci
    return new_zr, new_zi


def in_main_cardioid(cr, ci):
    """Closed-form main-cardioid membership (cudabrot.cu:284-290)."""
    imag_sq = ci * ci
    q = cr - 0.25
    q = q * q + imag_sq
    return q * (q + (cr - 0.25)) < imag_sq * 0.25


def in_order2_bulb(cr, ci):
    """Closed-form period-2 bulb membership (cudabrot.cu:294-298)."""
    t = cr + 1.0
    return t * t + ci * ci < (1.0 / 16.0)


def cull_mask(fractal: FractalMap, cr, ci):
    """True where the sample is guaranteed non-escaping and can be skipped
    without iterating (cudabrot.cu:397-399)."""
    if not fractal.use_cull:
        return torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    return in_main_cardioid(cr, ci) | in_order2_bulb(cr, ci)


FRACTALS: dict[str, FractalMap] = {
    "buddhabrot": FractalMap(
        name="buddhabrot", fold_abs=False, use_cull=True, cycle_detect=True
    ),
    "burning-ship": FractalMap(
        name="burning-ship", fold_abs=True, use_cull=False, cycle_detect=False
    ),
    "anti-buddhabrot": FractalMap(
        name="anti-buddhabrot", fold_abs=False, use_cull=False,
        cycle_detect=True, emit="interior",
    ),
}

_KERNEL_IDS = {"buddhabrot": 0, "burning-ship": 1, "anti-buddhabrot": 2}


def get_fractal(name: str) -> FractalMap:
    try:
        return FRACTALS[name]
    except KeyError:
        raise ValueError(
            f"Unknown fractal {name!r}; available: {sorted(FRACTALS)}"
        ) from None
