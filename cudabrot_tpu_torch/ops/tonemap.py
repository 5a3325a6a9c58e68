"""Histogram -> 16-bit grayscale tone mapping.

Port of ``cudabrot_tpu/ops/tonemap.py``, bitwise: linear scale by the max
count (GetLinearColorScale, cudabrot.cu:425-439), optional gamma with
truncating casts (DoGammaCorrection/Clamp, cudabrot.cu:416-468). The
count is normalized as q = count / max, so the max pixel is exactly white.
An empty histogram maps to an all-zero image.

It runs on the host, where the final histogram already is for the image
write, with PyTorch's CPU kernels (whose ``pow`` rounds as XLA's CPU
``power`` does; a card's ``pow`` may differ in the last bit).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TonemapResult(NamedTuple):
    image: np.ndarray  # uint16, same shape as the histogram
    max_count: int
    linear_scale: float  # 65535 / max, computed in float32


def tonemap(hist: np.ndarray, gamma: float) -> TonemapResult:
    """Tone-map a uint32 (or uint64) host histogram."""
    h = np.asarray(hist)
    # Counts cast once to float32 (uint64 histograms ride float32 too, as
    # in the JAX dtype-dispatching entry).
    counts = torch.from_numpy(h.astype(np.float32))
    max_count = int(h.max(initial=0))
    maxval = torch.tensor(65535.0, dtype=torch.float32)
    denom = torch.tensor(float(max(max_count, 1)), dtype=torch.float32)
    if max_count > 0:
        q = counts / denom
        scale = float(maxval / denom)
    else:
        q = torch.zeros_like(counts)
        scale = 0.0
    if gamma <= 0.0:
        out = q * maxval  # truncating cast below, cudabrot.cu:447
    else:
        out = torch.clamp(maxval * torch.pow(q, 1.0 / gamma), 0.0, 65535.0)
    image = out.to(torch.int32).numpy().astype(np.uint16)
    return TonemapResult(image, max_count, scale)
