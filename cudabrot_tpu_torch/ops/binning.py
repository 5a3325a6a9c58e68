"""Orbit-point -> histogram-bin math and the deposit kernels.

Port of ``cudabrot_tpu/ops/binning.py`` (``points_to_bin_ids``,
``scatter_xla``, ``scatter_pallas``) and of the replay semantics of
``engines/pallas_engine.py`` (``_batched_replay``/``_blocked_replay``).

Histograms are flat int32 tensors holding the JAX package's uint32 counts
bit for bit (PyTorch's uint32 tensors lack ``index_add_``): two's-
complement adds wrap exactly as uint32 adds do, and the kernels add
through ``uint32_t*``. Every deposit is exact integer addition, so any
order of atomics gives the same histogram.

``deposit_ids`` and ``replay_deposit`` launch ``csrc/deposit.cu`` for CUDA
tensors and run their plain versions for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from cudabrot_tpu_torch.config import Canvas
from cudabrot_tpu_torch.models.fractals import FractalMap, step
from cudabrot_tpu_torch.ops import _build, launches
from cudabrot_tpu_torch.ops.prng import f32


def points_to_bin_ids(canvas: Canvas, re, im, valid):
    """Quantize f32 orbit points to flat int32 bin ids; off-canvas and
    invalid points get the sentinel ``canvas.num_pixels``.

    Mirrors IncrementPixelCounter (cudabrot.cu:302-314) as the JAX
    function does: points below the canvas minimum are rejected before the
    IEEE divide, col/row truncate toward zero. The bounds test runs on the
    float quotient (for x >= 0, trunc(x) < n iff x < n), so no out-of-range
    float is ever converted to int32.
    """
    dev = re.device
    min_re, min_im = f32(canvas.min_real, dev), f32(canvas.min_imag, dev)
    ok = valid & (re >= min_re) & (im >= min_im)
    colf = (re - min_re) / f32(canvas.delta_real, dev)
    rowf = (im - min_im) / f32(canvas.delta_imag, dev)
    ok = ok & (colf < canvas.width) & (rowf < canvas.height)
    col = torch.where(ok, colf, 0.0).to(torch.int32)
    row = torch.where(ok, rowf, 0.0).to(torch.int32)
    flat = row * canvas.width + col
    return torch.where(ok, flat, canvas.num_pixels).to(torch.int32)


def _check_hist(hist_flat: torch.Tensor) -> None:
    if (hist_flat.dtype != torch.int32 or hist_flat.dim() != 1
            or not hist_flat.is_contiguous()):
        raise ValueError("histogram must be a contiguous flat int32 tensor")


# ----------------------------------------------------------------------
# deposit_ids: the function of scatter_pallas / scatter_xla.


def deposit_ids(hist_flat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Add one at every id into ``hist_flat`` (in place; returned). Ids
    outside [0, nbins) — the sentinel ``nbins`` — are dropped."""
    _check_hist(hist_flat)
    if ids.dtype != torch.int32:
        raise ValueError("ids must be int32")
    if hist_flat.device.type == "cpu":
        return deposit_ids_plain(hist_flat, ids)
    if ids.device != hist_flat.device:
        raise ValueError("ids and histogram lie on different devices")
    ids = ids.reshape(-1).contiguous()
    lib = _lib()
    with torch.cuda.device(hist_flat.device):
        rc = lib.cb_deposit_ids(
            _build.ptr(ids), ids.numel(), _build.ptr(hist_flat),
            hist_flat.numel(), _build.stream_of(hist_flat),
        )
        launches.COUNTS["deposit_ids"] += 1
    _build.check(rc, "deposit_ids kernel")
    return hist_flat


def deposit_ids_plain(hist_flat: torch.Tensor, ids: torch.Tensor):
    launches.COUNTS["deposit_ids_plain"] += 1
    ids = ids.reshape(-1)
    keep = ids[(ids >= 0) & (ids < hist_flat.numel())].to(torch.int64)
    hist_flat.index_add_(
        0, keep, torch.ones(keep.shape, dtype=torch.int32,
                            device=hist_flat.device)
    )
    return hist_flat


# ----------------------------------------------------------------------
# replay_deposit: orbit replay fused with the deposit (the main path).


def replay_deposit(
    hist_flat: torch.Tensor,
    cr: torch.Tensor,
    ci: torch.Tensor,
    iters: torch.Tensor,
    *,
    canvas: Canvas,
    fractal: FractalMap,
) -> torch.Tensor:
    """Replay each emission's orbit and deposit its on-canvas points into
    ``hist_flat`` (in place). Emissions with ``iters < 0`` are inactive;
    an active one records z_1..z_{iters+1} with z_0 = c (steps s <= iters,
    the escape point included). Returns the on-canvas point count as a
    0-dim int64 tensor on the histogram's device."""
    _check_hist(hist_flat)
    if hist_flat.numel() != canvas.num_pixels:
        raise ValueError("histogram size does not match the canvas")
    if cr.dtype != torch.float32 or ci.dtype != torch.float32:
        raise ValueError("c values must be float32")
    if iters.dtype != torch.int32:
        raise ValueError("iters must be int32")
    if hist_flat.device.type == "cpu":
        return replay_deposit_plain(hist_flat, cr, ci, iters, canvas=canvas,
                                    fractal=fractal)
    dev = hist_flat.device
    cr, ci, iters = (t.reshape(-1).contiguous() for t in (cr, ci, iters))
    if not (cr.device == ci.device == iters.device == dev):
        raise ValueError("replay inputs lie on different devices")
    if not (cr.numel() == ci.numel() == iters.numel()):
        raise ValueError("replay inputs differ in length")
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.cb_replay_deposit(
            fractal.kernel_id, _build.ptr(cr), _build.ptr(ci),
            _build.ptr(iters), cr.numel(), _build.ptr(hist_flat),
            canvas.min_real, canvas.min_imag, canvas.delta_real,
            canvas.delta_imag, canvas.width, canvas.height,
            _build.ptr(hits), _build.stream_of(hist_flat),
        )
        launches.COUNTS["replay_deposit"] += 1
    _build.check(rc, "replay_deposit kernel")
    return hits


def replay_deposit_plain(hist_flat, cr, ci, iters, *, canvas: Canvas,
                         fractal: FractalMap) -> torch.Tensor:
    """The replay kernel's function step-major in plain PyTorch: every
    emission advances one step per iteration; the ones still inside their
    recording window deposit through ``index_add_``."""
    launches.COUNTS["replay_deposit_plain"] += 1
    cr, ci, iters = (t.reshape(-1) for t in (cr, ci, iters))
    dev = hist_flat.device
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    n_steps = int(iters.max().item()) + 1 if iters.numel() else 0
    zr, zi = cr, ci
    nbins = hist_flat.numel()
    for s in range(n_steps):
        zr, zi = step(fractal, zr, zi, cr, ci)
        ids = points_to_bin_ids(canvas, zr, zi, iters >= s)
        keep = ids[ids < nbins].to(torch.int64)
        hist_flat.index_add_(
            0, keep, torch.ones(keep.shape, dtype=torch.int32, device=dev)
        )
        hits += keep.numel()
    return hits


def _lib():
    lib = _build.load("deposit")
    if lib.cb_deposit_ids.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cb_deposit_ids.argtypes = [vp, ctypes.c_longlong, vp, i, vp]
        lib.cb_deposit_ids.restype = i
        lib.cb_replay_deposit.argtypes = [
            i, vp, vp, vp, i, vp, f, f, f, f, i, i, vp, vp,
        ]
        lib.cb_replay_deposit.restype = i
    return lib
