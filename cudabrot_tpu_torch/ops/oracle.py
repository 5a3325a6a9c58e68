"""Plain PyTorch reference sampler ("oracle").

Port of ``cudabrot_tpu/ops/oracle.py``: a vectorized re-statement of the
reference's per-thread algorithm (DrawBuddhabrot, cudabrot.cu:379-414).
Draw uniform samples from the sample domain, cull cardioid/bulb points,
classify by escape time (IterateMandelbrot, cudabrot.cu:319-340), and
replay in-band orbits into the histogram (IterateAndRecord,
cudabrot.cu:347-365). It has no hand-written kernel (the JAX oracle has
none): it is the ground truth the kernels' engines are tested against, in
float32 or float64, and a usable if slower engine on any device.

Semantics kept exactly:
  * z starts at c, not 0 (cudabrot.cu:323-324): the orbit's first recorded
    point is c^2 + c;
  * a sample escaping at loop index i (0-based, checked after the update,
    cudabrot.cu:336) reports iterations_needed == i and replays i+1 update
    steps, recording every one including the escaped point;
  * the band filter keeps min_escape <= i < max_escape (cudabrot.cu:407-408);
  * samples are drawn from the sample domain regardless of the canvas.

The sample stream is ``jax.random``'s for the same key (``prng.split`` and
``prng.uniform``), and every product and sum rounds once, so at float64 a
pass equals a scalar Python re-statement of the algorithm exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cudabrot_tpu_torch.config import SAMPLE_DOMAIN, RenderConfig
from cudabrot_tpu_torch.models import fractals
from cudabrot_tpu_torch.ops import binning, prng


class PassStats(NamedTuple):
    """Per-pass counters, each a 0-dim int64 tensor on the render device."""

    samples: torch.Tensor
    culled: torch.Tensor
    in_band: torch.Tensor
    classify_iters: torch.Tensor  # per-sample useful escape-time work
    orbit_points: torch.Tensor  # points scattered (incl. off-canvas)
    wasted_steps: torch.Tensor  # executed-but-useless lockstep work
    replay_dropped: torch.Tensor  # in-band samples beyond replay capacity


def precision_dtype(precision: str) -> torch.dtype:
    """The oracle's iteration dtype: "extended" (the CUDA engine's df32
    deep-zoom mode, ~2^-48) runs as float64, its strict superset."""
    return torch.float32 if precision == "float32" else torch.float64


def draw_samples(key, n: int, dtype, domain=SAMPLE_DOMAIN, device="cpu"):
    """Uniform c over the sample domain (cudabrot.cu:392-393)."""
    kr, ki = prng.split(key)
    lo_r, hi_r, lo_i, hi_i = domain
    cr = prng.uniform(kr, n, dtype, lo_r, hi_r, device)
    ci = prng.uniform(ki, n, dtype, lo_i, hi_i, device)
    return cr, ci


def classify(fractal: fractals.FractalMap, cr, ci, max_iterations: int,
             visit_window: tuple | None = None):
    """Escape-time classification (IterateMandelbrot, cudabrot.cu:319-340).

    Returns (iters, escaped, trip, visited): iters is the 0-based escape
    index for escaped lanes and max_iterations for the others; trip is the
    number of lockstep loop iterations executed (every lane occupies a
    vector slot for all of them); ``visited`` says whether the trajectory
    entered ``visit_window`` (None without a window).
    """
    zr, zi = cr, ci
    iters = torch.full(cr.shape, max_iterations, dtype=torch.int32,
                       device=cr.device)
    esc = torch.zeros(cr.shape, dtype=torch.bool, device=cr.device)
    vis = torch.zeros_like(esc)
    trip = 0
    while trip < max_iterations and not bool(esc.all()):
        nzr, nzi = fractals.step(fractal, zr, zi, cr, ci)
        # Escaped lanes freeze, so their state cannot overflow.
        zr = torch.where(esc, zr, nzr)
        zi = torch.where(esc, zi, nzi)
        esc_now = ~esc & fractals.escaped(zr, zi)
        iters = torch.where(esc_now, trip, iters).to(torch.int32)
        if visit_window is not None:
            vx0, vx1, vy0, vy1 = visit_window
            vis = vis | ((zr >= vx0) & (zr < vx1) & (zi >= vy0) & (zi < vy1))
        esc = esc | esc_now
        trip += 1
    return iters, esc, trip, (vis if visit_window is not None else None)


def replay_into(hist_flat, fractal: fractals.FractalMap, canvas, cr, ci,
                iters, record):
    """Replay recorded-band orbits and add their points to ``hist_flat``
    in place (IterateAndRecord, cudabrot.cu:347-365, as the bounded loop
    s <= iters the caller's escape-time guarantee implies)."""
    n_steps = 0
    if bool(record.any()):
        n_steps = int(iters[record].max().item()) + 1
    ones = torch.ones(cr.shape, dtype=torch.int32, device=hist_flat.device)
    zr, zi = cr, ci
    nbins = hist_flat.numel()
    for s in range(n_steps):
        zr, zi = fractals.step(fractal, zr, zi, cr, ci)
        ids = binning.points_to_bin_ids(canvas, zr, zi, record & (iters >= s))
        keep = ids[ids < nbins].to(torch.int64)
        hist_flat.index_add_(0, keep, ones[:keep.numel()])
    return hist_flat


def _replay_capacity(cfg: RenderConfig, n: int) -> int:
    """Replay-batch size. Auto sizes from the ~C/t escape-time tail model
    (C = 0.22, ``cuda_engine.band_emission_rate``) with 16x headroom, so
    overflow drops are vanishingly rare; emission-heavy bands (interior
    mode, shallow bands) resolve to n (nothing to skip)."""
    opt = cfg.options.oracle_replay_capacity
    if opt > 0:
        return min(opt, n)
    if fractals.get_fractal(cfg.fractal).emit == "interior":
        return n
    mi = max(cfg.band.min_escape_iterations, 2)
    ma = max(cfg.band.max_escape_iterations, 4)
    frac = max(0.22 * (1.0 / mi - 1.0 / ma), 1e-7)
    if cfg.sample_domain != SAMPLE_DOMAIN:
        # A restricted domain concentrates the in-band rate by up to the
        # area ratio; boost by at most 16x, as the CUDA engine's Tuning.
        r0, r1, i0, i1 = cfg.sample_domain
        area = (r1 - r0) * (i1 - i0)
        frac = min(frac * min(16.0 / max(area, 1e-30), 16.0), 1.0)
    expected = n * frac
    cap = 1 << max(10, math.ceil(math.log2(max(expected * 16, 1.0))))
    return min(cap, n)


def render_pass(hist, key, cfg: RenderConfig):
    """One oracle pass (the equivalent of one DrawBuddhabrot launch,
    cudabrot.cu:485-486): adds the pass's orbit points to ``hist`` in place
    and returns it with the pass's stats. The samples live on ``hist``'s
    device."""
    fractal = fractals.get_fractal(cfg.fractal)
    n = cfg.options.oracle_samples_per_pass
    dtype = precision_dtype(cfg.options.precision)
    dev = hist.device
    canvas = cfg.canvas
    max_it = cfg.band.max_escape_iterations
    min_it = cfg.band.min_escape_iterations

    cr, ci = draw_samples(key, n, dtype, cfg.sample_domain, dev)
    culled = fractals.cull_mask(fractal, cr, ci)
    visit_window = None
    if cfg.options.emit_filter == "canvas":
        # Only orbits whose trajectory entered the (one-pixel-inflated)
        # canvas window are replayed: the same rendered measure.
        visit_window = (
            canvas.min_real, canvas.max_real + canvas.delta_real,
            canvas.min_imag, canvas.max_imag + canvas.delta_imag,
        )
    iters, escaped, trip, visited = classify(fractal, cr, ci, max_it,
                                             visit_window)
    if fractal.emit == "interior":
        # Anti-Buddhabrot: samples that do not escape within the cap; their
        # iters stay at max_it, so the replay records max_it points each.
        in_band = ~escaped & ~culled
    else:
        in_band = escaped & ~culled & (iters >= min_it)
    if visited is not None:
        in_band = in_band & visited

    # Compact in-band samples before replay (the reference's two-pass
    # structure); a stable sort keeps the replay order deterministic, and
    # overflow beyond capacity is dropped and counted.
    capacity = _replay_capacity(cfg, n)
    n_band = in_band.sum()
    if capacity >= n:
        sel_cr, sel_ci, sel_it, sel_rec = cr, ci, iters, in_band
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        order = torch.sort((~in_band).to(torch.int8),
                           stable=True).indices[:capacity]
        sel_cr, sel_ci = cr[order], ci[order]
        sel_it, sel_rec = iters[order], in_band[order]
        dropped = n_band - torch.clamp(n_band, max=capacity)
    # Interior samples replay max_it steps (s <= iters holds throughout).
    replay_it = torch.clamp(sel_it, max=max_it - 1)
    replay_into(hist.view(-1), fractal, canvas, sel_cr, sel_ci, replay_it,
                sel_rec)
    # Useful classify work per lane: the escape-time steps the algorithm
    # needed (culled lanes none); everything else the lockstep loop ran is
    # wasted_steps, so their sum is the executed lane-steps.
    useful = torch.where(
        culled, 0, torch.where(escaped, iters + 1, max_it)
    ).to(torch.int64)
    stats = PassStats(
        samples=torch.tensor(n, dtype=torch.int64, device=dev),
        culled=culled.sum(),
        in_band=n_band,
        classify_iters=useful.sum(),
        wasted_steps=(trip - useful).sum(),
        orbit_points=torch.where(sel_rec, replay_it + 1, 0).sum(),
        replay_dropped=dropped,
    )
    return hist, stats


def make_pass_fn(cfg: RenderConfig):
    """The pass function ``(hist, pass_index) -> (hist, stats)`` keyed by
    ``fold_in(key(cfg.seed), pass_index)``, the histogram updated in place
    on its device across passes."""
    base_key = prng.key(cfg.seed)

    def pass_fn(hist, pass_index):
        return render_pass(hist, prng.fold_in(base_key, pass_index), cfg)

    return pass_fn
