"""Orbit-point -> histogram-bin math and the deposit kernels.

Port of ``cudabrot_tpu/ops/binning.py`` (``points_to_bin_ids``,
``points_to_bin_ids_df`` and their row-sharded forms, ``scatter_xla``,
``scatter_pallas``, ``scatter_bigtiles``, ``select_scatter_backend``, ``mh_deposit_weights``, ``mh_scatter``) and of
the replay semantics of ``engines/pallas_engine.py`` (``_batched_replay``/
``_blocked_replay``, and ``_blocked_replay_ext`` for df32 orbits).

Histograms are flat int32 tensors holding the JAX package's uint32 counts
bit for bit (PyTorch's uint32 tensors lack ``index_add_``): two's-
complement adds wrap exactly as uint32 adds do, and the kernels add
through ``uint32_t*``. Every deposit is exact integer addition, so any
order of atomics gives the same histogram.

``deposit_ids`` and ``replay_deposit`` launch ``csrc/deposit.cu`` and
``replay_deposit_ext`` launches ``csrc/deposit_ext.cu`` for CUDA tensors;
``mh_deposit`` launches the ``mh_deposit`` kernel of ``csrc/deposit.cu``;
each runs its plain version for CPU tensors.

The kept orbits reach the histogram by one of three routes
(``select_scatter_backend``): the fused replay-deposit (``--scatter
auto``/``xla``), one global atomic per orbit point, or an id-stream route
(``replay_id_stream``/``replay_id_stream_ext``), which writes every
point's bin id into a flat int32 stream (the ``replay_ids``/
``replay_ids_ext`` kernels) and counts it: ``--scatter bigtiles`` (for
histograms beyond the L2) sorts it with ``torch.sort`` (the JAX package's
``jax.lax.sort``, outside its kernel too) and counts it with the
``bigtiles_deposit`` kernel (``csrc/bigtiles.cu``), one atomic per run of
equal ids (``--scatter sorted``, the JAX ``scatter_sorted``'s sort and
run-length add, takes this route too); ``--scatter pallas`` counts it as
written with the ``deposit_ids`` kernel, as the JAX package's Mosaic
scatter does. All give the same histogram bit for bit. An id-stream
route reads the pass's orbit-length sums back to size its id buffers: one
host synchronization per pass, where the fused route has none.

The four replay kernels take a row window ``rows=(row_start, row_count)``:
the histogram then holds those rows of the canvas only (a shard of the
row-sharded engine, ``parallel/sharded_hist.py``), a point's id is local
to them and the ids' sentinel is ``row_count * width``. ``rows=None`` is
the whole canvas, the window ``(0, height)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cudabrot_tpu_torch.config import Canvas
from cudabrot_tpu_torch.models.fractals import FractalMap, step
from cudabrot_tpu_torch.ops import _build, df32, launches
from cudabrot_tpu_torch.ops.classify_ext import grid_params, grid_sample
from cudabrot_tpu_torch.ops.prng import f32


def points_to_bin_ids(canvas: Canvas, re, im, valid):
    """Quantize orbit points to flat int32 bin ids; off-canvas and
    invalid points get the sentinel ``canvas.num_pixels``.

    Mirrors IncrementPixelCounter (cudabrot.cu:302-314) as the JAX
    function does: points below the canvas minimum are rejected before the
    IEEE divide, col/row truncate toward zero. The bounds test runs on the
    float quotient (for x >= 0, trunc(x) < n iff x < n), so no out-of-range
    float is ever converted to int32.
    """
    def const(v):
        # Rounded to the points' dtype (f32, or the oracle's f64) as a
        # 0-dim tensor: tensor-tensor arithmetic is never rewritten.
        return torch.tensor(v, dtype=re.dtype, device=re.device)

    min_re, min_im = const(canvas.min_real), const(canvas.min_imag)
    ok = valid & (re >= min_re) & (im >= min_im)
    colf = (re - min_re) / const(canvas.delta_real)
    rowf = (im - min_im) / const(canvas.delta_imag)
    ok = ok & (colf < canvas.width) & (rowf < canvas.height)
    col = torch.where(ok, colf, 0.0).to(torch.int32)
    row = torch.where(ok, rowf, 0.0).to(torch.int32)
    flat = row * canvas.width + col
    return torch.where(ok, flat, canvas.num_pixels).to(torch.int32)


def points_to_bin_ids_sharded(canvas: Canvas, re, im, valid, row_start: int,
                              row_count: int):
    """``points_to_bin_ids`` for a row-sharded histogram holding canvas
    rows [row_start, row_start + row_count): the canvas's range test
    first, then the window's; the local id is (row - row_start) * width +
    col and everything else maps to the local sentinel row_count * width
    (the JAX function of the same name)."""
    ids = points_to_bin_ids(canvas, re, im, valid)
    return _window(ids, canvas, row_start, row_count)


def _window(ids, canvas: Canvas, row_start: int, row_count: int):
    """Whole-canvas ids (sentinel ``canvas.num_pixels``) as ids local to the
    rows [row_start, row_start + row_count), sentinel row_count * width."""
    w = canvas.width
    local = ids - row_start * w
    ok = (ids < canvas.num_pixels) & (local >= 0) & (local < row_count * w)
    return torch.where(ok, local, row_count * w).to(torch.int32)


def points_to_bin_ids_df(canvas: Canvas, reh, rel, imh, iml, valid, mr, mi):
    """``points_to_bin_ids`` for df32 orbit points: the offset from the
    canvas minimum is taken in df32 (its hi part accurate to ~2^-48
    absolute) and quantized in f32 — the offset is at most the canvas
    span, so f32's 2^-24 relative resolution stays sub-pixel.

    ``mr``/``mi`` are (hi, lo) pairs of 0-dim f32 tensors holding
    ``canvas.min_real``/``min_imag``. The hi offset is multiplied by the
    inverse pitch rounded to f32 (``float32(1 / delta)``, computed in
    f64), as the JAX function does, not divided by the pitch.
    """
    dev = reh.device
    dxh, _ = df32.add(reh, rel, -mr[0], -mr[1])
    dyh, _ = df32.add(imh, iml, -mi[0], -mi[1])
    ok = valid & (dxh >= 0.0) & (dyh >= 0.0)
    colf = dxh * f32(1.0 / canvas.delta_real, dev)
    rowf = dyh * f32(1.0 / canvas.delta_imag, dev)
    ok = ok & (colf < canvas.width) & (rowf < canvas.height)
    col = torch.where(ok, colf, 0.0).to(torch.int32)
    row = torch.where(ok, rowf, 0.0).to(torch.int32)
    flat = row * canvas.width + col
    return torch.where(ok, flat, canvas.num_pixels).to(torch.int32)


def points_to_bin_ids_df_sharded(canvas: Canvas, reh, rel, imh, iml, valid,
                                 mr, mi, row_start: int, row_count: int):
    """``points_to_bin_ids_df`` for a row-sharded histogram: the df32
    quantization with ``points_to_bin_ids_sharded``'s window (the JAX
    function of the same name)."""
    ids = points_to_bin_ids_df(canvas, reh, rel, imh, iml, valid, mr, mi)
    return _window(ids, canvas, row_start, row_count)


def _check_rows(canvas: Canvas, rows) -> tuple[int, int]:
    """The row window ``rows`` ((0, height) for None), checked."""
    if rows is None:
        return 0, canvas.height
    row_start, row_count = (int(v) for v in rows)
    if row_count < 0 or row_start < 0:
        raise ValueError(f"invalid row window {rows}")
    return row_start, row_count


def _check_window_hist(hist_flat, canvas: Canvas, rows) -> tuple[int, int]:
    """The window of a replay into ``hist_flat``, which must hold its
    rows."""
    _check_hist(hist_flat)
    row_start, row_count = _check_rows(canvas, rows)
    if hist_flat.numel() != row_count * canvas.width:
        raise ValueError("histogram size does not match the canvas rows")
    return row_start, row_count


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
    if ids.numel() == 0:
        return hist_flat
    lib = _lib()
    with torch.cuda.device(hist_flat.device):
        rc = lib.cb_deposit_ids(
            _build.ptr(ids), ids.numel(), _build.ptr(hist_flat),
            hist_flat.numel(), _build.stream_of(hist_flat),
        )
    _build.check(rc, "deposit_ids kernel")
    launches.COUNTS["deposit_ids"] += 1
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


#: Resident warps per SM of the queue of the two f32 replay kernels,
#: replay_deposit and replay_ids (csrc/deposit.cu): on an H100 the fastest
#: at the default batch and level with 4..64 at the deep and northstar ones
#: (chip_smoke.py --replay-study, phase 7c, sweeps it). No result depends
#: on it.
REPLAY_WARPS_PER_SM = 16
#: Takes from the queue each resident warp should get at least: a warp
#: takes max(1, groups / (warps * REPLAY_TAKES_PER_WARP)) groups of 32 at
#: once, so a batch of millions of short orbits does not serialize on the
#: queue's counter, and one of a few thousand long ones takes them one by
#: one, longest first.
REPLAY_TAKES_PER_WARP = 8


def replay_launch(k: int, device) -> tuple[int, int]:
    """The launch of an f32 replay kernel (``replay_deposit``,
    ``replay_ids``) for a batch of ``k`` emissions on ``device``: its
    resident warps in all, and the groups of 32 each warp takes from the
    queue at once."""
    warps = torch.cuda.get_device_properties(
        device).multi_processor_count * REPLAY_WARPS_PER_SM
    return warps, max(1, (k + 31) // 32 // (warps * REPLAY_TAKES_PER_WARP))


def replay_deposit(
    hist_flat: torch.Tensor,
    cr: torch.Tensor,
    ci: torch.Tensor,
    iters: torch.Tensor,
    *,
    canvas: Canvas,
    fractal: FractalMap,
    hits: torch.Tensor | None = None,
    rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Replay each emission's orbit and deposit its on-canvas points into
    ``hist_flat`` (in place), which holds the canvas rows of the window
    ``rows`` (the whole canvas for None). Emissions with ``iters < 0`` are
    inactive; an active one records z_1..z_{iters+1} with z_0 = c (steps s <= iters,
    the escape point included). Adds the on-canvas point count to
    ``hits``, a 0-dim int64 tensor on the histogram's device (the kernel
    adds with atomics; a new zero one when None), and returns it. The
    kernel's warps take the batch's groups of 32 emissions in order from a
    queue (``replay_launch``), so a batch ordered by descending orbit
    length starts its longest orbits first."""
    row_start, row_count = _check_window_hist(hist_flat, canvas, rows)
    if cr.dtype != torch.float32 or ci.dtype != torch.float32:
        raise ValueError("c values must be float32")
    if iters.dtype != torch.int32:
        raise ValueError("iters must be int32")
    hits = _hits(hits, hist_flat.device)
    if hist_flat.device.type == "cpu":
        return replay_deposit_plain(hist_flat, cr, ci, iters, canvas=canvas,
                                    fractal=fractal, hits=hits, rows=rows)
    dev = hist_flat.device
    cr, ci, iters = (t.reshape(-1).contiguous() for t in (cr, ci, iters))
    if not (cr.device == ci.device == iters.device == dev):
        raise ValueError("replay inputs lie on different devices")
    if not (cr.numel() == ci.numel() == iters.numel()):
        raise ValueError("replay inputs differ in length")
    if cr.numel() == 0:
        return hits
    warps, take = replay_launch(cr.numel(), dev)
    queue = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.cb_replay_deposit(
            fractal.kernel_id, _build.ptr(cr), _build.ptr(ci),
            _build.ptr(iters), cr.numel(), _build.ptr(hist_flat),
            canvas.min_real, canvas.min_imag, canvas.delta_real,
            canvas.delta_imag, canvas.width, canvas.height, row_start,
            row_count, warps, take, _build.ptr(queue), _build.ptr(hits),
            _build.stream_of(hist_flat),
        )
    _build.check(rc, "replay_deposit kernel")
    launches.COUNTS["replay_deposit"] += 1
    return hits


def orbit_bins(cr, ci, iters, *, canvas: Canvas, fractal: FractalMap,
               rows=None):
    """The replay kernels' orbit loop step-major in plain PyTorch: yields
    ``(s, ids)`` for every step s, ``ids`` the bin ids of step s's points,
    with the sentinel ``canvas.num_pixels`` where a point is off the canvas
    or an emission is past its ``iters``. Every emission advances one step
    per iteration (finished ones coast, unrecorded). With a row window
    ``rows`` the ids are ``points_to_bin_ids_sharded``'s."""
    cr, ci, iters = (t.reshape(-1) for t in (cr, ci, iters))
    n_steps = int(iters.max().item()) + 1 if iters.numel() else 0
    zr, zi = cr, ci
    for s in range(n_steps):
        zr, zi = step(fractal, zr, zi, cr, ci)
        if rows is None:
            yield s, points_to_bin_ids(canvas, zr, zi, iters >= s)
        else:
            yield s, points_to_bin_ids_sharded(canvas, zr, zi, iters >= s,
                                               *rows)


def _hits(hits, dev) -> torch.Tensor:
    """The on-canvas count a replay adds to: ``hits`` checked, or a new
    zero."""
    if hits is None:
        return torch.zeros((), dtype=torch.int64, device=dev)
    if (hits.dtype != torch.int64 or hits.numel() != 1
            or hits.device != dev):
        raise ValueError("hits must be one int64 on the histogram's device")
    return hits


def _deposit_steps(hist_flat, steps, hits=None) -> torch.Tensor:
    """Deposits the on-canvas ids of every step through ``index_add_``;
    adds their count to ``hits`` (a new 0-dim int64 zero when None) and
    returns it."""
    dev, nbins = hist_flat.device, hist_flat.numel()
    hits = _hits(hits, dev)
    for _, ids in steps:
        keep = ids[ids < nbins].to(torch.int64)
        hist_flat.index_add_(
            0, keep, torch.ones(keep.shape, dtype=torch.int32, device=dev)
        )
        hits += keep.numel()
    return hits


def _write_steps(iters, off, n_ids: int, nbins: int, steps):
    """Writes step s of emission e at ``off[e] + s`` of a new int32 stream
    of ``n_ids`` slots; returns it and the on-canvas count (0-dim int64)."""
    iters, off = iters.reshape(-1), off.reshape(-1)
    ids = torch.empty(n_ids, dtype=torch.int32, device=iters.device)
    hits = torch.zeros((), dtype=torch.int64, device=iters.device)
    for s, b in steps:
        act = iters >= s
        ids[off[act] + s] = b[act]
        hits += (b < nbins).sum()
    return ids, hits


def replay_deposit_plain(hist_flat, cr, ci, iters, *, canvas: Canvas,
                         fractal: FractalMap, hits=None,
                         rows=None) -> torch.Tensor:
    """The replay kernel's function step-major in plain PyTorch: the
    points still inside their recording window deposit through
    ``index_add_``."""
    launches.COUNTS["replay_deposit_plain"] += 1
    return _deposit_steps(hist_flat, orbit_bins(
        cr, ci, iters, canvas=canvas, fractal=fractal, rows=rows), hits)


# ----------------------------------------------------------------------
# replay_deposit_ext: the df32 replay fused with the deposit (deep zoom).


def _canvas_df(canvas: Canvas):
    """((min_re hi, lo), (min_im hi, lo), inv pitch re, inv pitch im) as
    Python floats that are exact in float32."""
    return (df32.from_float(canvas.min_real), df32.from_float(canvas.min_imag),
            float(np.float32(1.0 / canvas.delta_real)),
            float(np.float32(1.0 / canvas.delta_imag)))


def replay_deposit_ext(
    hist_flat: torch.Tensor,
    kr: torch.Tensor,
    ki: torch.Tensor,
    iters: torch.Tensor,
    *,
    canvas: Canvas,
    fractal: FractalMap,
    sample_domain: tuple,
    hits: torch.Tensor | None = None,
    rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """``replay_deposit`` for extended-precision emissions: ``kr``/``ki``
    are the 24-bit grid indices (as f32) the df32 classify pass emitted
    over ``sample_domain``. c is rebuilt as the pass drew it
    (``classify_ext.grid_sample``), the orbit runs in df32 and every point
    bins through ``points_to_bin_ids_df`` (``_sharded`` in a row window
    ``rows``). Adds the deposited point count to ``hits`` (as
    ``replay_deposit``) and returns it. The kernel's warps
    take the batch's groups of 32 emissions in order from a queue
    (``REPLAY_EXT_WARPS_PER_SM``), so a batch ordered by descending orbit
    length starts its longest orbits first."""
    _check_window_hist(hist_flat, canvas, rows)
    if kr.dtype != torch.float32 or ki.dtype != torch.float32:
        raise ValueError("grid indices must be float32")
    if iters.dtype != torch.int32:
        raise ValueError("iters must be int32")
    hits = _hits(hits, hist_flat.device)
    if hist_flat.device.type == "cpu":
        return replay_deposit_ext_plain(
            hist_flat, kr, ki, iters, canvas=canvas, fractal=fractal,
            sample_domain=sample_domain, hits=hits, rows=rows)
    dev = hist_flat.device
    kr, ki, iters = (t.reshape(-1).contiguous() for t in (kr, ki, iters))
    if not (kr.device == ki.device == iters.device == dev):
        raise ValueError("replay inputs lie on different devices")
    if not (kr.numel() == ki.numel() == iters.numel()):
        raise ValueError("replay inputs differ in length")
    if kr.numel() == 0:
        return hits
    iargs, fargs = _replay_ext_args(dev, kr.numel(), canvas, fractal,
                                    sample_domain, rows)
    queue = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _lib_ext()
    with torch.cuda.device(dev):
        rc = lib.cb_replay_deposit_ext(
            _build.ptr(kr), _build.ptr(ki), _build.ptr(iters),
            _build.ptr(hist_flat), iargs, fargs, _build.ptr(queue),
            _build.ptr(hits), _build.stream_of(hist_flat),
        )
    _build.check(rc, "replay_deposit_ext kernel")
    launches.COUNTS["replay_deposit_ext"] += 1
    return hits


def replay_deposit_ext_plain(hist_flat, kr, ki, iters, *, canvas: Canvas,
                             fractal: FractalMap, sample_domain: tuple,
                             hits=None, rows=None) -> torch.Tensor:
    """The df32 replay kernel's function step-major in plain PyTorch, as
    ``replay_deposit_plain``."""
    launches.COUNTS["replay_deposit_ext_plain"] += 1
    return _deposit_steps(hist_flat, orbit_bins_ext(
        kr, ki, iters, canvas=canvas, fractal=fractal,
        sample_domain=sample_domain, rows=rows), hits)


#: Resident warps per SM of the df32 replay kernels' queue
#: (csrc/deposit_ext.cu): four, one per warp scheduler, so each of the
#: batch's longest orbit groups has a scheduler to itself.
REPLAY_EXT_WARPS_PER_SM = 4


def _replay_ext_args(dev, k: int, canvas: Canvas, fractal: FractalMap,
                     sample_domain: tuple, rows=None):
    """The C arguments (iargs, fargs) of the df32 replay kernels on CUDA
    device ``dev``, binning into the row window ``rows``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c0r, c0i, step_r, step_i = grid_params(sample_domain)
    mr, mi, inv_dr, inv_di = _canvas_df(canvas)
    iargs = (ctypes.c_int * 7)(fractal.kernel_id, k, canvas.width,
                               canvas.height, sms * REPLAY_EXT_WARPS_PER_SM,
                               *_check_rows(canvas, rows))
    fargs = (ctypes.c_float * 12)(*c0r, *c0i, step_r, step_i, *mr, *mi,
                                  inv_dr, inv_di)
    return iargs, fargs


def orbit_bins_ext(kr, ki, iters, *, canvas: Canvas, fractal: FractalMap,
                   sample_domain: tuple, rows=None):
    """``orbit_bins`` for df32 emissions: c rebuilt from the grid indices
    as the classify pass drew it, one df32 step per iteration, points
    binned through ``points_to_bin_ids_df`` (``_sharded`` in a row window
    ``rows``)."""
    kr, ki, iters = (t.reshape(-1) for t in (kr, ki, iters))
    dev = kr.device
    c0r, c0i, step_r, step_i = grid_params(sample_domain)
    mr, mi, _, _ = _canvas_df(canvas)
    mr, mi = (tuple(f32(v, dev) for v in m) for m in (mr, mi))
    crh, crl, _ = grid_sample(tuple(f32(v, dev) for v in c0r), kr,
                              f32(step_r, dev))
    cih, cil, _ = grid_sample(tuple(f32(v, dev) for v in c0i), ki,
                              f32(step_i, dev))
    n_steps = int(iters.max().item()) + 1 if iters.numel() else 0
    zr, zrl, zi, zil = crh, crl, cih, cil
    for s in range(n_steps):
        zr, zrl, zi, zil, _ = df32.complex_sqr_add(
            zr, zrl, zi, zil, crh, crl, cih, cil, fold_abs=fractal.fold_abs)
        if rows is None:
            yield s, points_to_bin_ids_df(canvas, zr, zrl, zi, zil,
                                          iters >= s, mr, mi)
        else:
            yield s, points_to_bin_ids_df_sharded(
                canvas, zr, zrl, zi, zil, iters >= s, mr, mi, *rows)


# ----------------------------------------------------------------------
# The bigtiles route (--scatter bigtiles): replay to an id stream, sort it,
# count it.

#: Sorted ids one block of the bigtiles_deposit kernel counts (at most
#: 8192, csrc/bigtiles.cuh kMaxChunk), as the JAX kernel's chunk.
BIGTILES_CHUNK = 8192
#: Largest id stream one replay group materializes: 2^27 int32 ids
#: (512 MB), the JAX engine's BATCHED_REPLAY_SLOT_BUDGET.
BIGTILES_ID_BUDGET = 1 << 27
#: Most points one orbit can record: the configuration keeps
#: max_escape_iterations below 2^24.
MAX_ORBIT_LEN = 1 << 24


def select_scatter_backend(name: str) -> str:
    """The deposit route of ``--scatter``: "auto" and "xla" resolve to
    the fused replay-deposit ("fused": the JAX package resolves auto to its
    XLA scatter off the TPU and never picks bigtiles on its own); the
    others to an id-stream route (``ID_ROUTES``). The names differ from the
    JAX ones where the function does: JAX "pallas" names its Mosaic
    kernel, which counts a materialized id stream, and here that stream is
    counted by ``deposit_ids`` ("ids"); JAX "sorted" sorts the stream and
    adds each run of equal ids once, which is the bigtiles route."""
    route = {"auto": "fused", "xla": "fused", "pallas": "ids",
             "sorted": "bigtiles", "bigtiles": "bigtiles"}.get(name)
    if route is None:
        raise ValueError(f"Unknown scatter backend for the CUDA port: {name}")
    return route


def _check_nbins(nbins: int) -> None:
    if nbins >= 1 << 31:
        raise ValueError(f"{nbins} bins do not fit the kernels' int32 ids")


def bigtiles_deposit(hist_flat: torch.Tensor, ids: torch.Tensor, *,
                     chunk: int = 0) -> torch.Tensor:
    """Add one at every id of a sorted int32 stream into ``hist_flat`` (in
    place; returned), one add per run of equal ids; ids outside
    [0, nbins) are dropped. Any order gives the same histogram (integer
    adds commute); sorted order makes the runs long and the kernel's
    blocks walk the histogram in address order. ``chunk``: ids per block
    of the kernel, 1..8192 (0: ``BIGTILES_CHUNK``)."""
    _check_hist(hist_flat)
    _check_nbins(hist_flat.numel())
    if ids.dtype != torch.int32:
        raise ValueError("ids must be int32")
    chunk = chunk or BIGTILES_CHUNK
    if not 0 < chunk <= BIGTILES_CHUNK:
        raise ValueError(f"chunk must lie in [1, {BIGTILES_CHUNK}]")
    if hist_flat.device.type == "cpu":
        return bigtiles_deposit_plain(hist_flat, ids)
    if ids.device != hist_flat.device:
        raise ValueError("ids and histogram lie on different devices")
    ids = ids.reshape(-1).contiguous()
    if ids.numel() == 0:
        return hist_flat
    lib = _lib_bigtiles()
    with torch.cuda.device(hist_flat.device):
        rc = lib.cb_bigtiles_deposit(
            _build.ptr(ids), ids.numel(), chunk, _build.ptr(hist_flat),
            hist_flat.numel(), _build.stream_of(hist_flat),
        )
    _build.check(rc, "bigtiles_deposit kernel")
    launches.COUNTS["bigtiles_deposit"] += 1
    return hist_flat


def bigtiles_deposit_plain(hist_flat: torch.Tensor, ids: torch.Tensor):
    """The bigtiles kernel's function in plain PyTorch: the runs of equal
    ids (``torch.unique_consecutive``) added by ``index_add_``."""
    launches.COUNTS["bigtiles_deposit_plain"] += 1
    vals, counts = torch.unique_consecutive(ids.reshape(-1),
                                            return_counts=True)
    keep = (vals >= 0) & (vals < hist_flat.numel())
    hist_flat.index_add_(0, vals[keep].to(torch.int64),
                         counts[keep].to(torch.int32))
    return hist_flat


def scatter_bigtiles(hist_flat: torch.Tensor, ids: torch.Tensor, *,
                     chunk: int = 0) -> torch.Tensor:
    """Add one at every id in [0, nbins) (in place; returned): the stream
    sorted by ``torch.sort`` and counted by ``bigtiles_deposit``. Bitwise
    equal to ``deposit_ids`` (the JAX ``scatter_xla``)."""
    ids = torch.sort(ids.reshape(-1)).values
    return bigtiles_deposit(hist_flat, ids, chunk=chunk)


def id_offsets(iters):
    """``(off, ends)``, int64: each emission's first and one-past-last
    slot in the id stream of ``replay_ids``, the exclusive and inclusive
    prefix sums of max(iters + 1, 0)."""
    lens = torch.clamp(iters.reshape(-1).to(torch.int64) + 1, min=0)
    ends = torch.cumsum(lens, 0)
    return ends - lens, ends


def _check_replay_ids(xr, xi, iters, off, what: str):
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise ValueError(f"{what} must be float32")
    if iters.dtype != torch.int32 or off.dtype != torch.int64:
        raise ValueError("iters must be int32 and off int64")
    xr, xi, iters, off = (t.reshape(-1).contiguous()
                          for t in (xr, xi, iters, off))
    if not (xr.numel() == xi.numel() == iters.numel() == off.numel()):
        raise ValueError("replay inputs differ in length")
    if not (xr.device == xi.device == iters.device == off.device):
        raise ValueError("replay inputs lie on different devices")
    return xr, xi, iters, off


def replay_ids(cr, ci, iters, off, n_ids: int, *, canvas: Canvas,
               fractal: FractalMap, rows=None):
    """Replay each emission's orbit into an id stream: emission e writes
    the bin id of each of its ``iters[e] + 1`` steps (the sentinel
    ``canvas.num_pixels`` where a point is off the canvas; with a row
    window ``rows``, the window's local ids and sentinel) at
    ``off[e] + s`` of a new int32 tensor of ``n_ids`` slots. ``off`` is
    int64, the exclusive prefix sum of max(iters + 1, 0), so every slot is
    written once (``id_offsets``); ``n_ids`` must cover the last
    emission's slots, which the kernel does not check. Returns ``(ids,
    hits)``: the stream and the on-canvas point count (0-dim int64). The
    kernel runs ``replay_deposit``'s queue (``replay_launch``)."""
    _check_nbins(canvas.num_pixels)
    cr, ci, iters, off = _check_replay_ids(cr, ci, iters, off, "c values")
    if cr.device.type == "cpu":
        return replay_ids_plain(cr, ci, iters, off, n_ids, canvas=canvas,
                                fractal=fractal, rows=rows)
    dev = cr.device
    ids = torch.empty(n_ids, dtype=torch.int32, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    if cr.numel() == 0:
        return ids, hits
    warps, take = replay_launch(cr.numel(), dev)
    queue = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().cb_replay_ids(
            fractal.kernel_id, _build.ptr(cr), _build.ptr(ci),
            _build.ptr(iters), _build.ptr(off), cr.numel(), _build.ptr(ids),
            canvas.min_real, canvas.min_imag, canvas.delta_real,
            canvas.delta_imag, canvas.width, canvas.height,
            *_check_rows(canvas, rows), warps, take, _build.ptr(queue),
            _build.ptr(hits), _build.stream_of(ids),
        )
    _build.check(rc, "replay_ids kernel")
    launches.COUNTS["replay_ids"] += 1
    return ids, hits


def replay_ids_plain(cr, ci, iters, off, n_ids: int, *, canvas: Canvas,
                     fractal: FractalMap, rows=None):
    """``replay_ids`` step-major in plain PyTorch."""
    launches.COUNTS["replay_ids_plain"] += 1
    return _write_steps(iters, off, n_ids, _sentinel(canvas, rows),
                        orbit_bins(cr, ci, iters, canvas=canvas,
                                   fractal=fractal, rows=rows))


def _sentinel(canvas: Canvas, rows) -> int:
    """The ids' sentinel in the row window ``rows``: its cells' count."""
    return _check_rows(canvas, rows)[1] * canvas.width


def replay_ids_ext(kr, ki, iters, off, n_ids: int, *, canvas: Canvas,
                   fractal: FractalMap, sample_domain: tuple, rows=None):
    """``replay_ids`` for extended-precision emissions (24-bit grid indices
    over ``sample_domain``): the df32 orbits of ``replay_deposit_ext``, and
    its queue. The stream is filled with the sentinel first and the kernel
    writes the on-canvas ids only: the same stream, word for word."""
    _check_nbins(canvas.num_pixels)
    kr, ki, iters, off = _check_replay_ids(kr, ki, iters, off,
                                           "grid indices")
    if kr.device.type == "cpu":
        return replay_ids_ext_plain(kr, ki, iters, off, n_ids, canvas=canvas,
                                    fractal=fractal,
                                    sample_domain=sample_domain, rows=rows)
    dev = kr.device
    ids = torch.full((n_ids,), _sentinel(canvas, rows), dtype=torch.int32,
                     device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    if kr.numel() == 0:
        return ids, hits
    iargs, fargs = _replay_ext_args(dev, kr.numel(), canvas, fractal,
                                    sample_domain, rows)
    queue = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _lib_ext()
    with torch.cuda.device(dev):
        rc = lib.cb_replay_ids_ext(
            _build.ptr(kr), _build.ptr(ki), _build.ptr(iters),
            _build.ptr(off), _build.ptr(ids), iargs, fargs,
            _build.ptr(queue), _build.ptr(hits), _build.stream_of(ids),
        )
    _build.check(rc, "replay_ids_ext kernel")
    launches.COUNTS["replay_ids_ext"] += 1
    return ids, hits


def replay_ids_ext_plain(kr, ki, iters, off, n_ids: int, *, canvas: Canvas,
                         fractal: FractalMap, sample_domain: tuple,
                         rows=None):
    """``replay_ids_ext`` step-major in plain PyTorch."""
    launches.COUNTS["replay_ids_ext_plain"] += 1
    return _write_steps(iters, off, n_ids, _sentinel(canvas, rows),
                        orbit_bins_ext(kr, ki, iters, canvas=canvas,
                                       fractal=fractal,
                                       sample_domain=sample_domain,
                                       rows=rows))


#: The id-stream routes of ``select_scatter_backend``: how each counts one
#: group's stream of replayed bin ids into the histogram. "bigtiles" sorts
#: it and adds one atomic per run of equal ids (``scatter_bigtiles``; the
#: route of ``--scatter bigtiles`` and of ``--scatter sorted``, whose JAX
#: ``scatter_sorted`` is the same sort and run-length add); "ids" counts
#: it as written, one atomic per id (``deposit_ids``, the function of the
#: JAX ``scatter_pallas``). The JAX ``--scatter pallas`` route skips
#: chunks of its stream that hold sentinels only (``skip_chunks``): the
#: blocked replay writes it step-major, so every block's short orbits
#: leave sentinel tails. ``replay_ids`` writes one slot per recorded step,
#: orbit-major, so no such runs exist here and nothing is skipped.
#: (Each looked up when called, so a patched wrapper is the one called.)
ID_ROUTES = {
    "bigtiles": lambda hist, ids: scatter_bigtiles(hist, ids),
    "ids": lambda hist, ids: deposit_ids(hist, ids),
}
#: Device bytes a replayed id takes at each route's peak: the stream alone
#: for "ids"; for "bigtiles" also torch.sort's sorted values (4) and int64
#: indices (8) and its working buffers (36 in all, 33.7-35.6 measured on
#: an NVIDIA H100 80GB HBM3, 700 W).
ID_ROUTE_BYTES = {"bigtiles": 36, "ids": 4}


def _replay_groups(hist_flat, iters, write_ids, route: str, max_len: int,
                   budget: int) -> torch.Tensor:
    """An id-stream route over a kept batch: consecutive groups of whole
    orbits, each replayed to ids (``write_ids(slice, off, n_ids)``) and
    counted into ``hist_flat`` by ``ID_ROUTES[route]``. Group j holds the
    orbits whose first id falls in [j B, (j + 1) B), B = budget - max_len,
    so its ids never exceed ``budget`` and no orbit is cut. The group
    bounds, their id offsets and the longest orbit come to the host in one
    read: the route's one synchronization per pass. Returns the on-canvas
    count."""
    deposit = ID_ROUTES[route]
    dev = hist_flat.device
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    k = iters.numel()
    budget = budget or BIGTILES_ID_BUDGET
    span = budget - max_len
    if k == 0:
        return hits
    if span < 1:
        raise ValueError(f"an orbit of {max_len} points does not fit the id "
                         f"budget of {budget}")
    off, ends = id_offsets(iters)
    groups = -(-k * max_len // span)
    first = torch.searchsorted(off, torch.arange(
        groups + 1, dtype=torch.int64, device=dev) * span)
    at = torch.cat([ends.new_zeros(1), ends])[first]
    host = torch.cat([first, at, (ends - off).max().reshape(1)]).tolist()
    bounds, offsets, longest = (host[:groups + 1],
                                host[groups + 1:-1], host[-1])
    if longest > max_len:
        raise ValueError(f"an orbit of {longest} points exceeds max_len "
                         f"{max_len}")
    for j in range(groups):
        e0, e1 = bounds[j], bounds[j + 1]
        n_ids = offsets[j + 1] - offsets[j]
        if n_ids == 0:
            continue
        ids, h = write_ids(slice(e0, e1), off[e0:e1] - offsets[j], n_ids)
        deposit(hist_flat, ids)
        hits += h
    return hits


def replay_id_stream(
    hist_flat: torch.Tensor,
    cr: torch.Tensor,
    ci: torch.Tensor,
    iters: torch.Tensor,
    *,
    canvas: Canvas,
    fractal: FractalMap,
    route: str = "bigtiles",
    max_len: int = MAX_ORBIT_LEN,
    budget: int = 0,
    rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """``replay_deposit`` through an id-stream route (``ID_ROUTES``): the
    ``replay_ids`` stream of each group of orbits, counted by ``route``.
    The same histogram, bit for bit, and the same on-canvas count (0-dim
    int64). ``max_len`` bounds the points of one orbit (the band's
    max_it); ``budget`` the ids of one group (0: ``BIGTILES_ID_BUDGET``);
    ``rows`` the histogram's row window."""
    _check_window_hist(hist_flat, canvas, rows)
    cr, ci, iters = (t.reshape(-1) for t in (cr, ci, iters))

    def write(sl, off, n_ids):
        return replay_ids(cr[sl], ci[sl], iters[sl], off, n_ids,
                          canvas=canvas, fractal=fractal, rows=rows)

    return _replay_groups(hist_flat, iters, write, route, max_len, budget)


def replay_id_stream_ext(
    hist_flat: torch.Tensor,
    kr: torch.Tensor,
    ki: torch.Tensor,
    iters: torch.Tensor,
    *,
    canvas: Canvas,
    fractal: FractalMap,
    sample_domain: tuple,
    route: str = "bigtiles",
    max_len: int = MAX_ORBIT_LEN,
    budget: int = 0,
    rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """``replay_deposit_ext`` through an id-stream route
    (``replay_ids_ext`` for the ids): the same histogram and count, bit
    for bit."""
    _check_window_hist(hist_flat, canvas, rows)
    kr, ki, iters = (t.reshape(-1) for t in (kr, ki, iters))

    def write(sl, off, n_ids):
        return replay_ids_ext(kr[sl], ki[sl], iters[sl], off, n_ids,
                              canvas=canvas, fractal=fractal,
                              sample_domain=sample_domain, rows=rows)

    return _replay_groups(hist_flat, iters, write, route, max_len, budget)


# ----------------------------------------------------------------------
# Metropolis-Hastings weighted deposits (--sampler mh).
#
# MH emissions carry the tenure's recorded visit bins plus (rep, t): the
# deposit is a pure integer scatter, no orbit is replayed. Exact accounting:
#   v   = (t - 1) / 256              the kernel's visit count (capped)
#   q   = floor(v * rep * 65536 / t) the tenure's deposit, in 1/256 units
#   d_k = floor((k+1) q / n) - floor(k q / n),  n = min(v, V)
# The JAX function and the CUDA kernel compute q by three u32 long-division
# steps; with t < 2^23, v <= 2^15 and rep <= 98303 < 2^17 (config validation
# bounds mh_rep_cap <= 32767 and steps_per_flush <= 65536) every
# intermediate stays below 2^32. The plain version runs the same steps in
# int64, where nothing can wrap, so the three agree exactly.


def mh_deposit_weights(t, rep, visit_slots: int):
    """Per-recorded-bin deposit weights of MH emissions.

    ``t``: int32 chain target 256*v+1 (> 1 marks a depositable emission;
    anything <= 1 deposits nothing); ``rep``: int32 tenure chain steps.
    Returns ``(d, n, q)``: d int64 (visit_slots, ...) the Bresenham spread
    (sum_k d_k == q), n int32 recorded-bin count, q int64 total deposit per
    emission (0 where invalid)."""
    valid = t > 1
    tu = torch.where(valid, t, 1).to(torch.int64)
    v = (tu - 1) // 256
    rep_u = torch.clamp(rep, min=0).to(torch.int64)
    n = torch.clamp(torch.where(valid, torch.clamp(v, max=visit_slots), 1),
                    min=1)
    big_n = v * rep_u
    q1 = big_n // tu
    r1 = big_n - q1 * tu
    q2 = (r1 * 256) // tu
    r2 = r1 * 256 - q2 * tu
    q3 = (r2 * 256) // tu
    q = torch.where(valid, q1 * 65536 + q2 * 256 + q3, 0)
    ks = torch.arange(visit_slots + 1, dtype=torch.int64,
                      device=t.device).view((-1,) + (1,) * t.dim())
    pref = (torch.minimum(ks, n[None]) * q[None]) // n[None]
    return pref[1:] - pref[:-1], n.to(torch.int32), q


def mh_scatter(hist_flat, bins, t, rep):
    """Scatter MH tenure deposits into a flat histogram (in place): the
    plain version of the ``mh_deposit`` kernel.

    ``bins``: int32 (V, S) recorded visit bins (slots >= n hold stale values
    and are masked off; a bin outside the histogram is dropped);
    ``t``/``rep``: int32 (S,). Returns (hist_flat, deposits int32 (S,), mass
    int64 (S,)): the per-emission recorded-bin count (0 where invalid) and
    deposited total q."""
    launches.COUNTS["mh_deposit_plain"] += 1
    visit_slots, nbins = bins.shape[0], hist_flat.numel()
    d, n, q = mh_deposit_weights(t, rep, visit_slots)
    kidx = torch.arange(visit_slots, device=bins.device)[:, None]
    take = ((t > 1)[None] & (kidx < n[None])
            & (bins >= 0) & (bins < nbins))
    hist_flat.index_add_(0, bins[take].to(torch.int64),
                         d[take].to(torch.int32))
    return hist_flat, torch.where(t > 1, n, 0).to(torch.int32), q


#: Blocks per SM of the mh_deposit kernel's grid (256 threads each; its
#: warps walk the emission slots 32 at a time): on an H100 the fastest of
#: 1..16 at the mhcrop and mhzoom cells (measured in PR 8). No result
#: depends on it.
MH_DEPOSIT_BLOCKS_PER_SM = 8


def mh_deposit(hist_flat: torch.Tensor, bins: torch.Tensor, t: torch.Tensor,
               rep: torch.Tensor, *, chunked: bool = False,
               gate: torch.Tensor | None = None, gate_min: int = 0,
               totals: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Deposit MH emissions into ``hist_flat`` (in place).

    ``bins`` is int32 (V, *E) for emissions of shape E; with ``chunked`` it
    is (C, V, *E) for emissions of shape (C, *E) -- the classify pass's
    emission buffers as they are, one chunk per flush window. ``t``/``rep``
    are int32 of the emissions' shape. With ``gate`` (int32, the same
    shape) a slot deposits only where ``gate >= gate_min`` (the pass's
    ``emit_it >= 0``; the tail flush's ``rep >= 1``): the kernel reads it
    itself. ``totals``: two 0-dim int64 tensors on the histogram's device
    (the engine's counters) that the recorded-bin count and the deposited
    total are added to; new zero ones when None. Returns the two totals."""
    _check_hist(hist_flat)
    if not (bins.dtype == t.dtype == rep.dtype == torch.int32):
        raise ValueError("bins, t and rep must be int32")
    if t.shape != rep.shape:
        raise ValueError("t and rep differ in shape")
    if gate is not None and (gate.dtype != torch.int32
                             or gate.shape != t.shape):
        raise ValueError("gate must be int32 of the emissions' shape")
    want = bins.shape[:1] + bins.shape[2:] if chunked else bins.shape[1:]
    if bins.dim() < 2 + int(chunked) or want != t.shape:
        raise ValueError(
            f"bins {tuple(bins.shape)} do not match emissions "
            f"{tuple(t.shape)}")
    chunks = bins.shape[0] if chunked else 1
    dev = hist_flat.device
    inputs = (bins, t, rep) + (() if gate is None else (gate,))
    if not all(x.device == dev for x in inputs):
        raise ValueError("deposit inputs lie on different devices")
    if totals is None:
        totals = tuple(torch.zeros((), dtype=torch.int64, device=dev)
                       for _ in range(2))
    if not all(x.dtype == torch.int64 and x.numel() == 1
               and x.device == dev for x in totals):
        raise ValueError("totals must be two int64 scalars on the "
                         "histogram's device")
    deposits, mass = totals
    slots = bins.shape[1] if chunked else bins.shape[0]
    n = t.numel()
    if dev.type == "cpu":
        if chunked:
            bins = bins.reshape(chunks, slots, -1).transpose(0, 1)
        if gate is not None:
            t = torch.where(gate >= gate_min, t, 0)
        _, dep, m = mh_scatter(
            hist_flat, bins.reshape(slots, n), t.reshape(-1), rep.reshape(-1))
        deposits += dep.sum()
        mass += m.sum()
        return deposits, mass
    if n == 0:
        return deposits, mass
    bins, t, rep = (x.contiguous() for x in (bins, t, rep))
    if gate is not None:
        gate = gate.contiguous()
    lanes = n // chunks
    blocks = min(
        torch.cuda.get_device_properties(dev).multi_processor_count
        * MH_DEPOSIT_BLOCKS_PER_SM,
        max(1, (chunks * ((lanes + 31) // 32) + 7) // 8))
    with torch.cuda.device(dev):
        rc = _lib().cb_mh_deposit(
            _build.ptr(bins), None if gate is None else _build.ptr(gate),
            gate_min, _build.ptr(t), _build.ptr(rep), n, slots, lanes,
            _build.ptr(hist_flat), hist_flat.numel(), _build.ptr(deposits),
            _build.ptr(mass), blocks, _build.stream_of(hist_flat),
        )
    _build.check(rc, "mh_deposit kernel")
    launches.COUNTS["mh_deposit"] += 1
    return deposits, mass


def _lib_ext():
    lib = _build.load("deposit_ext")
    if lib.cb_replay_deposit_ext.argtypes is None:
        vp = ctypes.c_void_p
        lib.cb_replay_deposit_ext.argtypes = [
            vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), vp, vp, vp,
        ]
        lib.cb_replay_deposit_ext.restype = ctypes.c_int
        lib.cb_replay_ids_ext.argtypes = [
            vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), vp, vp, vp,
        ]
        lib.cb_replay_ids_ext.restype = ctypes.c_int
    return lib


def _lib_bigtiles():
    lib = _build.load("bigtiles")
    if lib.cb_bigtiles_deposit.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cb_bigtiles_deposit.argtypes = [vp, ctypes.c_longlong, i, vp, i,
                                            vp]
        lib.cb_bigtiles_deposit.restype = i
    return lib


def _lib():
    lib = _build.load("deposit")
    if lib.cb_deposit_ids.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cb_deposit_ids.argtypes = [vp, ctypes.c_longlong, vp, i, vp]
        lib.cb_deposit_ids.restype = i
        lib.cb_replay_deposit.argtypes = [
            i, vp, vp, vp, i, vp, f, f, f, f, i, i, i, i, i, i, vp, vp, vp,
        ]
        lib.cb_replay_deposit.restype = i
        lib.cb_replay_ids.argtypes = [
            i, vp, vp, vp, vp, i, vp, f, f, f, f, i, i, i, i, i, i, vp, vp,
            vp,
        ]
        lib.cb_replay_ids.restype = i
        lib.cb_mh_deposit.argtypes = [
            vp, vp, i, vp, vp, ctypes.c_longlong, i, i, vp, i, vp, vp, i, vp,
        ]
        lib.cb_mh_deposit.restype = i
    return lib
