"""Histogram checkpoint/resume (the -s flag).

The reference dumps the raw uint32 host buffer with no header, validates
resumes only by byte length, and writes non-atomically once at exit
(LoadInProgressBuffer/SaveInProgressBuffer, cudabrot.cu:215-280). CLI
semantics are preserved — load-if-exists, missing file is benign
(cudabrot.cu:226-231), dimension mismatch is a fatal error
(cudabrot.cu:239-245) — but the format is upgraded:

  * .npz container carrying the histogram plus metadata (canvas, band,
    fractal, seed, pass count, format version) so a resume can verify it is
    continuing the *same* render, not just one with the same byte count;
  * atomic tmp-file + rename writes, so a crash mid-save never destroys the
    previous checkpoint (the reference can, cudabrot.cu:266-272);
  * CRC32 of the histogram payload for corruption detection;
  * reading the reference's raw format is still supported: a file that is
    not an npz but is exactly w*h*4 bytes is loaded as a little-endian
    uint32 dump, so renders started with the CUDA binary can be *continued*
    on TPU.

A copy of ``cudabrot_tpu.io.checkpoint``: the same npz layout, metadata
and CRC, so a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib

import numpy as np

from cudabrot_tpu_torch.config import RenderConfig

FORMAT_VERSION = 1
#: MH histograms count in 1/256 units (cudabrot_tpu/ops/pallas_kernels_mh
#: WEIGHT_SCALE); checkpoints record it, and a resume must match it.
MH_WEIGHT_SCALE = 256


class CheckpointError(RuntimeError):
    pass


def _metadata(cfg: RenderConfig, passes: int) -> dict:
    return {
        "format_version": FORMAT_VERSION,
        "width": cfg.canvas.width,
        "height": cfg.canvas.height,
        "min_real": cfg.canvas.min_real,
        "max_real": cfg.canvas.max_real,
        "min_imag": cfg.canvas.min_imag,
        "max_imag": cfg.canvas.max_imag,
        "max_escape_iterations": cfg.band.max_escape_iterations,
        "min_escape_iterations": cfg.band.min_escape_iterations,
        "fractal": cfg.fractal,
        "sample_domain": list(cfg.sample_domain),
        "precision": cfg.options.precision,
        "seed": cfg.seed,
        "passes": passes,
        "sampler": cfg.options.sampler,
        # MH histograms count in 1/weight_scale units (the fixed-point
        # importance weights, ops/pallas_kernels_mh.WEIGHT_SCALE);
        # uniform histograms count raw orbit points (scale 1).
        "weight_scale": _weight_scale(cfg),
    }


def _weight_scale(cfg: RenderConfig) -> int:
    return MH_WEIGHT_SCALE if cfg.options.sampler == "mh" else 1


def _resolution_class(precision: str) -> str:
    """Sampling/orbit resolution class: f32 quantizes positions at
    ~2^-24 relative (coarse); float64 and extended (df32, ~2^-48) both
    resolve deep windows (fine). Mixing classes in one histogram blends
    a lattice-quantized measure with a smooth one — visible corruption
    exactly at the deep windows extended exists for."""
    return "coarse" if precision == "float32" else "fine"


def _fsync_dir(dirpath: str) -> None:
    """Flush the directory entry so a rename survives power loss; best
    effort (some filesystems refuse O_RDONLY dir fsync)."""
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def save(path: str, hist: np.ndarray, cfg: RenderConfig, passes: int) -> None:
    """Atomically write the checkpoint (uint32, or uint64 for
    extreme-duration renders — the dtype rides in the npz array)."""
    dtype = np.uint64 if np.asarray(hist).dtype == np.uint64 else np.uint32
    hist = np.ascontiguousarray(hist, dtype=dtype)
    meta = _metadata(cfg, passes)
    meta["dtype"] = np.dtype(dtype).name
    meta["crc32"] = zlib.crc32(hist.tobytes()) & 0xFFFFFFFF
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".",
        prefix=os.path.basename(path) + ".tmp.",
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, hist=hist, meta=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8))
            f.flush()
            os.fsync(f.fileno())  # durable before the rename commits it
        # mkstemp creates 0600; give the checkpoint normal umask-style
        # permissions instead of silently resetting them every save.
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)) or ".")
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load(path: str, cfg: RenderConfig) -> tuple[np.ndarray, dict] | None:
    """Load a checkpoint if the file exists.

    Returns (hist, metadata) or None when the file is missing (benign,
    cudabrot.cu:226-231). Raises CheckpointError on any mismatch, mirroring
    the reference's fatal size check (cudabrot.cu:239-245).
    """
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except FileNotFoundError:
        return None

    canvas = cfg.canvas
    if head[:2] != b"PK":  # not a zip/npz: reference raw-dump compatibility
        size = os.path.getsize(path)
        expected = canvas.histogram_nbytes
        if size != expected:
            raise CheckpointError(
                f"The size of {path} doesn't match the expected size of "
                f"{expected} bytes."
            )
        from cudabrot_tpu_torch.config import SAMPLE_DOMAIN

        if tuple(cfg.sample_domain) != SAMPLE_DOMAIN:
            # Reference raw dumps are always full-domain samples; folding
            # them into a restricted-domain render would blend measures.
            raise CheckpointError(
                f"Checkpoint {path} is a reference raw dump (full sample "
                f"domain); the render samples {list(cfg.sample_domain)}."
            )
        if cfg.options.sampler == "mh":
            # Raw dumps count raw orbit points; MH renders count
            # fixed-point importance weights.
            raise CheckpointError(
                f"Checkpoint {path} is a reference raw dump (uniform "
                f"sampling, unit counts); it cannot seed an MH render."
            )
        hist = np.fromfile(path, dtype="<u4").reshape(canvas.shape)
        return hist, {"format_version": 0, "passes": 0}

    with np.load(path) as data:
        hist = np.asarray(data["hist"])
        if hist.dtype != np.uint64:  # uint64 survives; anything else is u32
            hist = hist.astype(np.uint32)
        meta = json.loads(bytes(data["meta"]).decode())

    if hist.shape != canvas.shape:
        raise CheckpointError(
            f"Checkpoint {path} has dimensions {hist.shape[1]}x{hist.shape[0]}"
            f" but the render is {canvas.width}x{canvas.height}."
        )
    for key, want in (
        ("min_real", canvas.min_real),
        ("max_real", canvas.max_real),
        ("min_imag", canvas.min_imag),
        ("max_imag", canvas.max_imag),
    ):
        have = meta.get(key)
        if have is not None and have != want:
            raise CheckpointError(
                f"Checkpoint {path} was rendered on a different canvas "
                f"({key}={have}, expected {want})."
            )
    if meta.get("fractal") not in (None, cfg.fractal):
        raise CheckpointError(
            f"Checkpoint {path} is for fractal {meta['fractal']!r}, "
            f"not {cfg.fractal!r}."
        )
    # Mixing sample domains silently blends two different sampling
    # measures into one histogram — fatal, like a canvas mismatch.
    # Checkpoints written before the field existed (and reference raw
    # dumps) sampled the full domain.
    from cudabrot_tpu_torch.config import SAMPLE_DOMAIN

    have_dom = tuple(meta.get("sample_domain", SAMPLE_DOMAIN))
    if have_dom != tuple(cfg.sample_domain):
        raise CheckpointError(
            f"Checkpoint {path} was sampled over domain {list(have_dom)}, "
            f"but the render samples {list(cfg.sample_domain)}."
        )
    # Precision resolution classes must match (f32 vs f64/extended):
    # see _resolution_class. Legacy checkpoints without the field are
    # assumed compatible (they predate the extended mode).
    have_prec = meta.get("precision")
    if have_prec is not None and _resolution_class(
        have_prec
    ) != _resolution_class(cfg.options.precision):
        raise CheckpointError(
            f"Checkpoint {path} was rendered at precision {have_prec!r}; "
            f"resuming at {cfg.options.precision!r} would blend a "
            f"float32-quantized sampling measure with a deep-zoom one."
        )
    # Histogram units must match: MH deposits are fixed-point importance
    # weights (1/weight_scale counts), uniform deposits are raw orbit
    # points. Mixing them adds numbers on different scales. Legacy
    # checkpoints without the field are uniform (scale 1).
    have_scale = int(meta.get("weight_scale", 1))
    want_scale = _weight_scale(cfg)
    if have_scale != want_scale:
        raise CheckpointError(
            f"Checkpoint {path} counts in 1/{have_scale} units (sampler "
            f"{meta.get('sampler', 'uniform')!r}); the render counts in "
            f"1/{want_scale} units (sampler {cfg.options.sampler!r}). "
            f"Resume with the matching --sampler."
        )
    crc = meta.get("crc32")
    if crc is not None and (zlib.crc32(hist.tobytes()) & 0xFFFFFFFF) != crc:
        raise CheckpointError(f"Checkpoint {path} failed its CRC32 check.")
    # Central uint64 -> uint32 downcast guard: every engine resumes
    # through this loader, and the device-replay/row-sharded paths cast
    # the resumed histogram to uint32 (their accumulation dtype) — a
    # silent mod-2^32 wrap of hot bins if the checkpoint outgrew uint32.
    # (HostReplayWorker.add_resumed re-checks for direct API users.)
    if (
        hist.dtype == np.uint64
        and cfg.options.hist_dtype == "uint32"
        and int(hist.max(initial=0)) > 0xFFFFFFFF
    ):
        raise CheckpointError(
            f"Checkpoint {path} holds uint64 counts above the uint32 "
            "range; resume with --hist-dtype uint64."
        )
    return hist, meta
