"""ctypes binding to the native host replay (``csrc/tpubrot_native.cpp``).

Port of the replay half of ``cudabrot_tpu/io/native.py``: the four entry
points ``tpubrot_replay_scatter(64)`` and ``tpubrot_replay_scatter_f64(_64)``
replay known-escaping samples' orbits on host threads (per-thread private
histograms, merged in a fixed order) into a uint32 or uint64 histogram.
The PGM, CRC and atomic-write entry points are not bound: the port writes
those files in Python, byte for byte the JAX package's.

The library is built from the repository's ``csrc/tpubrot_native.cpp`` at
first use with ``g++`` and ``csrc/Makefile``'s flags, into
``build/cudabrot_tpu_torch/`` under a name that hashes the source, the
flags and the host CPU (``-march=native`` code runs only where it was
built), as ``ops/_build.py`` does for the CUDA libraries. It is never
written into ``csrc/``. A missing ``g++`` or a failed build raises
``NativeError`` naming the cause; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "tpubrot_native.cpp"
BUILD_DIR = ROOT / "build" / "cudabrot_tpu_torch"
#: csrc/Makefile's CXXFLAGS (warnings aside) and LDFLAGS.
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fno-math-errno",
             "-fPIC", "-shared", "-pthread", "-std=c++17")
#: The four replay entry points; the f64 pair replays extended-precision
#: payloads.
ENTRY_POINTS = ("tpubrot_replay_scatter", "tpubrot_replay_scatter64",
                "tpubrot_replay_scatter_f64", "tpubrot_replay_scatter_f64_64")
#: Flag bits of the replay entry points (csrc/tpubrot_native.cpp).
FLAG_SHIP, FLAG_STRICT = 1, 2

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
#: Seconds the last build of this process took (0.0 when it loaded a
#: library built before).
build_seconds = 0.0


class NativeError(RuntimeError):
    """The native replay library cannot be built or loaded."""


def _cpu_signature() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` code is
    built for them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines
            if ln.startswith((b"model name", b"flags", b"Features"))]
    return b"\n".join(dict.fromkeys(keep))


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_signature())
    return BUILD_DIR / f"libtpubrot_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """g++ the library into ``out`` under a lock, so concurrent processes
    build it once."""
    global build_seconds
    import time

    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeError(
            f"g++ not found: the native host replay is built from {SOURCE} "
            "at first use (set CXX or install g++).")
    if not SOURCE.exists():
        raise NativeError(f"native replay source {SOURCE} is missing.")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtpubrot_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)],
                                  capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeError(f"{cxx} failed to run on {SOURCE}: {e}") from e
        if proc.returncode != 0:
            raise NativeError(
                f"{cxx} failed on {SOURCE} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The native replay library, built first if needed. Raises
    NativeError."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = lib_path()
        if not out.exists():
            _build(out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise NativeError(f"cannot load {out}: {e}") from e
        missing = [n for n in ENTRY_POINTS if not hasattr(lib, n)]
        if missing:
            raise NativeError(f"{out} lacks {', '.join(missing)}")
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        tail = [
            ctypes.POINTER(ctypes.c_int32),   # iters
            ctypes.c_int64,                   # n
            ctypes.c_int32,                   # w
            ctypes.c_int32,                   # h
            ctypes.c_double,                  # min_real
            ctypes.c_double,                  # min_imag
            ctypes.c_double,                  # delta_real
            ctypes.c_double,                  # delta_imag
            ctypes.c_int32,                   # flags
            ctypes.c_int32,                   # num_threads
        ]
        for name, cp, bins in (
            ("tpubrot_replay_scatter", f32p, ctypes.c_uint32),
            ("tpubrot_replay_scatter64", f32p, ctypes.c_uint64),
            ("tpubrot_replay_scatter_f64", f64p, ctypes.c_uint32),
            ("tpubrot_replay_scatter_f64_64", f64p, ctypes.c_uint64),
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [cp, cp, *tail, ctypes.POINTER(bins),
                           ctypes.POINTER(ctypes.c_uint64)]
        _LIB = lib
        return _LIB


def supports_f64() -> bool:
    """Whether the library has the double-precision entry points. The port
    builds it from source, so it always does (``load`` raises otherwise)."""
    return hasattr(load(), "tpubrot_replay_scatter_f64")


def _call(name64: str, name32: str, ctype, cr, ci, iters, hist, *, width,
          height, min_real, min_imag, delta_real, delta_imag, flags,
          num_threads) -> tuple[int, int]:
    lib = load()
    iters = np.ascontiguousarray(iters, np.int32)
    if not (len(cr) == len(ci) == len(iters)):
        raise ValueError("replay inputs differ in length")
    if hist.dtype not in (np.uint32, np.uint64) or not hist.flags.c_contiguous:
        raise ValueError("hist must be a C-contiguous uint32 or uint64 array")
    if hist.size != int(width) * int(height):
        raise ValueError("hist does not hold width x height bins")
    wide = hist.dtype == np.uint64
    fn = getattr(lib, name64 if wide else name32)
    points = ctypes.c_uint64(0)
    hits = fn(
        cr.ctypes.data_as(ctypes.POINTER(ctype)),
        ci.ctypes.data_as(ctypes.POINTER(ctype)),
        iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(cr), width, height, min_real, min_imag, delta_real, delta_imag,
        flags, num_threads,
        hist.ctypes.data_as(ctypes.POINTER(
            ctypes.c_uint64 if wide else ctypes.c_uint32)),
        ctypes.byref(points),
    )
    return int(hits), int(points.value)


def replay_scatter(cr, ci, iters, hist: np.ndarray, *, width: int,
                   height: int, min_real: float, min_imag: float,
                   delta_real: float, delta_imag: float,
                   burning_ship: bool = False, num_threads: int = 0,
                   strict: bool = False) -> tuple[int, int]:
    """Replay known-escaping f32 samples into ``hist`` ((h, w) uint32 or
    uint64, mutated in place; its dtype selects the entry point). An
    emission with ``iters < 0`` is inactive; an active one records
    z_1..z_{iters+1}. Returns (on_canvas_hits, total_points).

    ``strict`` selects the contraction-proof orbit (one rounding per
    product and sum), which equals the port's classify trajectory bitwise:
    its kernels are built with ``-fmad=false`` and its plain versions run
    eager. The default contracted variant is the JAX CPU backend's. Bins
    are ``(z - min) * float32(1 / delta)``, where the port's device replay
    divides by the pitch: the two differ at bin edges only."""
    cr = np.ascontiguousarray(cr, np.float32)
    ci = np.ascontiguousarray(ci, np.float32)
    flags = (FLAG_SHIP if burning_ship else 0) | (FLAG_STRICT if strict
                                                  else 0)
    return _call("tpubrot_replay_scatter64", "tpubrot_replay_scatter",
                 ctypes.c_float, cr, ci, iters, hist, width=width,
                 height=height, min_real=min_real, min_imag=min_imag,
                 delta_real=delta_real, delta_imag=delta_imag, flags=flags,
                 num_threads=num_threads)


def replay_scatter_f64(cr, ci, iters, hist: np.ndarray, *, width: int,
                       height: int, min_real: float, min_imag: float,
                       delta_real: float, delta_imag: float,
                       burning_ship: bool = False,
                       num_threads: int = 0) -> tuple[int, int]:
    """``replay_scatter`` with float64 samples, for extended-precision
    payloads (c rebuilt from the df32 window's grid indices): the orbit and
    the binning run in double. It has no strict variant: a df32 stream
    cannot be matched by any f64 arithmetic, so its contract with the
    device is statistical."""
    cr = np.ascontiguousarray(cr, np.float64)
    ci = np.ascontiguousarray(ci, np.float64)
    return _call("tpubrot_replay_scatter_f64_64", "tpubrot_replay_scatter_f64",
                 ctypes.c_double, cr, ci, iters, hist, width=width,
                 height=height, min_real=min_real, min_imag=min_imag,
                 delta_real=delta_real, delta_imag=delta_imag,
                 flags=FLAG_SHIP if burning_ship else 0,
                 num_threads=num_threads)
