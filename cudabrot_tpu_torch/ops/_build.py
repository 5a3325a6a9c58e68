"""Build the CUDA sources with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``build/cudabrot_tpu_torch/`` under the
repository root, named by a digest of its sources and flags; a changed
source rebuilds, an unchanged one loads. Flags: ``sm_90a`` (Hopper),
``-O3``, ``--split-compile=0`` (the classify library's template
instances compile on every core), and ``-fmad=false`` — the orbit
arithmetic must round every product and sum once, as the plain PyTorch
versions do (the kernels also spell their arithmetic with
``__fmul_rn``/``__fadd_rn``). No fast-math. A build may add macro
definitions (``defines``, e.g. ``("CB_LANES_PER_THREAD=4",)``): a
variant of a source, built beside the library and named by its own
digest, for the measurement study and the kernel tests; the package
loads the plain build.
A failed build raises ``BuildError``; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cudabrot_tpu_torch"
LIBS = ("classify", "deposit", "classify_ext", "deposit_ext", "classify_mh",
        "bigtiles", "length_sort")
_HEADERS = ("orbit.cuh", "classify.cuh", "df32.cuh", "classify_ext.cuh",
            "mh.cuh", "bigtiles.cuh", "length_sort.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "--split-compile=0",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[tuple, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
        f"{CSRC} at first use."
    )


def _flags(defines=()) -> tuple:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def lib_path(name: str, defines=()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for f in (f"{name}.cu", *_HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _log_path(name: str, defines=()) -> Path:
    return lib_path(name, defines).with_suffix(".log")


def start_build(name: str, defines=()):
    """Start nvcc for one library; returns the process, or None when the
    library is already built."""
    out = lib_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    log = open(_log_path(name, defines), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc._cb_lib, proc._cb_tmp, proc._cb_log = (name, defines), tmp, log
    return proc


def finish_build(proc) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc._cb_log.close()
    name, defines = proc._cb_lib
    if rc != 0:
        raise BuildError(
            f"nvcc failed on {name}.cu {' '.join(defines)} (exit {rc}):\n"
            f"{ptxas_report(name, defines)}"
        )
    os.replace(proc._cb_tmp, lib_path(name, defines))


def build_all(names=LIBS, variants=()) -> None:
    """Build every library at once, and each (name, defines) of
    ``variants`` beside them (one nvcc per build, all started together),
    and wait for all of them."""
    procs = [start_build(n) for n in names]
    procs += [start_build(n, d) for n, d in variants]
    errors = []
    for p in procs:
        try:
            finish_build(p)
        except BuildError as e:
            errors.append(str(e))
    if errors:
        raise BuildError("\n".join(errors))


def ptxas_report(name: str, defines=()) -> str:
    """nvcc's output from the last build of ``name`` (``-Xptxas -v``:
    registers, shared memory and spills per kernel)."""
    p = _log_path(name, defines)
    return p.read_text() if p.exists() else ""


def load(name: str, defines=()) -> ctypes.CDLL:
    """The built library (building it first if needed)."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        finish_build(start_build(name, key[1]))
        lib = ctypes.CDLL(str(lib_path(name, key[1])))
        _loaded[key] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
