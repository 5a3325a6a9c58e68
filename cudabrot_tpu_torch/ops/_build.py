"""Build the CUDA sources with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` builds it in seconds into ``build/cudabrot_tpu_torch/`` under the
repository root, named by a digest of its sources and flags; a changed
source rebuilds, an unchanged one loads. Flags: ``sm_90a`` (Hopper),
``-O3``, and ``-fmad=false`` — the orbit arithmetic must round every
product and sum once, as the plain PyTorch versions do (the kernels also
spell their arithmetic with ``__fmul_rn``/``__fadd_rn``). No fast-math.
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
LIBS = ("classify", "deposit")
_HEADERS = ("orbit.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


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


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *_HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _log_path(name: str) -> Path:
    return lib_path(name).with_suffix(".log")


def start_build(name: str):
    """Start nvcc for one library; returns the process, or None when the
    library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(_log_path(name), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc._cb_name, proc._cb_tmp, proc._cb_log = name, tmp, log
    return proc


def finish_build(proc) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc._cb_log.close()
    name = proc._cb_name
    if rc != 0:
        raise BuildError(
            f"nvcc failed on {name}.cu (exit {rc}):\n{ptxas_report(name)}"
        )
    os.replace(proc._cb_tmp, lib_path(name))


def build_all(names=LIBS) -> None:
    """Build every library at once (one nvcc per source, all started
    together) and wait for all of them."""
    procs = [start_build(n) for n in names]
    errors = []
    for p in procs:
        try:
            finish_build(p)
        except BuildError as e:
            errors.append(str(e))
    if errors:
        raise BuildError("\n".join(errors))


def ptxas_report(name: str) -> str:
    """nvcc's output from the last build of ``name`` (``-Xptxas -v``:
    registers, shared memory and spills per kernel)."""
    p = _log_path(name)
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library (building it first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        finish_build(start_build(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
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
