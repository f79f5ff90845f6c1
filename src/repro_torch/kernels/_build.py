"""Build and load the port's CUDA kernels: ``nvcc`` + ``ctypes``.

Each source in ``csrc/`` exposes a plain C interface (``extern "C"`` launch
functions that return the ``cudaError_t`` of ``cudaGetLastError()`` right
after the launch) and is compiled on its own, with the shared ``*.cuh``
headers beside it, into a shared library under
``build/torch_kernels/`` at the repository root, for ``sm_90a``.  Nothing
here runs at import: the first kernel call (or an explicit
:func:`build_all`) compiles every source at once, one ``nvcc`` process per
file started together, and loads the libraries.  A library whose name
carries the hash of its source, the headers and the flags is reused when
it already exists.

Each source compiled publishes one ``cuda/nvcc_build`` event on the obs
bus (``obs.bench.count_compiles`` counts them); a reused library publishes
none.  A missing ``nvcc`` or a failed compile raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from .. import obs
from ..obs.bench import COMPILE_EVENT

__all__ = ["SOURCES", "BUILD_DIR", "COUNT_LOCK", "build_all", "library",
           "check_launch"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: src/repro_torch/kernels -> repository root
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

#: kernel name -> source file in csrc/
SOURCES = {
    "congestion": "congestion.cu",
    "minplus": "minplus.cu",
    "admission": "admission.cu",
    "matmul": "matmul.cu",
    "fanin": "fanin.cu",
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

#: Guards every wrapper's launch counter: the build pipeline launches
#: kernels from its worker thread while the caller's thread launches its
#: own, and ``+=`` on a module global is not atomic.
COUNT_LOCK = threading.Lock()

#: per-kernel build record of the last build_all(): seconds and ptxas report
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are compiled at first "
            "use and need the CUDA toolkit on PATH or in /usr/local/cuda"
        )
    return path


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    # the shared headers are part of every source's input
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> dict[str, float]:
    """Compile every kernel source that is not built yet, all at once.

    Returns ``{name: seconds}`` for the sources compiled in this call (empty
    when everything was already built).  Raises ``RuntimeError`` with the
    compiler's output when any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    seconds: dict[str, float] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = {"seconds": seconds[name], "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[name]} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        obs.emit(COMPILE_EVENT, source=SOURCES[name], seconds=seconds[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first if
    needed.  ``signatures`` maps each exported C function to its ctypes
    argument types; every function returns a ``cudaError_t`` as an int."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check_launch(err: int, what: str) -> None:
    """Raise when a launch function reported a CUDA error (the value of
    ``cudaGetLastError()`` right after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
