"""Build the hand-written CUDA kernels (`csrc/*.cu`) and load them by ctypes.

Each source is compiled on first use by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface under `recommendflow_tpu_torch/build/`
(git-ignored). The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale one is never loaded. A
source includes no PyTorch header, so a build takes seconds.

Nothing here is imported or run on a machine without a card: the wrappers in
`ops/cuda/` load a library only when they are handed a CUDA tensor. A failed
build or load raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register / spill report of each build, for the build log
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC); the CUDA "
                       "kernels are built from csrc/ on the machine with the card")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(source_path(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str) -> Tuple[Optional[subprocess.Popen], str, str]:
    out = library_path(name)
    if os.path.exists(out):
        return None, out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, proc: Optional[subprocess.Popen], out: str,
            tmp: str, timeout: float) -> None:
    if proc is None:
        return
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out after {timeout:.0f} s on {name}.cu")
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file


def build(names: Iterable[str], timeout: float = 600.0) -> Dict[str, float]:
    """Compile the named sources, one nvcc process each, all started
    together. Returns {name: seconds until its build was done}; 0.0 for a
    library that was already built."""
    names = list(names)
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    times: Dict[str, float] = {}
    for name, proc, out, tmp in started:
        _finish(name, proc, out, tmp, timeout)
        times[name] = 0.0 if proc is None else time.perf_counter() - t0
    return times


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.rf_error_string.argtypes = [ctypes.c_int]
            lib.rf_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.rf_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} at launch ({msg})")
