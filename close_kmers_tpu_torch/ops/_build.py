"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``close_kmers_tpu_torch/.build/libck_torch_kernels.so``, and loaded with
ctypes.  The library is rebuilt when any source under ``csrc/`` is newer
than it.  No ``--use_fast_math``: the scan kernel's f32 sums must match
the reference bit for bit.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, ".build")
LIB = os.path.join(BUILD_DIR, "libck_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into :data:`LIB` unless it is newer than
    every source; returns its path.  ``verbose`` adds ``-Xptxas -v`` and
    prints the compiler's report (registers, shared memory, spills)."""
    srcs = _sources()
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= max(map(os.path.getmtime, deps))):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    if verbose:
        sys.stderr.write(proc.stdout + proc.stderr)
    os.replace(tmp, LIB)   # atomic: a concurrent process never loads a torn file
    return LIB


def kernel(name: str, argtypes: list):
    """The C entry point ``name`` of the built library, with its
    ``argtypes`` declared (``c_void_p`` for every pointer and the
    stream) and an int return code."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
    fn = getattr(_lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
