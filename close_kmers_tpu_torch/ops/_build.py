"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the
objects are linked into one shared library with a plain C interface,
``close_kmers_tpu_torch/.build/libck_torch_kernels.so``, loaded with
ctypes.  The library is rebuilt when any source under ``csrc/`` is newer
than it.  No ``--use_fast_math``: the scan and family-group kernels' f32
sums must match the reference bit for bit.

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
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None
_fns: dict = {}
# the compiler's report of the last verbose build (``-Xptxas -v``)
ptxas_report = ""


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
    every source; returns its path.  ``verbose`` adds ``-Xptxas -v``,
    prints the compiler's report (registers, shared memory, spills) and
    keeps it in :data:`ptxas_report`."""
    global ptxas_report
    srcs = _sources()
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= max(map(os.path.getmtime, deps))):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in srcs:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, report = [], []
    for cmd, obj, proc in jobs:       # wait for every compiler started
        out, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed with exit code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{out}{err}")
        elif verbose:
            sys.stderr.write(out + err)
            report.append(out + err)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB}.{tag}"
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed with exit code "
                               f"{proc.returncode}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB)   # atomic: a concurrent process never loads a torn file
    if verbose:
        ptxas_report = "".join(report)
    return LIB


def kernel(name: str, argtypes: list):
    """The C entry point ``name`` of the built library, with its
    ``argtypes`` declared (``c_void_p`` for every pointer and the
    stream) and an int return code; looked up once per name."""
    global _lib
    fn = _fns.get(name)
    if fn is None:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        fn = getattr(_lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
