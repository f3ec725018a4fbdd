# Copied from close_kmers_tpu/native/build.py.
"""Build the native runtime library (libckmers.so) with g++.

Usage: python -m close_kmers_tpu_torch.native.build
The library is also built lazily on first use by api.lib().  It goes into
``close_kmers_tpu_torch/.build/`` (ignored by git), never next to the
source, and is rebuilt when ``ckmers.cpp`` is newer than it.
"""

from __future__ import annotations

import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "ckmers.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), ".build")
LIB = os.path.join(BUILD_DIR, "libckmers.so")


def build(force: bool = False) -> str:
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= os.path.getmtime(SRC)):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-o", tmp, SRC]
    subprocess.run(cmd, check=True)
    os.replace(tmp, LIB)   # atomic: a concurrent process never loads a torn file
    return LIB


if __name__ == "__main__":
    print(build(force=True))
