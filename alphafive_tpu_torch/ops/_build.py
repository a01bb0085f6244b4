"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into one shared library
with a plain C interface, ``build/kernels/<hash>/libalphafive_kernels.so``
at the repository root, and loaded with ctypes. ``<hash>`` covers the
sources and the flags, so an edit rebuilds and an unchanged tree reuses
the library. The build runs at first use, never at import: hosts without
nvcc (the CPU test hosts) import every module and never get here.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_seconds = None  # wall time of the build (or load) in this process
build_log = ""        # nvcc's output, including ptxas's register report


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels build only on a host with the toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in _SOURCES:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.time()
    out_dir = os.path.join(BUILD_ROOT, _digest())
    so = os.path.join(out_dir, "libalphafive_kernels.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *FLAGS, "-o", tmp, *_SOURCES]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + build_log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.alphafive_resblock.restype = ctypes.c_int
    lib.alphafive_resblock.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    _lib = lib
    build_seconds = time.time() - t0
    return lib
