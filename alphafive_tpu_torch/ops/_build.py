"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, ``build/kernels/<hash>/libalphafive_kernels.so`` at
the repository root, loaded with ctypes. ``<hash>`` covers the sources and
the flags, so an edit rebuilds and an unchanged tree reuses the library.
The build runs at first use, never at import: hosts without nvcc (the CPU
test hosts) import every module and never get here.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
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


def _run(cmds, out_dir: str) -> None:
    """Run the nvcc commands `cmds` in parallel; raise if any fails."""
    global build_log
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs))
    build_log += log
    with open(os.path.join(out_dir, "build.log"), "a") as f:
        f.write(log)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.alphafive_resblock.restype = i32
    lib.alphafive_resblock.argtypes = [i32] + [ptr] * 7 + [i32] * 4 + [ptr]
    lib.alphafive_resblock_workspace.restype = ctypes.c_longlong
    lib.alphafive_resblock_workspace.argtypes = [i32] * 5
    lib.alphafive_resblock_as.restype = i32
    lib.alphafive_resblock_as.argtypes = [i32] * 2 + [ptr] * 7 + [i32] * 4 + [
        ptr]
    lib.alphafive_resblock_workspace_as.restype = ctypes.c_longlong
    lib.alphafive_resblock_workspace_as.argtypes = [i32] * 6
    lib.alphafive_resblock_narrowed.restype = ctypes.c_longlong
    lib.alphafive_resblock_narrowed.argtypes = []
    lib.alphafive_resblock_active_clusters.restype = i32
    lib.alphafive_resblock_active_clusters.argtypes = [i32] * 4
    lib.alphafive_resblock_variant.restype = i32
    lib.alphafive_resblock_pack_taps.restype = i32
    lib.alphafive_resblock_pack_taps.argtypes = [ptr] * 3 + [i32, ptr]
    lib.alphafive_resblock_variant.argtypes = [i32] * 5
    lib.alphafive_select.restype = i32
    lib.alphafive_select.argtypes = ([ptr] + [i32] * 5 + [f32] * 2
                                     + [ptr] * 5 + [ptr])


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source hash has none."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = os.path.join(BUILD_ROOT, _digest())
    so = os.path.join(out_dir, "libalphafive_kernels.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
                for src in _SOURCES]
        _run([[nvcc, *FLAGS, "-c", "-o", obj, src]
              for src, obj in zip(_SOURCES, objs)], out_dir)
        tmp = f"{so}.{tag}.tmp"
        _run([[nvcc, "-shared", "-o", tmp, *objs]], out_dir)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _bind(lib)
    _lib = lib
    return lib
