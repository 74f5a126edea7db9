"""Builds the CUDA kernels of ops/csrc with nvcc and loads them with ctypes.

Each source file compiles on first use into a shared library with a plain C
interface, under ``ops/_build/<name>-<hash>/``; the hash covers the
source, the shared headers (``csrc/*.cuh``) and the compiler flags
(macros included: one library per value of LANES), so an edited source
rebuilds and an unchanged one loads the library already built.  The build
log (with ``-Xptxas -v``'s register and spill report) is kept beside the
library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
# sm_90a: Hopper with its architecture-specific features.  FMA contraction
# is off, so each kernel rounds operation for operation like its plain
# PyTorch version (a*b+c as two roundings).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false")


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _flags(defines):
    """nvcc's flags for a build with the macros ``defines``."""
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _digest(src_path, flags):
    """Hash of the source, every header of csrc/ and the flags."""
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    h = hashlib.sha256()
    for path in [src_path, *headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name, defines=()):
    src = os.path.join(CSRC, name + ".cu")
    out_dir = os.path.join(
        BUILD_DIR, f"{name}-{_digest(src, _flags(defines))}")
    return src, out_dir, os.path.join(out_dir, f"lib{name}.so")


@functools.cache
def load(name, defines=()):
    """The ctypes handle of csrc/<name>.cu built with the macros
    ``defines`` (a tuple of NAME or NAME=VALUE), compiled first if needed.
    Raises RuntimeError with nvcc's output when the build fails."""
    src, out_dir, lib = library_path(name, defines)
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        start = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *_flags(defines), "-o", tmp, src],
            capture_output=True, text=True)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
        with _builds_lock:    # builds run in threads (chip_smoke.build_all)
            load.builds += 1
            load.build_s += time.perf_counter() - start
    return ctypes.CDLL(lib)


# nvcc runs since the count was last reset: lets a run show that a scene's
# changes (thrown balls) ask for no new build.  load.cache_info().misses
# counts the libraries loaded; load.build_s sums the runs' seconds (the
# bench reports it beside each configuration's first frame).
load.builds = 0
load.build_s = 0.0
_builds_lock = threading.Lock()


def build_log(name, defines=()):
    """nvcc's output from that build of csrc/<name>.cu ('' if not built
    here)."""
    _, out_dir, _ = library_path(name, defines)
    path = os.path.join(out_dir, "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
