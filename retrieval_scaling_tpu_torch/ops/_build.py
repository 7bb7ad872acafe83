"""Build the hand-written CUDA kernels of ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` (Hopper) into ``<repo>/build/lib<name>.so`` at first
use, from the repo's sources only. The library is rebuilt when its source is
newer. Nothing here runs at import time: the CPU tests import every module
on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build")

# --split-compile=0 runs the device compiler's optimisation passes on every
# core: flash_attn_fwd.cu holds 128 kernel instances, the longest build
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
]

_LIBS: dict = {}
# name -> {"seconds": float, "ptxas": str} for libraries compiled in this process
BUILD_LOG: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def build_all(names, force: bool = False) -> dict:
    """Compile several ``csrc/<name>.cu`` at once, one nvcc each, all started
    together; returns {name: library path}. A library newer than its source
    is kept unless ``force``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    libs, running = {}, {}
    for name in names:
        src = os.path.join(CSRC_DIR, name + ".cu")
        lib = libs[name] = os.path.join(BUILD_DIR, f"lib{name}.so")
        if not force and os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running[name] = (proc, src, tmp, time.perf_counter())
    failed = []
    for name, (proc, src, tmp, t0) in running.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{out}\n{err}")
            continue
        os.replace(tmp, libs[name])
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": err}
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str, force: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so``; returns its path."""
    return build_all([name], force)[name]


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, building it first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(build(name))
    return _LIBS[name]
