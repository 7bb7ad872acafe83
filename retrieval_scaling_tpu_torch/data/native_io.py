"""ctypes loader for the native host reader (``native/rstpu_io.cpp``).

Ports the part of ``retrieval_scaling_tpu/data/native_io.py`` that the
IVF-PQ host refine uses: ``pread_lines_native``, many byte spans of one file
read with threaded ``pread``s. The library is compiled with g++ at first use
into the git-ignored ``build/`` (the JAX module writes it beside its source).
When no compiler is available the callers fall back to plain seek/read; that
is host I/O, not a device path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from retrieval_scaling_tpu_torch.ops._build import BUILD_DIR

logger = logging.getLogger(__name__)

SOURCE = os.path.join(os.path.dirname(BUILD_DIR), "native", "rstpu_io.cpp")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_library(src: str, out: str) -> bool:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("native build failed (%s); using plain reads", e)
        return False
    os.replace(tmp, out)
    return True


def get_library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built here."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = os.path.join(BUILD_DIR, "librstpu_io.so")
        if not os.path.exists(SOURCE):
            return None
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(SOURCE):
            if not _build_library(SOURCE, so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            logger.warning("failed to load %s: %s", so, e)
            return None
        lib.rstpu_pread_many.restype = ctypes.c_int
        lib.rstpu_pread_many.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def pread_lines_native(
    path: str,
    spans: Sequence[Tuple[int, int]],  # (start, length) per record
    threads: int = 16,
) -> Optional[List[bytes]]:
    """Read many byte spans from one file with threaded preads; None when
    the library is unavailable or a read fails."""
    lib = get_library()
    if lib is None or not spans:
        return None
    n = len(spans)
    starts = np.asarray([s for s, _ in spans], np.int64)
    lens = np.asarray([length for _, length in spans], np.int64)
    out_offsets = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=out_offsets[1:])
    buf = ctypes.create_string_buffer(int(lens.sum()))
    rc = lib.rstpu_pread_many(
        path.encode(),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        buf,
        n,
        threads,
    )
    if rc != 0:
        return None
    raw = buf.raw
    return [raw[int(o) : int(o + length)] for o, length in zip(out_offsets, lens)]
