"""The read-only weight-stream probe: the hand-written Hopper kernel K13.

Ports the touch kernel of ``bench.py`` (``_touch_kernel`` / ``dma_pass``):
the time one pass over a decode step's weight buffers takes when nothing
else is done with them, the device-memory floor that a decode step is held
against. ``stream_probe`` launches ``csrc/stream_probe.cu`` once over a list
of CUDA buffers and returns the sum of all their bytes (so no load can be
elided); ``stream_probe_reference`` is its plain version, a torch reduction
over the same bytes. ``stream_floor`` times the kernel with CUDA events and
returns ms and GB/s. ``stream_probe.launches`` counts kernel launches,
``stream_probe_reference.cuda_calls`` the plain version's calls on CUDA
tensors.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List

import torch

_CHUNK_BYTES = 1 << 20
_CTAS = 132 * 8  # eight CTAs of 256 threads for each of the H100's 132 SMs


def _byte_views(buffers: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    views = []
    for t in buffers:
        if not t.is_contiguous():
            raise ValueError(f"buffer of shape {tuple(t.shape)} is not contiguous")
        views.append(t.reshape(-1).view(torch.uint8))
    return views


def stream_probe_reference(buffers: Iterable[torch.Tensor]) -> int:
    """K13's plain version: the sum of every byte of ``buffers``."""
    views = _byte_views(buffers)
    if any(v.is_cuda for v in views):
        stream_probe_reference.cuda_calls += 1
    return int(sum(int(v.sum(dtype=torch.int64)) for v in views))


stream_probe_reference.cuda_calls = 0


def _chunk_table(views: List[torch.Tensor], device) -> torch.Tensor:
    rows = []
    for v in views:
        n = v.numel()
        if n % 16 or v.data_ptr() % 16:
            raise ValueError(f"K13 reads 16-byte units: a buffer of {n} bytes at {v.data_ptr():#x} does not fit")
        for off in range(0, n, _CHUNK_BYTES):
            rows.append((v.data_ptr() + off, min(_CHUNK_BYTES, n - off) // 16))
    return torch.tensor(rows, dtype=torch.int64).to(device)


class _Probe:
    """A prepared launch: the chunk table and the output live on the card."""

    def __init__(self, buffers: Iterable[torch.Tensor]):
        self.views = _byte_views(buffers)
        if not self.views:
            raise ValueError("no buffers")
        self.device = self.views[0].device
        for v in self.views:
            if not v.is_cuda or v.device != self.device:
                raise ValueError(f"every buffer must be on {self.device}")
        self.bytes = sum(v.numel() for v in self.views)
        self.table = _chunk_table(self.views, self.device)
        self.ctas = min(_CTAS, self.table.shape[0])
        self.out = torch.empty((self.ctas,), dtype=torch.int64, device=self.device)
        from retrieval_scaling_tpu_torch.ops._build import load_library

        self.fn = load_library("stream_probe").stream_probe
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

    def launch(self) -> torch.Tensor:
        err = self.fn(self.table.data_ptr(), self.table.shape[0], self.out.data_ptr(), self.ctas,
                      torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"stream_probe launch failed with CUDA error {err}")
        stream_probe.launches += 1
        return self.out


def stream_probe(buffers: Iterable[torch.Tensor]) -> int:
    """K13 wrapper: one launch reading every byte of ``buffers`` once; the
    sum of their bytes. CPU tensors take ``stream_probe_reference``."""
    buffers = list(buffers)
    if buffers and buffers[0].device.type == "cpu":
        return stream_probe_reference(buffers)
    return int(_Probe(buffers).launch().sum())


stream_probe.launches = 0


def stream_floor(buffers: Iterable[torch.Tensor], reps: int = 10, warmup: int = 2) -> dict:
    """Time K13 over ``buffers`` with CUDA events: ms per pass, GB/s, bytes
    and the byte sum. Needs the card: the floor is a device number."""
    buffers = list(buffers)
    if not buffers or not buffers[0].is_cuda:
        raise ValueError("stream_floor measures the card: give it CUDA buffers")
    probe = _Probe(buffers)
    for _ in range(warmup):
        probe.launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = probe.launch()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    return {"ms": ms, "gb_per_s": probe.bytes / ms / 1e6, "bytes": probe.bytes, "checksum": int(out.sum())}
