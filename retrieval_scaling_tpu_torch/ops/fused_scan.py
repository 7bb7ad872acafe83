"""The fused exact-MIPS scan: K11 (segment maxima) plus a K4 re-score.

Ports ``retrieval_scaling_tpu/ops/fused_scan.py``. Its Pallas kernel
``_segmax_kernel`` becomes the CUDA C++ kernel of ``csrc/fused_scan.cu``
(built for ``sm_90a``, bound with ctypes):

* ``segmax_scan`` (K11): per query, the max f32 score of each 128-row
  segment of the database, rows >= ``n_valid`` masked to NEG_INF; the
  [B, N] score matrix never reaches device memory;
* ``flat_topk_fused``: exact top-k in two passes. Pass 1 is K11; pass 2
  takes each query's top-k segments and re-scores those tiles with K4
  (``ops/ivf_gather.gather_score_tiles``), as the JAX function does. Every
  row scoring above the k-th best lies in a kept segment, so the result is
  exact (``exact_topk_2stage`` of the JAX ``ops/topk.py`` argues it).

As in the JAX package, no index calls these: the Flat index scans with
``ops/topk.chunked_topk_scores``. The wrapper takes the plain version
(``segmax_scan_reference``) only for tensors on the CPU; a CUDA tensor
launches the kernel or raises. ``segmax_scan.launches`` counts launches and
``segmax_scan_reference.cuda_calls`` the plain version's calls on CUDA
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from retrieval_scaling_tpu_torch.ops.ivf_gather import gather_score_tiles

SEG = 128        # segment width (= the gather kernel's tile)
BLOCK = 2048     # database rows per CTA (per grid step on the TPU)
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def segmax_scan_reference(queries: torch.Tensor, database: torch.Tensor, n_valid: int,
                          chunk: int = 1 << 16) -> torch.Tensor:
    """[B, N_pad // SEG] f32: the f32 product chunk by chunk, the mask,
    then the max of each segment. ``queries`` are rounded to the database's
    type already."""
    if database.is_cuda:
        segmax_scan_reference.cuda_calls += 1
    b, n_pad = queries.shape[0], database.shape[0]
    q = queries.float()
    out = torch.empty((b, n_pad // SEG), dtype=torch.float32, device=database.device)
    for base in range(0, n_pad, chunk):
        rows = database[base : base + chunk]
        scores = q @ rows.float().t()
        col = base + torch.arange(rows.shape[0], device=database.device)
        scores = scores.masked_fill((col >= n_valid)[None, :], NEG_INF)
        out[:, base // SEG : (base + rows.shape[0]) // SEG] = scores.view(b, -1, SEG).amax(-1)
    return out


segmax_scan_reference.cuda_calls = 0


def _library():
    from retrieval_scaling_tpu_torch.ops._build import load_library

    lib = load_library("fused_scan")
    if not getattr(lib, "_fused_bound", False):
        lib.fused_segmax_scan.restype = ctypes.c_int
        lib.fused_segmax_scan.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib._fused_bound = True
    return lib


def _segmax_kernel(q: torch.Tensor, database: torch.Tensor, n_valid: int) -> torch.Tensor:
    if database.dtype not in _DTYPES:
        raise TypeError(f"database dtype {database.dtype} not supported by the kernel")
    if database.dim() != 2 or not database.is_contiguous():
        raise ValueError(f"database must be contiguous [N_pad, D], got {tuple(database.shape)}")
    n_pad, d = database.shape
    if d % (4 if database.dtype == torch.float32 else 8):
        raise ValueError(f"a row of D={d} {database.dtype} is not a whole number of 16-byte pieces")
    b = q.shape[0]
    if q.shape != (b, d) or q.dtype != database.dtype or not q.is_contiguous() or q.device != database.device:
        raise ValueError(f"queries must be contiguous {database.dtype} [B, {d}] on {database.device}")
    out = torch.empty((b, n_pad // SEG), dtype=torch.float32, device=database.device)
    if b == 0:
        return out
    err = _library().fused_segmax_scan(
        q.data_ptr(), database.data_ptr(), out.data_ptr(), b, d, n_pad, max(0, min(int(n_valid), n_pad)),
        _DTYPES[database.dtype], torch.cuda.current_stream(database.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_segmax_scan launch failed with CUDA error {err}")
    return out


def segmax_scan(queries: torch.Tensor, database: torch.Tensor, n_valid: int) -> torch.Tensor:
    """K11: segment maxima [B, N_pad // SEG] f32 (segments past ``n_valid``
    hold NEG_INF). ``N_pad`` must be a multiple of BLOCK. The queries are
    rounded to the database's type first, as the TPU kernel's caller does."""
    if database.shape[0] % BLOCK:
        raise ValueError(f"database rows {database.shape[0]} are not a multiple of BLOCK={BLOCK}")
    q = queries.to(database.dtype).contiguous()
    if database.device.type == "cpu":
        return segmax_scan_reference(q, database, int(n_valid))
    out = _segmax_kernel(q, database, n_valid)
    segmax_scan.launches += 1
    return out


segmax_scan.launches = 0


def flat_topk_fused(queries: torch.Tensor, database: torch.Tensor, n_valid: int, k: int):
    """Exact (scores [B, k] f32, row ids [B, k] int64) over the database
    ([N_pad, D], N_pad a multiple of BLOCK); the tail is (NEG_INF, -1)
    where fewer than k rows exist."""
    b, d = queries.shape
    n_seg = database.shape[0] // SEG
    n_valid = int(n_valid)

    seg_max = segmax_scan(queries, database, n_valid)               # [B, n_seg]
    k_seg = min(k, n_seg)
    _, seg_ids = torch.topk(seg_max, k_seg, dim=-1)                  # [B, k_seg]

    tiles = database.view(n_seg, SEG, d)
    scores = gather_score_tiles(queries, tiles, seg_ids.to(torch.int32).contiguous())  # [B, k_seg, SEG]
    rows = seg_ids[:, :, None] * SEG + torch.arange(SEG, device=database.device)
    ok = rows < n_valid
    flat_scores = torch.where(ok, scores, NEG_INF).reshape(b, k_seg * SEG)
    flat_rows = torch.where(ok, rows, -1).reshape(b, k_seg * SEG)

    kk = min(k, k_seg * SEG)
    c_s, c_pos = torch.topk(flat_scores, kk, dim=-1)
    c_i = torch.gather(flat_rows, -1, c_pos)
    if kk < k:
        c_s = torch.nn.functional.pad(c_s, (0, k - kk), value=NEG_INF)
        c_i = torch.nn.functional.pad(c_i, (0, k - kk), value=-1)
    return c_s, c_i
