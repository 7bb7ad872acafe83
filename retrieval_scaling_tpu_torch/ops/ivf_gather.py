"""IVF probed-tile scans: the hand-written Hopper kernels K4, K12, K5a, K5b
and their plain versions.

Ports ``retrieval_scaling_tpu/ops/ivf_gather.py``. Its Pallas kernels become
CUDA C++ kernels in ``csrc/ivf_gather.cu`` (built for ``sm_90a``, bound with
ctypes):

* ``gather_score_tiles`` (K4) and ``gather_score_tiles_grouped`` (K12):
  scores [B, T, 128] f32 of query b against every row of its probed tiles
  ``tiles[tile_ids[b, t]]`` ([T_total, 128, D] bf16, f32 or int8);
* ``gather_adc_tiles`` (K5a) and ``gather_adc_tiles_grouped`` (K5b): ADC
  scores [B, T, 128] f32, ``sum_s lut[b, s, codes[tile_ids[b, t], r, s]]``
  over code tiles kept in the on-disk row layout [T_total, 128, m] uint8;
* ``ivf_scan_topk_tiles`` and ``pq_scan_topk_tiles``, the counterparts of
  ``ivf_scan_topk_pallas`` and ``pq_scan_topk_pallas``: map invalid slots to
  tile 0, launch a kernel, apply the SQ8 row scales or the coarse term of
  each tile's probe, mask, and take ``torch.topk`` over [B, T * 128].

A wrapper takes the plain version (``gather_score_tiles_reference``,
``gather_adc_tiles_reference``) only for tensors on the CPU; a CUDA tensor
launches its kernel or raises. Each wrapper counts its launches
(``.launches``) and each plain version its calls on CUDA tensors
(``.cuda_calls``), which the search path must leave at 0.

Not carried over (TPU workarounds): the one-hot row select of ``_kernel``,
the lo/hi split of the LUT (``pq_lut_tables``), the sublane-padded
transposed code layout (``pq_sublane_pad`` / ``transpose_code_tiles``) and
the two-stage exact top-k (``exact_topk_2stage``).
"""

from __future__ import annotations

import ctypes

import torch

from retrieval_scaling_tpu_torch.ops.topk import NEG_INF

TILE = 128
FL_TG = 4  # tiles per K12 program
PQ_TG = 8  # tiles per K5b program

_TILE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


# ---------------------------------------------------------------- plain versions
def gather_score_tiles_reference(q: torch.Tensor, tiles: torch.Tensor, tile_ids: torch.Tensor,
                                 group: int = 8) -> torch.Tensor:
    """[B, T, TILE] f32: ``q`` (f32 [B, D]) against every row of the probed
    tiles, gathered ``group`` slots at a time. The body of
    ``ivf_common.ivf_scan_topk`` without its top-k."""
    if q.is_cuda:
        gather_score_tiles_reference.cuda_calls += 1
    b, t = tile_ids.shape
    out = torch.empty((b, t, TILE), dtype=torch.float32, device=q.device)
    for g0 in range(0, t, group):
        gathered = tiles[tile_ids[:, g0 : g0 + group].long()].float()  # [B, g, TILE, D]
        out[:, g0 : g0 + group] = torch.einsum("bd,bgrd->bgr", q.float(), gathered)
    return out


gather_score_tiles_reference.cuda_calls = 0


def gather_adc_tiles_reference(lut: torch.Tensor, codes: torch.Tensor, tile_ids: torch.Tensor,
                               group: int = 4) -> torch.Tensor:
    """[B, T, TILE] f32 ADC scores: the ``gather`` branch of
    ``ivf_pq.pq_scan_topk`` without its coarse term and top-k."""
    if lut.is_cuda:
        gather_adc_tiles_reference.cuda_calls += 1
    b, m, ksub = lut.shape
    t = tile_ids.shape[1]
    out = torch.empty((b, t, TILE), dtype=torch.float32, device=lut.device)
    for g0 in range(0, t, group):
        idx = codes[tile_ids[:, g0 : g0 + group].long()].long()  # [B, g, TILE, m]
        table = lut.float()[:, None, None].expand(*idx.shape, ksub)
        out[:, g0 : g0 + group] = torch.gather(table, -1, idx[..., None])[..., 0].sum(-1)
    return out


gather_adc_tiles_reference.cuda_calls = 0


# ---------------------------------------------------------------- kernel launches
def _library():
    from retrieval_scaling_tpu_torch.ops._build import load_library

    lib = load_library("ivf_gather")
    if not getattr(lib, "_ivf_bound", False):
        lib.ivf_score_tiles.restype = ctypes.c_int
        lib.ivf_score_tiles.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ivf_adc_tiles.restype = ctypes.c_int
        lib.ivf_adc_tiles.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib._ivf_bound = True
    return lib


def _check_ids(tile_ids: torch.Tensor, device: torch.device) -> None:
    if tile_ids.dtype != torch.int32 or not tile_ids.is_contiguous() or tile_ids.device != device:
        raise ValueError(f"tile_ids must be contiguous int32 on {device}")


def _score_kernel(q: torch.Tensor, tiles: torch.Tensor, tile_ids: torch.Tensor, grouped: bool) -> torch.Tensor:
    if tiles.dim() != 3 or tiles.shape[1] != TILE or not tiles.is_contiguous():
        raise ValueError(f"tiles must be contiguous [T_total, {TILE}, D], got {tuple(tiles.shape)}")
    if tiles.dtype not in _TILE_DTYPES:
        raise TypeError(f"tile dtype {tiles.dtype} not supported by the kernel")
    d = tiles.shape[2]
    if (d * tiles.element_size()) % 16:
        raise ValueError(f"a tile row of D={d} {tiles.dtype} is not a whole number of 16-byte pieces")
    b, t = tile_ids.shape
    if q.shape != (b, d) or q.dtype != torch.float32 or not q.is_contiguous() or q.device != tiles.device:
        raise ValueError(f"q must be contiguous f32 [{b}, {d}] on {tiles.device}")
    _check_ids(tile_ids, tiles.device)
    out = torch.empty((b, t, TILE), dtype=torch.float32, device=tiles.device)
    if b * t == 0:
        return out
    err = _library().ivf_score_tiles(
        q.data_ptr(), tiles.data_ptr(), tile_ids.data_ptr(), out.data_ptr(),
        b, t, tiles.shape[0], d, _TILE_DTYPES[tiles.dtype], int(grouped),
        torch.cuda.current_stream(tiles.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ivf_score_tiles launch failed with CUDA error {err}")
    return out


def _adc_kernel(lut: torch.Tensor, codes: torch.Tensor, tile_ids: torch.Tensor, grouped: bool) -> torch.Tensor:
    b, m, ksub = lut.shape
    if codes.dim() != 3 or codes.shape[1:] != (TILE, m) or codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous uint8 [T_total, {TILE}, {m}], got {tuple(codes.shape)} {codes.dtype}")
    if lut.dtype != torch.float32 or not lut.is_contiguous() or lut.device != codes.device:
        raise ValueError(f"lut must be contiguous f32 on {codes.device}")
    if ksub > 256 or (m * ksub) % 4:
        raise ValueError(f"the kernel takes ksub <= 256 and m * ksub a multiple of 4 (m={m}, ksub={ksub})")
    _check_ids(tile_ids, codes.device)
    t = tile_ids.shape[1]
    if tile_ids.shape[0] != b:
        raise ValueError(f"tile_ids rows {tile_ids.shape[0]} != LUT rows {b}")
    out = torch.empty((b, t, TILE), dtype=torch.float32, device=codes.device)
    if b * t == 0:
        return out
    err = _library().ivf_adc_tiles(
        lut.data_ptr(), codes.data_ptr(), tile_ids.data_ptr(), out.data_ptr(),
        b, t, codes.shape[0], m, ksub, int(grouped),
        torch.cuda.current_stream(codes.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ivf_adc_tiles launch failed with CUDA error {err}")
    return out


# ---------------------------------------------------------------- wrappers
def gather_score_tiles(queries: torch.Tensor, tiles: torch.Tensor, tile_ids: torch.Tensor) -> torch.Tensor:
    """K4: scores [B, T, TILE] f32. The query is rounded to the tiles' type
    first (kept f32 for int8 tiles), as the TPU kernel's caller does.
    ``tile_ids`` must be in range (invalid slots pointed at tile 0)."""
    q = queries.to(torch.float32 if tiles.dtype == torch.int8 else tiles.dtype).float().contiguous()
    if tiles.device.type == "cpu":
        return gather_score_tiles_reference(q, tiles, tile_ids)
    out = _score_kernel(q, tiles, tile_ids, grouped=False)
    gather_score_tiles.launches += 1
    return out


gather_score_tiles.launches = 0


def gather_score_tiles_grouped(queries: torch.Tensor, tiles: torch.Tensor, tile_ids: torch.Tensor) -> torch.Tensor:
    """K12: K4 over FL_TG tiles per program (T % FL_TG == 0). The query
    stays f32, as in the TPU kernel's call."""
    if tile_ids.shape[1] % FL_TG:
        raise ValueError(f"T={tile_ids.shape[1]} is not a multiple of {FL_TG}")
    q = queries.float().contiguous()
    if tiles.device.type == "cpu":
        return gather_score_tiles_reference(q, tiles, tile_ids)
    out = _score_kernel(q, tiles, tile_ids, grouped=True)
    gather_score_tiles_grouped.launches += 1
    return out


gather_score_tiles_grouped.launches = 0


def gather_adc_tiles(lut: torch.Tensor, codes: torch.Tensor, tile_ids: torch.Tensor) -> torch.Tensor:
    """K5a: ADC scores [B, T, TILE] f32 of each query's probed code tiles."""
    lut = lut.float().contiguous()
    if codes.device.type == "cpu":
        return gather_adc_tiles_reference(lut, codes, tile_ids)
    out = _adc_kernel(lut, codes, tile_ids, grouped=False)
    gather_adc_tiles.launches += 1
    return out


gather_adc_tiles.launches = 0


def gather_adc_tiles_grouped(lut: torch.Tensor, codes: torch.Tensor, tile_ids: torch.Tensor) -> torch.Tensor:
    """K5b: K5a over PQ_TG tiles per program (T % PQ_TG == 0)."""
    if tile_ids.shape[1] % PQ_TG:
        raise ValueError(f"T={tile_ids.shape[1]} is not a multiple of {PQ_TG}")
    lut = lut.float().contiguous()
    if codes.device.type == "cpu":
        return gather_adc_tiles_reference(lut, codes, tile_ids)
    out = _adc_kernel(lut, codes, tile_ids, grouped=True)
    gather_adc_tiles_grouped.launches += 1
    return out


gather_adc_tiles_grouped.launches = 0


def _pad_slots(multiple: int, *arrays: torch.Tensor):
    """Pad [B, T] schedules to a multiple of ``multiple`` slots with zeros
    (invalid slots: ``tile_valid`` pads with False)."""
    pad = -arrays[0].shape[1] % multiple
    if not pad:
        return arrays
    return tuple(torch.nn.functional.pad(a, (0, pad)) for a in arrays)


def _masked_topk(scores, row_flat_ids, safe_ids, tile_valid, k: int):
    b, t = safe_ids.shape
    rows = row_flat_ids.reshape(-1, TILE)[safe_ids.long()]  # [B, T, TILE]
    ok = tile_valid[:, :, None] & (rows >= 0)
    flat_scores = torch.where(ok, scores, NEG_INF).reshape(b, t * TILE)
    flat_rows = torch.where(ok, rows, -1).reshape(b, t * TILE).long()
    kk = min(k, t * TILE)
    c_s, c_pos = torch.topk(flat_scores, kk, dim=-1)
    c_i = torch.gather(flat_rows, -1, c_pos)
    if kk < k:
        c_s = torch.nn.functional.pad(c_s, (0, k - kk), value=NEG_INF)
        c_i = torch.nn.functional.pad(c_i, (0, k - kk), value=-1)
    return c_s, c_i


def ivf_scan_topk_tiles(
    queries: torch.Tensor,       # [B, D]
    tiles: torch.Tensor,         # [T_total, TILE, D]
    row_flat_ids: torch.Tensor,  # [T_total * TILE] (-1 = pad)
    tile_ids: torch.Tensor,      # [B, T]
    tile_valid: torch.Tensor,    # [B, T] bool
    k: int,
    grouped: bool = False,
    tile_row_scales: torch.Tensor | None = None,  # [T_total, TILE] f32 (int8 tiles)
):
    """IVF-Flat scan through K4 (or K12 with ``grouped``): (scores [B, k]
    f32, flat ids [B, k] int64; NEG_INF / -1 where fewer than k rows)."""
    if grouped:
        tile_ids, tile_valid = _pad_slots(FL_TG, tile_ids, tile_valid)
    safe_ids = torch.where(tile_valid, tile_ids, 0).to(torch.int32).contiguous()
    scan = gather_score_tiles_grouped if grouped else gather_score_tiles
    scores = scan(queries, tiles, safe_ids)
    if tile_row_scales is not None:  # SQ8 dequantisation, per row
        scores = scores * tile_row_scales[safe_ids.long()]
    return _masked_topk(scores, row_flat_ids, safe_ids, tile_valid, k)


def pq_scan_topk_tiles(
    lut: torch.Tensor,            # [B, m, ksub] f32
    coarse_scores: torch.Tensor,  # [B, nprobe]
    codes: torch.Tensor,          # [T_total, TILE, m] uint8
    row_flat_ids: torch.Tensor,   # [T_total * TILE]
    tile_ids: torch.Tensor,       # [B, T]
    tile_valid: torch.Tensor,     # [B, T]
    probe_of_tile: torch.Tensor,  # [B, T]
    k: int,
    grouped: bool = True,
):
    """IVF-PQ scan through K5b (or K5a without ``grouped``), plus each
    tile's coarse term q.c of its list."""
    if grouped:
        tile_ids, tile_valid, probe_of_tile = _pad_slots(PQ_TG, tile_ids, tile_valid, probe_of_tile)
    safe_ids = torch.where(tile_valid, tile_ids, 0).to(torch.int32).contiguous()
    scan = gather_adc_tiles_grouped if grouped else gather_adc_tiles
    adc = scan(lut, codes, safe_ids)
    coarse = torch.gather(coarse_scores.float(), 1, torch.where(tile_valid, probe_of_tile, 0).long())
    return _masked_topk(adc + coarse[:, :, None], row_flat_ids, safe_ids, tile_valid, k)
