"""IVF inverted lists: the tile-padded CSR layout and the probe schedule.

Ports ``retrieval_scaling_tpu/index/ivf_common.py``:

* ``IVFListLayout`` / ``build_list_layout`` (host numpy): vectors sorted by
  their list, each list padded to whole 128-row tiles, so the lists are one
  dense ``[total_tiles, 128, D]`` array plus per-list ``(tile_start,
  tile_count)``. The same arrays as the JAX package's, built without its
  per-list loop;
* ``default_max_tiles``: the static probe budget;
* ``select_probes`` and ``probe_tile_schedule`` (torch, on the queries'
  device): the top-nprobe lists by inner product, flattened into a
  ``[B, max_tiles]`` tile schedule in centroid-score order;
* ``ivf_scan_topk``: the plain IVF-Flat scan (gather a group of tiles, score
  in f32, running top-k). The CUDA path is ``ops.ivf_gather``'s K4.

Probe selection and scoring take their f32 products in full f32, PyTorch's
default; TF32 would tie-break true neighbours away.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from retrieval_scaling_tpu_torch.ops.ivf_gather import TILE
from retrieval_scaling_tpu_torch.ops.topk import NEG_INF, merge_topk


class IVFListLayout(NamedTuple):
    """Host-built tiled CSR layout (numpy; device placement by the index)."""

    sorted_rows: np.ndarray    # [total_rows, D] list-sorted, tile-padded
    row_flat_ids: np.ndarray   # [total_rows] original flat id or -1 for pad
    tile_start: np.ndarray     # [nlist] first tile of each list
    tile_count: np.ndarray     # [nlist] tiles in each list
    list_len: np.ndarray       # [nlist] real rows in each list


def build_list_layout(data: np.ndarray, assignments: np.ndarray, nlist: int, tile: int = TILE) -> IVFListLayout:
    n, d = data.shape
    assignments = np.asarray(assignments)
    order = np.argsort(assignments, kind="stable")
    sorted_assign = assignments[order]
    list_len = np.bincount(sorted_assign, minlength=nlist).astype(np.int64)
    tile_count = np.maximum((list_len + tile - 1) // tile, 0).astype(np.int32)
    tile_start = np.zeros(nlist, np.int32)
    tile_start[1:] = np.cumsum(tile_count)[:-1].astype(np.int32)
    total_tiles = int(tile_count.sum())

    sorted_rows = np.zeros((max(total_tiles, 1) * tile, d), data.dtype)
    row_flat_ids = np.full(max(total_tiles, 1) * tile, -1, np.int64)
    # row i of `order` goes to its list's first row plus its rank in the list
    first_in_order = np.concatenate([[0], np.cumsum(list_len)[:-1]])
    dst = tile_start[sorted_assign].astype(np.int64) * tile + (np.arange(n) - first_in_order[sorted_assign])
    sorted_rows[dst] = data[order]
    row_flat_ids[dst] = order
    return IVFListLayout(sorted_rows, row_flat_ids, tile_start, tile_count, list_len)


def default_max_tiles(list_len: np.ndarray, nprobe: int, tile: int = TILE, slack: float = 1.5) -> int:
    """Static probe budget: slack x the expected tiles of nprobe average lists."""
    tiles_per_list = np.maximum((list_len + tile - 1) // tile, 1)
    mean_tiles = float(tiles_per_list.mean()) if len(tiles_per_list) else 1.0
    budget = int(np.ceil(nprobe * mean_tiles * slack))
    cap = int(tiles_per_list.sum())
    return max(1, min(budget, cap))


def select_probes(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coarse scores [B, P] f32, list ids [B, P] int32) of the top-nprobe
    centroids by inner product (FAISS's IP quantizer)."""
    scores = queries.float() @ centroids.float().T
    coarse, ids = torch.topk(scores, min(nprobe, centroids.shape[0]), dim=-1)
    return coarse, ids.to(torch.int32)


def probe_tile_schedule(
    probe_ids: torch.Tensor,   # [B, nprobe]
    tile_start: torch.Tensor,  # [nlist]
    tile_count: torch.Tensor,  # [nlist]
    max_tiles: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten the probed lists into per-query tile ids.

    Returns (tile_ids [B, max_tiles] int32, valid [B, max_tiles] bool,
    probe_of_tile [B, max_tiles] int32: the probe slot each tile belongs to).
    """
    probe = probe_ids.long()
    counts = tile_count.long()[probe]                      # [B, P]
    starts = tile_start.long()[probe]
    cum = torch.cumsum(counts, dim=1)                      # inclusive
    cum_prev = cum - counts
    total = cum[:, -1]
    j = torch.arange(max_tiles, device=probe.device).expand(probe.shape[0], max_tiles).contiguous()
    seg = torch.searchsorted(cum, j, right=True)           # probes fully before slot j
    seg_c = seg.clamp_max(probe.shape[1] - 1)
    tile_ids = torch.gather(starts, 1, seg_c) + j - torch.gather(cum_prev, 1, seg_c)
    valid = j < total[:, None]
    return (
        torch.where(valid, tile_ids, 0).to(torch.int32),
        valid,
        torch.where(valid, seg_c, 0).to(torch.int32),
    )


def ivf_scan_topk(
    queries: torch.Tensor,       # [B, D]
    tiles: torch.Tensor,         # [total_tiles, TILE, D]
    row_flat_ids: torch.Tensor,  # [total_tiles * TILE] (-1 = pad)
    tile_ids: torch.Tensor,      # [B, max_tiles]
    tile_valid: torch.Tensor,    # [B, max_tiles]
    k: int,
    group: int = 8,
    tile_row_scales: torch.Tensor | None = None,  # [total_tiles, TILE] f32 (int8 tiles)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain IVF-Flat scan: stream probed tiles ``group`` at a time, score in
    f32 (the query rounded to the tiles' type, kept f32 for int8 tiles), keep
    a running top-k. Returns (scores [B, k], flat ids [B, k] int64; -1 where
    exhausted)."""
    if queries.is_cuda:
        ivf_scan_topk.cuda_calls += 1
    b = queries.shape[0]
    max_tiles = tile_ids.shape[1]
    n_groups = -(-max_tiles // group)
    pad = n_groups * group - max_tiles
    if pad:
        tile_ids = torch.nn.functional.pad(tile_ids, (0, pad))
        tile_valid = torch.nn.functional.pad(tile_valid, (0, pad))
    qf = queries.to(torch.float32 if tiles.dtype == torch.int8 else tiles.dtype).float()
    row_ids_tiled = row_flat_ids.reshape(-1, TILE)
    k_eff = min(k, n_groups * group * TILE)
    best_s = torch.full((b, k_eff), NEG_INF, dtype=torch.float32, device=queries.device)
    best_i = torch.full((b, k_eff), -1, dtype=torch.int64, device=queries.device)
    for g0 in range(0, n_groups * group, group):
        ids_g = tile_ids[:, g0 : g0 + group].long()
        valid_g = tile_valid[:, g0 : g0 + group]
        s = torch.einsum("bd,bgtd->bgt", qf, tiles[ids_g].float())
        if tile_row_scales is not None:
            s = s * tile_row_scales[ids_g]
        rows = row_ids_tiled[ids_g]
        ok = valid_g[:, :, None] & (rows >= 0)
        s = torch.where(ok, s, NEG_INF).reshape(b, group * TILE)
        flat_rows = torch.where(ok, rows, -1).reshape(b, group * TILE).long()
        c_s, c_pos = torch.topk(s, min(k_eff, group * TILE), dim=-1)
        best_s, best_i = merge_topk(best_s, best_i, c_s, torch.gather(flat_rows, -1, c_pos), k_eff)
    if k_eff < k:
        best_s = torch.nn.functional.pad(best_s, (0, k - k_eff), value=NEG_INF)
        best_i = torch.nn.functional.pad(best_i, (0, k - k_eff), value=-1)
    return best_s, best_i


ivf_scan_topk.cuda_calls = 0
