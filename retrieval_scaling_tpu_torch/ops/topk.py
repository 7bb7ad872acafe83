"""Exact inner-product top-k over a datastore, scanned in chunks.

Ports ``chunked_topk_scores``, ``merge_topk`` and ``pick_chunk_size`` of
``retrieval_scaling_tpu/ops/topk.py``. The JAX package leaves this to XLA
(a matmul and ``lax.top_k`` per chunk, no Pallas kernel), so here it is a
cuBLAS product with f32 scores plus ``torch.topk`` per chunk, with a running
top-k merged across chunks. The SQ8 int8 datastore and ``approx_recall``
are not ported yet.
"""

from __future__ import annotations

import torch

from retrieval_scaling_tpu_torch.ops.matmul import matmul_f32

NEG_INF = -1e30


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Top-k of the union of two per-query candidate sets ([B, Ka], [B, Kb])."""
    scores = torch.cat([scores_a, scores_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    top_scores, pos = torch.topk(scores, k, dim=-1)
    return top_scores, torch.gather(ids, -1, pos)


def chunked_topk_scores(
    queries: torch.Tensor,   # [B, D]
    database: torch.Tensor,  # [N_pad, D] (rows >= n_valid are padding)
    n_valid: int,
    k: int,
    chunk_size: int = 1 << 20,
):
    """(scores [B, k] f32, row ids [B, k] int64) of the best inner products.

    Padding rows score NEG_INF and never surface; when fewer than k rows
    exist the tail is (NEG_INF, -1), as in the JAX package.
    """
    n_pad = database.shape[0]
    b = queries.shape[0]
    chunk_size = min(chunk_size, n_pad)
    q = queries.to(database.dtype)
    k_carry = min(k, n_pad)
    best_s = torch.full((b, k_carry), NEG_INF, dtype=torch.float32, device=database.device)
    best_i = torch.full((b, k_carry), -1, dtype=torch.int64, device=database.device)
    for base in range(0, n_pad, chunk_size):
        chunk = database[base : base + chunk_size]
        scores = matmul_f32(q, chunk.t())  # [B, C]
        col = torch.arange(chunk.shape[0], device=database.device)
        scores = scores.masked_fill((base + col >= n_valid)[None, :], NEG_INF)
        c_s, c_pos = torch.topk(scores, min(k, chunk.shape[0]), dim=-1)
        c_i = torch.where(c_s > NEG_INF / 2, base + c_pos, torch.full_like(c_pos, -1))
        best_s, best_i = merge_topk(best_s, best_i, c_s, c_i, k_carry)
    if k_carry < k:
        pad = k - k_carry
        best_s = torch.nn.functional.pad(best_s, (0, pad), value=NEG_INF)
        best_i = torch.nn.functional.pad(best_i, (0, pad), value=-1)
    return best_s, best_i


def pick_chunk_size(
    n_rows: int, batch: int, score_budget_bytes: int = 256 << 20, align: int = 128
) -> int:
    """Largest chunk whose [B, C] f32 score buffer stays within budget."""
    cap = max(score_budget_bytes // (4 * max(batch, 1)), align)
    chunk = min(n_rows, cap)
    return max(align, chunk - chunk % align)
