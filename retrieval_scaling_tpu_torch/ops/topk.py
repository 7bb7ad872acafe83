"""Exact inner-product top-k over a datastore, scanned in chunks.

Ports ``chunked_topk_scores``, ``merge_topk`` and ``pick_chunk_size`` of
``retrieval_scaling_tpu/ops/topk.py``. The JAX package leaves this to XLA
(a matmul and ``lax.top_k`` per chunk, no Pallas kernel), so here it is a
cuBLAS product with f32 scores plus ``torch.topk`` per chunk, with a running
top-k merged across chunks.

The SQ8 int8 datastore (``row_scales``): the queries are row-quantized,
the product is int8 x int8 -> int32 (``torch._int_mm``, cuBLASLt on the
card; XLA's dot in the JAX package) and the scores are
``acc * q_scale * row_scale`` in JAX's order, with the query scale rounded
as XLA computes it, so both packages agree to the bit on the CPU. The int8 chunk is never widened on the card: that would
write four times the bytes SQ8 exists to halve.

``approx_recall`` is accepted and the top-k stays exact. In the JAX package
it selects ``lax.approx_max_k``, a TPU partial-reduction top-k; an exact
``torch.topk`` meets any recall target.
"""

from __future__ import annotations

import torch

from retrieval_scaling_tpu_torch.ops.matmul import matmul_f32
from retrieval_scaling_tpu_torch.ops.quant_matmul import _rowquant

NEG_INF = -1e30
# torch._int_mm (cuBLASLt) takes more than 16 rows; queries are padded to
# a multiple of 8 of at least this many zero rows and the result sliced back
INT_MM_MIN_ROWS = 32


def _sq8_queries(queries: torch.Tensor):
    """(int8 rows, f32 scales [B, 1]) of the queries: ``_rowquant`` as XLA
    compiles it inside the JAX ``chunked_topk_scores``, where the division of
    the row max by the constant 127 becomes a multiplication by its f32
    reciprocal (one rounding apart from the true division)."""
    x = queries.float()
    qq, _ = _rowquant(x)
    absmax = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    return qq, absmax * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)


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
    approx_recall: float | None = None,
    row_scales: torch.Tensor | None = None,  # [N_pad] f32 when database is int8
):
    """(scores [B, k] f32, row ids [B, k] int64) of the best inner products.

    Padding rows score NEG_INF and never surface; when fewer than k rows
    exist the tail is (NEG_INF, -1), as in the JAX package. An int8
    ``database`` needs its per-row ``row_scales``; its scores are
    dequantized, so they stay comparable across shards.
    """
    del approx_recall  # exact top-k meets any recall target (module docstring)
    n_pad, d = database.shape
    b = queries.shape[0]
    chunk_size = min(chunk_size, n_pad)
    int8_db = database.dtype == torch.int8
    if int8_db:
        if row_scales is None:
            raise ValueError("an int8 database requires row_scales")
        qq, q_scale = _sq8_queries(queries)  # [B, D] int8, [B, 1] f32
        m = max(INT_MM_MIN_ROWS, -(-b // 8) * 8)
        qq = torch.nn.functional.pad(qq, (0, 0, 0, m - b))
        scales = row_scales.float()
    else:
        q = queries.to(database.dtype)
    k_carry = min(k, n_pad)
    best_s = torch.full((b, k_carry), NEG_INF, dtype=torch.float32, device=database.device)
    best_i = torch.full((b, k_carry), -1, dtype=torch.int64, device=database.device)
    for base in range(0, n_pad, chunk_size):
        chunk = database[base : base + chunk_size]
        if int8_db:
            acc = torch._int_mm(qq, chunk.t())[:b]  # [B, C] int32
            scores = acc.float() * q_scale * scales[base : base + chunk.shape[0]][None, :]
        else:
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
