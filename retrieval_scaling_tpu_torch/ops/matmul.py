"""Matrix product with an f32 result from 16-bit operands.

The JAX package asks XLA for ``preferred_element_type=float32`` on its
bf16 dots (the Flat scan's scores, the reader's vocab logits), so the
scores are not rounded to bf16 before top-k or log-softmax. On CUDA the
same is one cuBLAS call (``torch.mm(..., out_dtype=torch.float32)``); on
the CPU the operands are upcast, which gives the same exact products.
"""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 for a [..., K] and b [K, N] of one dtype."""
    if a.dtype == torch.float32:
        return a @ b
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda:
        out = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        out = a2.float() @ b.float()
    return out.reshape(*lead, b.shape[-1])
