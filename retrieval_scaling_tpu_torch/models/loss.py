"""Blockwise (streamed) causal-LM loss.

Ports ``retrieval_scaling_tpu/models/loss.py``. Applying the vocab head one
block of positions at a time keeps the f32 logits block-sized: at Pythia-1B
scoring shapes (b8 x 2048, vocab 50304) the dense [B, S, V] f32 logits
alone would be 3.3 GB, for a reduction to one scalar per row.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def blockwise_row_lm_loss(head_fn, hidden: torch.Tensor, labels: torch.Tensor, block: int = 128):
    """Per-row (NLL sum [B] f32, scored-token count [B]).

    ``head_fn(h_blk) -> logits`` applies the vocab head to a [B, C, H]
    block. ``hidden`` is the UNSHIFTED [B, S, H] final hidden; position t
    scores label t+1 (HF convention); labels == -100 are not scored.
    """
    h = hidden[:, :-1]
    lab = labels[:, 1:]
    b = h.shape[0]
    loss_sum = torch.zeros(b, dtype=torch.float32, device=hidden.device)
    count = torch.zeros(b, dtype=torch.int64, device=hidden.device)
    for start in range(0, h.shape[1], block):
        lab_blk = lab[:, start : start + block]
        mask = lab_blk != IGNORE_INDEX
        logits = head_fn(h[:, start : start + block]).float()       # [B, C, V]
        lse = torch.logsumexp(logits, dim=-1)                       # [B, C]
        safe = torch.where(mask, lab_blk, torch.zeros_like(lab_blk))
        picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
        loss_sum = loss_sum - ((picked - lse) * mask).sum(dim=-1)
        count = count + mask.sum(dim=-1)
    return loss_sum, count


def blockwise_row_ll_greedy(head_fn, hidden: torch.Tensor, labels: torch.Tensor, block: int = 128):
    """Per-row (log-likelihood sum [B] f32, all-greedy [B] bool) of the
    labels, the vocab head applied one block of positions at a time: the
    reader backend's ``loglikelihood`` at long rows (Gemma-2's 256000-token
    head at 8192 positions would be 8.4 GB of f32 logits a row). A row is
    greedy when every scored label is its position's argmax."""
    h = hidden[:, :-1]
    lab = labels[:, 1:]
    b = h.shape[0]
    ll = torch.zeros(b, dtype=torch.float32, device=hidden.device)
    greedy = torch.ones(b, dtype=torch.bool, device=hidden.device)
    for start in range(0, h.shape[1], block):
        lab_blk = lab[:, start : start + block]
        mask = lab_blk != IGNORE_INDEX
        logits = head_fn(h[:, start : start + block]).float()
        safe = torch.where(mask, lab_blk, torch.zeros_like(lab_blk))
        picked = torch.gather(logits, -1, safe[..., None].long())[..., 0]
        ll = ll + ((picked - torch.logsumexp(logits, dim=-1)) * mask).sum(dim=-1)
        greedy = greedy & torch.where(mask, logits.argmax(dim=-1) == safe, True).all(dim=-1)
    return ll, greedy


def use_blockwise(seq_len: int, vocab: int, device: torch.device) -> bool:
    """Streamed loss on the card once the dense [S, V] f32 logits of a row
    reach 32M elements; the dense path below that."""
    return device.type == "cuda" and seq_len * vocab >= (1 << 25)
