"""Batched text encoder (passage + query embedding).

Ports ``JaxEncoder`` (as ``TorchEncoder``), ``EncodeOptions``, the length
buckets and the BERT branch of ``load_encoder`` of
``retrieval_scaling_tpu/search/encoder.py``. Texts are sorted by length and
cut into batches padded to power-of-two length buckets up to ``maxlength``,
so short texts do not pay full-length attention; embeddings come back as
fp16 numpy in the original order. Sequence packing, the int8 FFN and the
T5 / llama-family encoders are not ported yet.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from retrieval_scaling_tpu_torch.models.bert import BertModel, contriever_embed

logger = logging.getLogger(__name__)


def _length_buckets(maxlength: int) -> List[int]:
    buckets, b = [], 32
    while b < maxlength:
        buckets.append(b)
        b *= 2
    buckets.append(maxlength)
    return buckets


@dataclass
class EncodeOptions:
    batch_size: int = 512
    maxlength: int = 512
    lowercase: bool = False
    normalize_text: bool = False
    no_title: bool = False
    normalize_emb: bool = False
    # truncate embeddings to the index's projection size; None = hidden size
    out_dim: int | None = None


def projection_out_dim(cfg, encoder) -> int | None:
    """out_dim from ``datastore.index.projection_size`` (both passages and
    queries are truncated by the same rule)."""
    try:
        proj = cfg.datastore.index.get("projection_size", None)
    except AttributeError:
        proj = None
    if proj and proj < encoder.cfg.hidden_size:
        return int(proj)
    return None


class TorchEncoder:
    """Text embedder with length-bucketed batches on one device."""

    def __init__(
        self,
        model: BertModel,
        tokenizer,
        device: torch.device,
        dtype: torch.dtype = torch.bfloat16,
        query_prefix: str = "",
        passage_prefix: str = "",
        force_normalize: bool = False,
    ):
        self.device = torch.device(device)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.query_prefix = query_prefix
        self.passage_prefix = passage_prefix
        # models whose contract includes L2 normalization (e5) always normalize
        self.force_normalize = force_normalize

    def _embed(self, ids: torch.Tensor, mask: torch.Tensor, normalize_emb: bool, out_dim: int | None):
        emb = contriever_embed(self.model, ids, mask, normalize=normalize_emb and out_dim is None)
        if out_dim is not None:
            emb = emb[:, :out_dim]
            if normalize_emb:
                embf = emb.float()
                emb = (embf / torch.linalg.vector_norm(embf, dim=-1, keepdim=True).clamp_min(1e-9)).to(emb.dtype)
        return emb

    def encode(self, texts: Sequence[str], opts: EncodeOptions | None = None, prefix: str = "") -> np.ndarray:
        """Encode texts -> [N, D] fp16 embeddings (original order)."""
        opts = opts or EncodeOptions()
        n = len(texts)
        out_dim = opts.out_dim or self.cfg.hidden_size
        if n == 0:
            return np.zeros((0, out_dim), np.float16)

        prepped = []
        for t in texts:
            if opts.lowercase:
                t = t.lower()
            if opts.normalize_text:
                raise NotImplementedError("normalize_text (utils/text_normalize.py) is not ported yet")
            prepped.append(prefix + t if prefix else t)

        enc = self.tokenizer(prepped, max_length=opts.maxlength, truncation=True, padding=False)["input_ids"]
        lengths = np.asarray([len(ids) for ids in enc])
        buckets = _length_buckets(opts.maxlength)
        order = np.argsort(lengths, kind="stable")
        out = np.zeros((n, out_dim), np.float16)

        batch = max(opts.batch_size, 1)
        if n < batch:
            # small inputs: the next power of two instead of the full batch
            batch = min(batch, 1 << max(n - 1, 0).bit_length())
        normalize_emb = opts.normalize_emb or self.force_normalize
        pad_id = self.tokenizer.pad_token_id or 0

        with torch.inference_mode():
            for pos in range(0, n, batch):
                take = order[pos : pos + batch]
                max_len = int(lengths[take].max())
                bucket = next(b for b in buckets if b >= min(max_len, opts.maxlength))
                ids_np = np.full((batch, bucket), pad_id, np.int64)
                mask_np = np.zeros((batch, bucket), np.int64)
                for row, idx in enumerate(take):
                    ids = enc[idx][:bucket]
                    ids_np[row, : len(ids)] = ids
                    mask_np[row, : len(ids)] = 1
                emb = self._embed(
                    torch.from_numpy(ids_np).to(self.device),
                    torch.from_numpy(mask_np).to(self.device),
                    normalize_emb, opts.out_dim,
                )
                out[take] = emb[: len(take)].to(torch.float16).cpu().numpy()
        return out

    def encode_passages(self, passages: Sequence[dict], opts: EncodeOptions):
        """Passage-side text assembly: ``title + " " + text`` unless no_title."""
        texts = []
        for p in passages:
            if opts.no_title or "title" not in p:
                texts.append(p["text"])
            else:
                texts.append(p["title"] + " " + p["text"])
        ids = [p["id"] for p in passages]
        return ids, self.encode(texts, opts, prefix=self.passage_prefix)

    def encode_queries(self, queries: Sequence[str], opts: EncodeOptions) -> np.ndarray:
        return self.encode(queries, opts, prefix=self.query_prefix)


def load_encoder(
    model_name_or_path: str,
    device: torch.device,
    tokenizer_name: str | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> TorchEncoder:
    """A BERT-family retriever from a local HF directory.

    Contriever: masked mean pooling. e5 / sentence-transformers: mean
    pooling, L2 normalization and "query: "/"passage: " prefixes. Other
    BERT checkpoints: CLS pooling.
    """
    from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_encoder, load_tokenizer

    name = str(model_name_or_path).lower()
    tokenizer = load_tokenizer(tokenizer_name or model_name_or_path)
    e5_style = "e5" in re.split(r"[/_-]", name) or "sentence-transformers" in name
    pooling = "mean" if ("contriever" in name or e5_style) else "cls"
    model = load_hf_encoder(model_name_or_path, pooling=pooling, device=device, dtype=dtype)
    return TorchEncoder(
        model, tokenizer, device, dtype=dtype,
        query_prefix="query: " if e5_style else "",
        passage_prefix="passage: " if e5_style else "",
        force_normalize=e5_style,
    )
