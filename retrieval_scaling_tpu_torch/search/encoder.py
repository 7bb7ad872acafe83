"""Batched text encoder (passage + query embedding).

Ports ``JaxEncoder`` (as ``TorchEncoder``), ``EncodeOptions``, the length
buckets, ``pack_token_rows`` and ``load_encoder`` of
``retrieval_scaling_tpu/search/encoder.py``. Texts are sorted by length and
cut into batches padded to power-of-two length buckets up to ``maxlength``,
so short texts do not pay full-length attention; embeddings come back as
fp16 numpy in the original order.

* ``EncodeOptions.packed`` (``datastore.embedding.packing``,
  ``evaluation.search.packing``) packs many texts per ``maxlength`` row,
  best fit, with block-diagonal attention (K2s on the card) for
  BERT-family encoders, when the mean length is at most 0.3 x ``maxlength``
  (the JAX package's rule, kept so that both packages take the same route
  on the same texts);
* ``quantize="int8"`` (``datastore.embedding.quantization``) runs a BERT
  encoder's FFN on int8 weights (K9 then K10 on the card);
* ``load_encoder`` dispatches on the checkpoint's ``config.json``: T5 (GTR)
  to ``t5_embed``, the llama family to ``llama_embed``, everything else to
  BERT.
"""

from __future__ import annotations

import bisect
import functools
import json
import logging
import os
import re
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

from retrieval_scaling_tpu_torch.models.bert import (
    BertConfig,
    contriever_embed,
    contriever_embed_packed,
    quantize_bert_params,
)
from retrieval_scaling_tpu_torch.models.llama import llama_embed
from retrieval_scaling_tpu_torch.models.t5 import t5_embed
from retrieval_scaling_tpu_torch.utils import text_normalize

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
    # many texts per [batch, maxlength] row, block-diagonal attention
    # (BERT-family encoders only)
    packed: bool = False


def pack_token_rows(sequences: List[List[int]], capacity: int, pad_id: int):
    """Best-fit-decreasing packing of token sequences into fixed rows (the
    JAX ``pack_token_rows``, the same layout).

    Returns (ids [R, capacity], position_ids, segment_ids, seg_starts
    [R, G], mapping): ``segment_ids`` are 1..G per row (0 = pad), positions
    restart at 0 per segment, and ``mapping[i] = (row, slot)`` locates
    sequence i's pooled embedding in the [R, G] output grid. Rows are
    bucketed by exact free space and the tightest one is found by bisect:
    O(N log capacity).
    """
    order = sorted(range(len(sequences)), key=lambda i: -len(sequences[i]))
    rows: List[List[int]] = []      # sequence indices per row
    by_free: dict = {}              # free space -> [row indices]
    frees: List[int] = []           # sorted distinct free values with rows

    def take_row(free: int) -> int:
        bucket = by_free[free]
        r = bucket.pop()
        if not bucket:
            del by_free[free]
            frees.pop(bisect.bisect_left(frees, free))
        return r

    def put_row(free: int, r: int) -> None:
        if free <= 0:
            return
        if free not in by_free:
            by_free[free] = []
            bisect.insort(frees, free)
        by_free[free].append(r)

    for i in order:
        need = len(sequences[i])
        pos = bisect.bisect_left(frees, need)  # tightest row that fits
        if pos < len(frees):
            free = frees[pos]
            r = take_row(free)
            rows[r].append(i)
            put_row(free - need, r)
        else:
            rows.append([i])
            put_row(capacity - need, len(rows) - 1)

    g = max((len(r) for r in rows), default=1)
    g = -(-g // 8) * 8  # round up to a multiple of 8, as the JAX package does
    n_rows = len(rows)
    ids = np.full((n_rows, capacity), pad_id, np.int32)
    pos = np.zeros((n_rows, capacity), np.int32)
    seg = np.zeros((n_rows, capacity), np.int32)
    seg_starts = np.zeros((n_rows, g), np.int32)
    mapping: List[tuple] = [None] * len(sequences)  # type: ignore[list-item]
    for r, members in enumerate(rows):
        cursor = 0
        for slot, i in enumerate(members):
            toks = sequences[i]
            ids[r, cursor : cursor + len(toks)] = toks
            pos[r, cursor : cursor + len(toks)] = np.arange(len(toks))
            seg[r, cursor : cursor + len(toks)] = slot + 1
            seg_starts[r, slot] = cursor
            mapping[i] = (r, slot)
            cursor += len(toks)
    return ids, pos, seg, seg_starts, mapping


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


def _unit(emb: torch.Tensor) -> torch.Tensor:
    embf = emb.float()
    return (embf / torch.linalg.vector_norm(embf, dim=-1, keepdim=True).clamp_min(1e-9)).to(emb.dtype)


class TorchEncoder:
    """Text embedder with length-bucketed (or packed) batches on one device.

    ``embed_fn(model, input_ids, attention_mask, normalize=bool)`` defines
    the architecture: Contriever / BERT by default, ``t5_embed`` or a
    llama-family embedder through ``load_encoder``."""

    def __init__(
        self,
        model,
        tokenizer,
        device: torch.device,
        dtype: torch.dtype = torch.bfloat16,
        embed_fn: Callable | None = None,
        query_prefix: str = "",
        passage_prefix: str = "",
        force_normalize: bool = False,
        quantize: str = "none",
    ):
        self.device = torch.device(device)
        model = model.to(device=self.device, dtype=dtype).eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.embed_fn = embed_fn or contriever_embed
        self.query_prefix = query_prefix
        self.passage_prefix = passage_prefix
        # models whose contract includes L2 normalization (e5, GTR) always normalize
        self.force_normalize = force_normalize
        if quantize == "int8":
            if isinstance(self.cfg, BertConfig):
                # after the cast, as the JAX encoder quantizes its dtype-cast tree
                model = quantize_bert_params(model)
            else:
                logger.warning("quantization=int8 is supported for BERT-family encoders only; keeping %s weights",
                               dtype)
        elif quantize not in ("none", None, ""):
            raise ValueError(f"unknown encoder quantization {quantize!r}")
        self.model = model

    def _embed(self, ids: torch.Tensor, mask: torch.Tensor, normalize_emb: bool, out_dim: int | None):
        emb = self.embed_fn(self.model, ids, mask, normalize=normalize_emb and out_dim is None)
        if out_dim is not None:
            emb = emb[:, :out_dim]
            if normalize_emb:
                emb = _unit(emb)
        return emb

    def encode(self, texts: Sequence[str], opts: EncodeOptions | None = None, prefix: str = "") -> np.ndarray:
        """Encode texts -> [N, D] fp16 embeddings (original order)."""
        opts = opts or EncodeOptions()
        n = len(texts)
        out_dim = opts.out_dim or getattr(self.cfg, "projection_dim", None) or self.cfg.hidden_size
        if n == 0:
            return np.zeros((0, out_dim), np.float16)

        prepped = []
        for t in texts:
            if opts.lowercase:
                t = t.lower()
            if opts.normalize_text:
                t = text_normalize.normalize(t)
            prepped.append(prefix + t if prefix else t)

        enc = self.tokenizer(prepped, max_length=opts.maxlength, truncation=True, padding=False)["input_ids"]
        normalize_emb = opts.normalize_emb or self.force_normalize
        if opts.packed:
            if not self._can_pack():
                logger.warning("packing requested but the encoder family does not support it "
                               "(BERT-family only); using bucketed batches")
            elif sum(len(t) for t in enc) > 0.3 * len(enc) * opts.maxlength:
                # the JAX package's crossover (mean length 0.3 x capacity),
                # kept so that both packages take the same route
                logger.info("packing skipped: mean length %.0f > %.0f (cap %d); bucketed batches for longer texts",
                            sum(len(t) for t in enc) / max(len(enc), 1), 0.3 * opts.maxlength, opts.maxlength)
            else:
                return self._encode_packed(enc, opts, out_dim, normalize_emb)
        lengths = np.asarray([len(ids) for ids in enc])
        buckets = _length_buckets(opts.maxlength)
        order = np.argsort(lengths, kind="stable")
        out = np.zeros((n, out_dim), np.float16)

        batch = max(opts.batch_size, 1)
        if n < batch:
            # small inputs: the next power of two instead of the full batch
            batch = min(batch, 1 << max(n - 1, 0).bit_length())
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

    def _can_pack(self) -> bool:
        # the port's BERT config has no RoBERTa positions, the JAX exclusion
        return self.embed_fn is contriever_embed and isinstance(self.cfg, BertConfig)

    def _encode_packed(self, enc: List[List[int]], opts: EncodeOptions, out_dim: int,
                       normalize_emb: bool) -> np.ndarray:
        """Packed encode: every row carries ~maxlength real tokens."""
        pad_id = self.tokenizer.pad_token_id or 0
        ids, pos, seg, seg_starts, mapping = pack_token_rows(enc, opts.maxlength, pad_id)
        row_batch = max(opts.batch_size, 1)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        # the last batch keeps only its real rows: no shape is static here
        row_embs = []
        with torch.inference_mode():
            for start in range(0, ids.shape[0], row_batch):
                sl = slice(start, start + row_batch)
                emb = contriever_embed_packed(
                    self.model, dev(ids[sl].astype(np.int64)), dev(pos[sl].astype(np.int64)), dev(seg[sl]),
                    dev(seg_starts[sl]), normalize=normalize_emb and opts.out_dim is None,
                )  # [R, G, D]
                if opts.out_dim is not None:
                    emb = emb[..., : opts.out_dim]
                    if normalize_emb:
                        emb = _unit(emb)
                row_embs.append(emb.to(torch.float16).cpu().numpy())
        all_rows = np.concatenate(row_embs, axis=0)  # [rows, G, D]
        rows, slots = (np.asarray(a, np.int64) for a in zip(*mapping))
        return all_rows[rows, slots].astype(np.float16, copy=False).reshape(len(enc), out_dim)

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


_DECODER_MODEL_TYPES = ("llama", "mistral", "qwen2", "qwen3")
_QWEN3_QUERY_PREFIX = "Instruct: Given a web search query, retrieve relevant passages that answer the query\nQuery: "


def _llama_embed_fn(model, ids, mask, normalize: bool = True, pooling: str = "last", bidirectional: bool = False):
    return llama_embed(model, model.cfg, ids, mask, pooling=pooling, normalize=normalize,
                       bidirectional=bidirectional)


def load_encoder(
    model_name_or_path: str,
    device: torch.device,
    tokenizer_name: str | None = None,
    dtype: torch.dtype = torch.bfloat16,
    quantize: str = "none",
) -> TorchEncoder:
    """A retriever from a local HF directory, dispatched on the
    ``model_type`` of its ``config.json`` (read as a plain dict):

    * ``t5`` (GTR): T5 encoder, mean pooling, the local sentence-transformers
      Dense projection, L2 normalization;
    * the llama family (``llama`` / ``mistral`` / ``qwen2`` / ``qwen3``):
      GRIT / ReasonIR / DRAMA (by name) bidirectional with mean pooling,
      other (Qwen3-embedding style) causal with last-token pooling and the
      query instruction;
    * everything else BERT: contriever masked mean pooling, e5 /
      sentence-transformers mean pooling + L2 normalization + "query: " /
      "passage: " prefixes, other checkpoints CLS pooling.

    No hub download: a directory without a Dense module gets the JAX
    package's warning and no projection.
    """
    from retrieval_scaling_tpu_torch.models.hf_convert import (
        load_hf_encoder,
        load_hf_reader,
        load_hf_t5_encoder,
        load_tokenizer,
    )

    name = str(model_name_or_path).lower()
    tokenizer = load_tokenizer(tokenizer_name or model_name_or_path)
    config_path = os.path.join(str(model_name_or_path), "config.json")
    model_type = "bert"
    if os.path.exists(config_path):
        with open(config_path) as f:
            model_type = json.load(f).get("model_type", "bert")

    if model_type == "t5":
        model = load_hf_t5_encoder(model_name_or_path)
        if model.projection is None:
            logger.warning(
                "No sentence-transformers Dense projection found for %s: "
                "embeddings use the raw T5 encoder space, which DIFFERS from "
                "the sentence-transformers space (same dim, different basis). "
                "Point model.query_encoder at a local ST checkpoint directory "
                "containing the *_Dense module for exact parity.",
                model_name_or_path,
            )
        return TorchEncoder(model, tokenizer, device, dtype=dtype, embed_fn=t5_embed, force_normalize=True,
                            quantize=quantize)

    if model_type in _DECODER_MODEL_TYPES:
        model = load_hf_reader(model_name_or_path)
        # GRIT / ReasonIR / DRAMA are bidirectional llama-family embedders;
        # Qwen3-style embedders stay causal with last-token pooling
        grit_style = "grit" in name or "reasonir" in name or "drama" in name
        embed_fn = functools.partial(_llama_embed_fn, pooling="mean" if grit_style else "last",
                                     bidirectional=grit_style)
        if tokenizer.pad_token_id is None:
            tokenizer.pad_token = tokenizer.eos_token
        return TorchEncoder(model, tokenizer, device, dtype=dtype, embed_fn=embed_fn,
                            query_prefix="" if grit_style else _QWEN3_QUERY_PREFIX, quantize=quantize)

    # token-wise match so hub ids like "intfloat/e5-base-v2" are detected
    e5_style = "e5" in re.split(r"[/_-]", name) or "sentence-transformers" in name
    pooling = "mean" if ("contriever" in name or e5_style) else "cls"
    model = load_hf_encoder(model_name_or_path, pooling=pooling)
    return TorchEncoder(
        model, tokenizer, device, dtype=dtype,
        query_prefix="query: " if e5_style else "",
        passage_prefix="passage: " if e5_style else "",
        force_normalize=e5_style,
        quantize=quantize,
    )
