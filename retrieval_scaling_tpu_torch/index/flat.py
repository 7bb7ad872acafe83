"""Exact MIPS (Flat) index resident on one device.

Ports ``FlatIndex`` and ``filter_pad_hits`` of
``retrieval_scaling_tpu/index/flat.py``. The embeddings live as one
``[N_pad, D]`` bf16 tensor on the given device (rows padded to 128) and a
search is ``ops.topk.chunked_topk_scores``. The on-disk artifacts are the
JAX package's, so an index built by one package loads in the other:

  * ``index_Flat.tpu.npz``      fp16 ``embeddings``
  * ``index_Flat.tpu.ids.npy``  int64 [N, 2] ``(shard_id, chunk_id)`` map

Input embedding shards are the ``passages_{i:02d}.pkl`` ``(ids, ndarray)``
pickles. With ``quantization="int8"`` (the FAISS SQ8 analog) the rows are
quantized per row at load (``quantize_rows_sq8``, which the IVF-Flat SQ8
tiles use too): an int8 tensor plus f32 row scales, half the bytes a scan
streams. The files on disk stay fp16, so either package reads them with
either setting. ``approx_recall`` is passed to the scan, whose top-k stays
exact (``ops/topk.py``).
"""

from __future__ import annotations

import logging
import os
import pickle
import re
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from retrieval_scaling_tpu_torch.data.passages import PassageStore
from retrieval_scaling_tpu_torch.ops.topk import chunked_topk_scores, pick_chunk_size

logger = logging.getLogger(__name__)

_ROW_ALIGN = 128


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def filter_pad_hits(scores: np.ndarray, ids: np.ndarray):
    """Drop pad hits (id < 0) from fixed-shape [b, k] search output.

    Pads appear when k exceeds the number of valid rows; they must never
    reach the passage fetch, where -1 would wrap to the last passage.
    Returns ragged per-row lists.
    """
    scores = np.asarray(scores)
    ids = np.asarray(ids)
    out_scores, out_ids = [], []
    for row_scores, row_ids in zip(scores, ids):
        valid = row_ids >= 0
        out_scores.append([float(s) for s in row_scores[valid]])
        out_ids.append([int(i) for i in row_ids[valid]])
    return out_scores, out_ids


def quantize_rows_sq8(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization: (int8 rows [N, D], f32 scales [N]).

    score(q, row) ≈ (q_int8 · row_int8) * q_scale * row_scale; pad rows get
    scale 0 so they dequantize to exact zeros.
    """
    embf = np.asarray(emb, np.float32)
    absmax = np.abs(embf).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    rows_q = np.clip(np.rint(embf / safe[:, None]), -127, 127).astype(np.int8)
    return rows_q, scales


def load_embedding_shard(path: str) -> Tuple[list, np.ndarray]:
    """Load one ``passages_{i}.pkl`` ``(ids, [N, D] array)`` shard."""
    with open(path, "rb") as f:
        ids, embeddings = pickle.load(f)
    return ids, np.asarray(embeddings)


def shard_id_from_embedding_path(path: str) -> int:
    m = re.search(r"_(\d+)\.pkl$", os.path.basename(path))
    if not m:
        raise ValueError(f"Cannot parse shard id from {path}")
    return int(m.group(1))


def load_all_embeddings(embed_paths: Sequence[str], dtype=np.float16) -> Tuple[np.ndarray, np.ndarray]:
    """Shards in shard-id order: (rows [N, D], (shard_id, chunk_id) [N, 2])."""
    parts, id_parts = [], []
    t0 = time.time()
    for path in sorted(embed_paths, key=shard_id_from_embedding_path):
        shard_id = shard_id_from_embedding_path(path)
        _, emb = load_embedding_shard(path)
        parts.append(np.asarray(emb, dtype))
        ids = np.empty((len(emb), 2), np.int64)
        ids[:, 0] = shard_id
        ids[:, 1] = np.arange(len(emb))
        id_parts.append(ids)
        logger.info("loaded shard %d (%d vectors, %.1fs)", shard_id, len(emb), time.time() - t0)
    if not parts:
        raise ValueError("No embedding shards to index")
    return np.concatenate(parts, axis=0), np.concatenate(id_parts, axis=0)


def fetch_passages(passage_store, index_id_to_db_id, all_indices):
    """Ragged rows of valid (>= 0) flat ids -> (passage texts, db ids)."""
    if passage_store is None:
        raise ValueError("passage store not configured")
    flat = [int(i) for row in all_indices for i in row]
    if any(i < 0 for i in flat):
        raise ValueError("pad ids must be filtered before fetch")
    pairs = [tuple(int(v) for v in index_id_to_db_id[i]) for i in flat]
    texts = [r["text"] for r in passage_store.fetch_many(pairs)]
    passages, db_ids, pos = [], [], 0
    for row in all_indices:
        passages.append(texts[pos : pos + len(row)])
        db_ids.append([list(pairs[pos + j]) for j in range(len(row))])
        pos += len(row)
    return passages, db_ids


class FlatIndex:
    def __init__(
        self,
        device: torch.device,
        embed_paths: Sequence[str] | None = None,
        index_path: str | None = None,
        meta_file: str | None = None,
        passage_dir: str | None = None,
        pos_map_save_path: str | None = None,
        dimension: int = 768,
        dtype: torch.dtype = torch.bfloat16,
        search_chunk_size: int = 1 << 20,
        approx_recall: float | None = None,
        quantization: str | None = None,
    ):
        self.device = torch.device(device)
        self.dimension = dimension
        self.dtype = dtype
        self.search_chunk_size = search_chunk_size
        self.approx_recall = approx_recall
        if quantization not in (None, "", "none", "int8"):
            raise ValueError(f"unknown datastore quantization {quantization!r}")
        self.quantization = quantization if quantization == "int8" else None

        if index_path and meta_file and os.path.exists(index_path) and os.path.exists(meta_file):
            logger.info("Loading index from %s", index_path)
            emb = np.load(index_path)["embeddings"]
            self.index_id_to_db_id = np.load(meta_file)
        else:
            logger.info("Building Flat index from %d embedding shards", len(embed_paths or []))
            emb, self.index_id_to_db_id = load_all_embeddings(embed_paths or [])
            if index_path and meta_file:
                self._write_artifacts(index_path, meta_file, emb, self.index_id_to_db_id)

        self.n_valid = emb.shape[0]
        rows = _round_up(max(self.n_valid, 1), _ROW_ALIGN)
        self.row_scales = None
        if self.quantization == "int8":
            padded = np.zeros((rows, emb.shape[1]), emb.dtype)
            padded[: self.n_valid] = emb
            rows_q, scales = quantize_rows_sq8(padded)
            self.embeddings = torch.from_numpy(rows_q).to(self.device)
            self.row_scales = torch.from_numpy(scales).to(self.device)
        else:
            self.embeddings = torch.zeros((rows, emb.shape[1]), dtype=dtype, device=self.device)
            self.embeddings[: self.n_valid] = torch.from_numpy(np.asarray(emb, np.float32)).to(self.device, dtype)

        self.passage_store: PassageStore | None = None
        if passage_dir is not None:
            self.passage_store = PassageStore.from_passages_dir(passage_dir, pos_map_save_path)

    # ------------------------------------------------------------ build/io
    def _write_artifacts(self, index_path, meta_file, emb: np.ndarray, ids: np.ndarray) -> None:
        os.makedirs(os.path.dirname(index_path), exist_ok=True)
        tmp = index_path + ".tmp.npz"
        np.savez(tmp[:-4], embeddings=emb.astype(np.float16))
        os.replace(tmp, index_path)
        np.save(meta_file + ".tmp.npy", ids)
        os.replace(meta_file + ".tmp.npy", meta_file)
        logger.info("Wrote %s (%d vectors)", index_path, emb.shape[0])

    # ------------------------------------------------------------ search
    def search_ids(self, query_embs: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Device search: (scores [B, k] f32, flat index ids [B, k])."""
        # SQ8 row-quantizes f32 queries (JAX flat.py:201)
        q_dtype = torch.float32 if self.quantization == "int8" else self.dtype
        q = torch.from_numpy(np.asarray(query_embs, np.float32)).to(self.device, q_dtype)
        chunk = min(self.search_chunk_size, pick_chunk_size(self.embeddings.shape[0], q.shape[0]))
        with torch.inference_mode():
            scores, ids = chunked_topk_scores(
                q, self.embeddings, self.n_valid, min(k, self.n_valid), chunk,
                approx_recall=self.approx_recall, row_scales=self.row_scales,
            )
        return scores.cpu().numpy(), ids.cpu().numpy()

    def get_retrieved_passages(self, all_indices):
        """Map flat ids -> (passage texts, db_ids) via the disk-resident
        store. Accepts ragged rows; ids must already be valid (>= 0)."""
        return fetch_passages(self.passage_store, self.index_id_to_db_id, all_indices)

    def search(self, query_embs: np.ndarray, k: int = 4096):
        """Reference-compatible search: (scores, passages, db_ids) lists."""
        scores, ids = self.search_ids(query_embs, k)
        scores, id_rows = filter_pad_hits(scores, ids)
        passages, db_ids = self.get_retrieved_passages(id_rows)
        return scores, passages, db_ids
