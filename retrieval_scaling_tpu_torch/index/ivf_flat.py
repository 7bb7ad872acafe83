"""IVF-Flat index on one device: trained coarse quantizer + tiled inverted lists.

Ports ``retrieval_scaling_tpu/index/ivf_flat.py`` (the ``faiss.IndexIVFFlat``
replacement). Coarse centroids are trained with ``ops.kmeans`` on a uniform
per-shard sample of ``sample_train_size`` vectors; vectors are assigned by
inner product and laid out in tile-padded lists (``index.ivf_common``); a
search selects ``nprobe`` lists per query and scores their tiles.

The lists live on the index's device as bf16 tiles (or SQ8 int8 tiles with
per-row scales, ``quantization="int8"``). A CUDA index scans with kernel K4
(``ops.ivf_gather.ivf_scan_topk_tiles``), a CPU index with the plain
``ivf_scan_topk``; this replaces the JAX module's
``jax.default_backend() == "tpu"`` switch.

Artifacts are the JAX package's, so either package loads the other's:
``.trained.npz`` (``centroids``), ``.npz`` (``centroids``, fp16
``sorted_rows``, ``row_flat_ids``, ``tile_start``, ``tile_count``,
``list_len``, ``n_valid``) and ``.ids.npy``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Sequence

import numpy as np
import torch

from retrieval_scaling_tpu_torch.data.passages import PassageStore
from retrieval_scaling_tpu_torch.index.flat import (
    fetch_passages,
    filter_pad_hits,
    load_all_embeddings,
    load_embedding_shard,
    quantize_rows_sq8,
)
from retrieval_scaling_tpu_torch.index.ivf_common import (
    TILE,
    IVFListLayout,
    build_list_layout,
    default_max_tiles,
    ivf_scan_topk,
    probe_tile_schedule,
    select_probes,
)
from retrieval_scaling_tpu_torch.ops.ivf_gather import ivf_scan_topk_tiles
from retrieval_scaling_tpu_torch.ops.kmeans import assign_clusters, kmeans

logger = logging.getLogger(__name__)


def npz_base(path: str) -> str:
    """``np.savez`` appends ``.npz``; the base it must be given."""
    return path[:-4] if path.endswith(".npz") else path


def sample_training_vectors(embed_paths: Sequence[str], sample_train_size: int) -> np.ndarray:
    """Uniform per-shard sample, seed 1 (the reference's ``np.random.seed(1)``)."""
    per_shard = max(1, sample_train_size // max(len(embed_paths), 1))
    rng = np.random.RandomState(1)
    samples: List[np.ndarray] = []
    for path in embed_paths:
        _, emb = load_embedding_shard(path)
        take = min(per_shard, len(emb))
        idx = rng.choice(len(emb), size=take, replace=False)
        samples.append(np.asarray(emb[idx], np.float32))
    return np.concatenate(samples, axis=0)


class IVFFlatIndex:
    def __init__(
        self,
        device: torch.device,
        embed_paths: Sequence[str] | None = None,
        index_path: str | None = None,
        meta_file: str | None = None,
        trained_index_path: str | None = None,
        passage_dir: str | None = None,
        pos_map_save_path: str | None = None,
        dimension: int = 768,
        sample_train_size: int = 1000000,
        ncentroids: int = 4096,
        probe: int = 64,
        kmeans_iters: int = 20,
        dtype: torch.dtype = torch.bfloat16,
        probe_slack: float = 1.5,
        quantization: str | None = None,
    ):
        self.device = torch.device(device)
        self.dimension = dimension
        self.sample_train_size = sample_train_size
        self.ncentroids = ncentroids
        self.probe = probe
        self.kmeans_iters = kmeans_iters
        self.dtype = dtype
        self.probe_slack = probe_slack
        # "int8" = per-row SQ8 list tiles, applied at device placement; the
        # artifacts stay fp16
        if quantization not in (None, "", "none", "int8"):
            raise ValueError(f"unknown datastore quantization {quantization!r}")
        self.quantization = quantization if quantization == "int8" else None
        self.build_seconds: dict = {}

        if index_path and meta_file and os.path.exists(index_path) and os.path.exists(meta_file):
            logger.info("Loading IVF-Flat index from %s", index_path)
            self._load(index_path, meta_file)
        else:
            centroids = self._load_or_train_centroids(trained_index_path, embed_paths or [])
            self._build(embed_paths or [], centroids)
            if index_path and meta_file:
                t0 = time.perf_counter()
                self._save(index_path, meta_file)
                self.build_seconds["save"] = time.perf_counter() - t0

        self._place_on_device()
        self.passage_store: PassageStore | None = None
        if passage_dir is not None:
            self.passage_store = PassageStore.from_passages_dir(passage_dir, pos_map_save_path)

    # ------------------------------------------------------------ training
    def _load_or_train_centroids(self, trained_index_path, embed_paths: Sequence[str]) -> np.ndarray:
        if trained_index_path and os.path.exists(trained_index_path):
            logger.info("Loading trained centroids from %s", trained_index_path)
            return np.load(trained_index_path)["centroids"]
        sample = sample_training_vectors(embed_paths, self.sample_train_size)
        logger.info("Training %d centroids on %d samples", self.ncentroids, len(sample))
        t0 = time.perf_counter()
        centroids, history = kmeans(torch.from_numpy(sample).to(self.device), self.ncentroids, iters=self.kmeans_iters)
        centroids = centroids.cpu().numpy()
        self.build_seconds["kmeans"] = time.perf_counter() - t0
        logger.info("k-means done in %.1fs (objective %.4g -> %.4g)",
                    self.build_seconds["kmeans"], float(history[0]), float(history[-1]))
        if trained_index_path:
            os.makedirs(os.path.dirname(trained_index_path), exist_ok=True)
            np.savez(npz_base(trained_index_path), centroids=centroids)
        return centroids

    # ------------------------------------------------------------ build
    def _build(self, embed_paths: Sequence[str], centroids: np.ndarray) -> None:
        emb, db_ids = load_all_embeddings(embed_paths)
        t0 = time.perf_counter()
        # the JAX package assigns the rows rounded to the index dtype, in f32
        rows = torch.from_numpy(emb).to(self.device).to(self.dtype)
        assignments = assign_clusters(
            rows, torch.from_numpy(np.asarray(centroids, np.float32)).to(self.device), self.ncentroids, metric="ip"
        ).cpu().numpy()
        del rows
        t1 = time.perf_counter()
        layout = build_list_layout(emb, assignments, self.ncentroids, TILE)
        self.build_seconds.update(assign=t1 - t0, layout=time.perf_counter() - t1)
        logger.info("Assigned + laid out %d vectors into %d lists (%d tiles)",
                    len(emb), self.ncentroids, int(layout.tile_count.sum()))
        self.centroids = np.asarray(centroids, np.float32)
        self.layout = layout
        self.index_id_to_db_id = db_ids
        self.n_valid = len(emb)

    # ------------------------------------------------------------ io
    def _save(self, index_path: str, meta_file: str) -> None:
        os.makedirs(os.path.dirname(index_path), exist_ok=True)
        np.savez(
            npz_base(index_path),
            centroids=self.centroids,
            sorted_rows=self.layout.sorted_rows.astype(np.float16),
            row_flat_ids=self.layout.row_flat_ids,
            tile_start=self.layout.tile_start,
            tile_count=self.layout.tile_count,
            list_len=self.layout.list_len,
            n_valid=np.int64(self.n_valid),
        )
        np.save(meta_file + ".tmp.npy", self.index_id_to_db_id)
        os.replace(meta_file + ".tmp.npy", meta_file)

    def _load(self, index_path: str, meta_file: str) -> None:
        data = np.load(index_path)
        self.centroids = data["centroids"]
        self.layout = IVFListLayout(
            data["sorted_rows"], data["row_flat_ids"], data["tile_start"],
            data["tile_count"], data["list_len"],
        )
        self.n_valid = int(data["n_valid"])
        self.index_id_to_db_id = np.load(meta_file)

    def _place_on_device(self) -> None:
        d = self.layout.sorted_rows.shape[1]
        total_tiles = max(int(self.layout.tile_count.sum()), 1)
        dev = self.device
        if self.quantization == "int8":
            rows_q, scales = quantize_rows_sq8(self.layout.sorted_rows)
            self.tiles_dev = torch.from_numpy(rows_q.reshape(total_tiles, TILE, d)).to(dev)
            self.tile_scales_dev = torch.from_numpy(scales.reshape(total_tiles, TILE)).to(dev)
        else:
            rows = torch.from_numpy(np.asarray(self.layout.sorted_rows)).to(dev)
            self.tiles_dev = rows.float().to(self.dtype).reshape(total_tiles, TILE, d).contiguous()
            self.tile_scales_dev = None
        self.row_ids_dev = torch.from_numpy(self.layout.row_flat_ids.astype(np.int32)).to(dev)
        self.centroids_dev = torch.from_numpy(np.asarray(self.centroids, np.float32)).to(dev)
        self.tile_start_dev = torch.from_numpy(self.layout.tile_start.astype(np.int32)).to(dev)
        self.tile_count_dev = torch.from_numpy(self.layout.tile_count.astype(np.int32)).to(dev)

    # ------------------------------------------------------------ search
    def scan_inputs(self, query_embs: np.ndarray, nprobe: int | None = None):
        """What the scan takes for a batch: (queries in the scan's type,
        tile_ids [B, T] int32, valid [B, T])."""
        nprobe = int(nprobe or self.probe)
        q_dtype = torch.float32 if self.quantization == "int8" else self.dtype
        q = torch.from_numpy(np.asarray(query_embs, np.float32)).to(self.device).to(q_dtype)
        _, probe_ids = select_probes(q.float(), self.centroids_dev, nprobe)
        max_tiles = default_max_tiles(self.layout.list_len, nprobe, TILE, self.probe_slack)
        tile_ids, valid, _ = probe_tile_schedule(probe_ids, self.tile_start_dev, self.tile_count_dev, max_tiles)
        return q, tile_ids, valid

    def search_ids(self, query_embs: np.ndarray, k: int, nprobe: int | None = None):
        """(scores [B, k] f32, flat ids [B, k]; -1 past the probed rows)."""
        with torch.inference_mode():
            q, tile_ids, valid = self.scan_inputs(query_embs, nprobe)
            args = (q, self.tiles_dev, self.row_ids_dev, tile_ids, valid, min(k, self.n_valid))
            if self.device.type == "cuda":
                scores, ids = ivf_scan_topk_tiles(*args, tile_row_scales=self.tile_scales_dev)
            else:
                scores, ids = ivf_scan_topk(*args, tile_row_scales=self.tile_scales_dev)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def get_retrieved_passages(self, all_indices):
        return fetch_passages(self.passage_store, self.index_id_to_db_id, all_indices)

    def search(self, query_embs: np.ndarray, k: int = 4096):
        scores, ids = self.search_ids(query_embs, k)
        scores, id_rows = filter_pad_hits(scores, ids)
        passages, db_ids = self.get_retrieved_passages(id_rows)
        return scores, passages, db_ids
