"""IVF-PQ index on one device: residual product quantization + ADC list scan.

Ports ``retrieval_scaling_tpu/index/ivf_pq.py`` (the ``faiss.IndexIVFPQ``
replacement). Coarse k-means and per-subspace PQ codebooks trained on the
residuals (FAISS's ``by_residual``), optionally after an OPQ rotation; the
m-byte codes sit in the same tile-padded lists as IVF-Flat's rows. For inner
product the score of a row of list c is ``q.c + sum_s LUT[s, code_s]`` with
``LUT = q_sub . codebooks`` built once per query.

The code tiles live on the device in the on-disk row layout
``[T, 128, m]`` uint8. A CUDA index scans with kernel K5b
(``ops.ivf_gather.pq_scan_topk_tiles``), which needs ``n_bits <= 8``; a CPU index with the plain ``pq_scan_topk`` (the JAX
module's ``adc_mode="gather"``). This replaces ``use_pallas_scan``.

``refine_factor > 0`` re-ranks the PQ top ``refine_factor * k`` by exact
per-row-scaled int8 inner products (FAISS ``IndexRefineFlat`` analog): on the
device (``refine_mode="device"``, rows in device memory) or on the host
(``"host"``, rows read from the ``.refine.bin`` sidecar with threaded preads).

Artifacts are the JAX package's (``.trained.npz``, ``.npz``, ``.ids.npy``,
``.refine.bin``). Not ported yet: the anisotropic codebooks (``aniso``) and
the one-hot ADC lowering (``adc_mode="onehot"``, an XLA choice).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from retrieval_scaling_tpu_torch.data.passages import PassageStore
from retrieval_scaling_tpu_torch.index.flat import fetch_passages, filter_pad_hits, load_all_embeddings
from retrieval_scaling_tpu_torch.index.ivf_common import (
    NEG_INF,
    TILE,
    IVFListLayout,
    build_list_layout,
    default_max_tiles,
    probe_tile_schedule,
    select_probes,
)
from retrieval_scaling_tpu_torch.index.ivf_flat import npz_base, sample_training_vectors
from retrieval_scaling_tpu_torch.ops.ivf_gather import pq_scan_topk_tiles
from retrieval_scaling_tpu_torch.ops.kmeans import (
    assign_clusters,
    kmeans,
    opq_train,
    pq_encode,
    pq_train_codebooks,
)
from retrieval_scaling_tpu_torch.ops.topk import merge_topk

logger = logging.getLogger(__name__)


def quantize_rows_int8(emb: np.ndarray):
    """Per-row symmetric int8 quantization: (rows_i8 [N, D], scales [N])."""
    emb = np.asarray(emb, np.float32)
    scales = np.abs(emb).max(axis=1) / 127.0
    scales = np.maximum(scales, 1e-12)
    rows = np.clip(np.round(emb / scales[:, None]), -127, 127).astype(np.int8)
    return rows, scales.astype(np.float32)


def pq_scan_topk(
    lut: torch.Tensor,            # [B, m, ksub] f32 query lookup tables
    coarse_scores: torch.Tensor,  # [B, nprobe] q.c term per probed list
    code_tiles: torch.Tensor,     # [total_tiles, TILE, m] uint8
    row_flat_ids: torch.Tensor,   # [total_tiles * TILE]
    tile_ids: torch.Tensor,       # [B, max_tiles]
    tile_valid: torch.Tensor,     # [B, max_tiles]
    probe_of_tile: torch.Tensor,  # [B, max_tiles] probe slot per tile
    k: int,
    group: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain IVF-PQ scan (``adc_mode="gather"``): gather ``group`` code tiles
    at a time, sum the LUT entries of each row, add the coarse term, keep a
    running top-k. Returns (scores [B, k], flat ids [B, k] int64)."""
    if lut.is_cuda:
        pq_scan_topk.cuda_calls += 1
    b, m, ksub = lut.shape
    max_tiles = tile_ids.shape[1]
    n_groups = -(-max_tiles // group)
    pad = n_groups * group - max_tiles
    if pad:
        tile_ids, tile_valid, probe_of_tile = (
            torch.nn.functional.pad(a, (0, pad)) for a in (tile_ids, tile_valid, probe_of_tile)
        )
    row_ids_tiled = row_flat_ids.reshape(-1, TILE)
    k_eff = min(k, n_groups * group * TILE)
    best_s = torch.full((b, k_eff), NEG_INF, dtype=torch.float32, device=lut.device)
    best_i = torch.full((b, k_eff), -1, dtype=torch.int64, device=lut.device)
    for g0 in range(0, n_groups * group, group):
        ids_g = tile_ids[:, g0 : g0 + group].long()
        idx = code_tiles[ids_g].long()                                # [B, g, T, m]
        table = lut.float()[:, None, None].expand(*idx.shape, ksub)   # [B, g, T, m, ksub]
        s = torch.gather(table, -1, idx[..., None])[..., 0].sum(-1)   # [B, g, T]
        coarse = torch.gather(coarse_scores.float(), 1, probe_of_tile[:, g0 : g0 + group].long())
        s = s + coarse[:, :, None]
        rows = row_ids_tiled[ids_g]
        ok = tile_valid[:, g0 : g0 + group, None] & (rows >= 0)
        s = torch.where(ok, s, NEG_INF).reshape(b, group * TILE)
        flat_rows = torch.where(ok, rows, -1).reshape(b, group * TILE).long()
        c_s, c_pos = torch.topk(s, min(k_eff, group * TILE), dim=-1)
        best_s, best_i = merge_topk(best_s, best_i, c_s, torch.gather(flat_rows, -1, c_pos), k_eff)
    if k_eff < k:
        best_s = torch.nn.functional.pad(best_s, (0, k - k_eff), value=NEG_INF)
        best_i = torch.nn.functional.pad(best_i, (0, k - k_eff), value=-1)
    return best_s, best_i


pq_scan_topk.cuda_calls = 0


class IVFPQIndex:
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
        n_subquantizers: int = 16,
        n_bits: int = 8,
        kmeans_iters: int = 20,
        pq_iters: int = 20,
        probe_slack: float = 1.5,
        refine_factor: int = 0,
        opq: bool = False,
        refine_mode: str = "device",
    ):
        self.device = torch.device(device)
        self.dimension = dimension
        self.sample_train_size = sample_train_size
        self.ncentroids = ncentroids
        self.probe = probe
        self.m = n_subquantizers
        self.n_bits = n_bits
        self.kmeans_iters = kmeans_iters
        self.pq_iters = pq_iters
        self.probe_slack = probe_slack
        self.refine_factor = int(refine_factor)
        if refine_mode not in ("device", "host"):
            raise ValueError(f"unknown refine_mode {refine_mode!r}")
        self.refine_mode = refine_mode
        self.refine_row_file: str | None = None
        self.opq = bool(opq)
        self.opq_rotation: np.ndarray | None = None
        self.build_seconds: dict = {}

        if index_path and meta_file and os.path.exists(index_path) and os.path.exists(meta_file):
            logger.info("Loading IVF-PQ index from %s", index_path)
            self._load(index_path, meta_file)
        else:
            centroids, codebooks = self._load_or_train(trained_index_path, embed_paths or [])
            self._build(embed_paths or [], centroids, codebooks)
            if index_path and meta_file:
                t0 = time.perf_counter()
                self._save(index_path, meta_file)
                self.build_seconds["save"] = time.perf_counter() - t0

        # the trained codebooks fix the dimension, whatever was configured
        self.dimension = int(self.codebooks.shape[0] * self.codebooks.shape[2])
        self._place_on_device()
        self.passage_store: PassageStore | None = None
        if passage_dir is not None:
            self.passage_store = PassageStore.from_passages_dir(passage_dir, pos_map_save_path)

    # ------------------------------------------------------------ training
    def _load_or_train(self, trained_index_path, embed_paths: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        if trained_index_path and os.path.exists(trained_index_path):
            data = np.load(trained_index_path)
            self.opq_rotation = data["opq_rotation"] if "opq_rotation" in data else None
            return data["centroids"], data["codebooks"]
        sample = torch.from_numpy(sample_training_vectors(embed_paths, self.sample_train_size)).to(self.device)
        t0 = time.perf_counter()
        centroids, _ = kmeans(sample, self.ncentroids, iters=self.kmeans_iters)
        t1 = time.perf_counter()
        assign = assign_clusters(sample, centroids, self.ncentroids, metric="ip")
        residuals = sample - centroids[assign]
        del sample, assign
        t2 = time.perf_counter()
        if self.opq:
            rotation, codebooks = opq_train(residuals, self.m, self.n_bits, pq_iters=self.pq_iters)
            self.opq_rotation = rotation.cpu().numpy()
        else:
            codebooks = pq_train_codebooks(residuals, self.m, self.n_bits, iters=self.pq_iters)
        centroids, codebooks = centroids.cpu().numpy(), codebooks.cpu().numpy()
        self.build_seconds.update(kmeans=t1 - t0, train_assign=t2 - t1, pq_train=time.perf_counter() - t2)
        logger.info("Trained %d centroids + %dx%d PQ codebooks in %.1fs",
                    self.ncentroids, self.m, 1 << self.n_bits, time.perf_counter() - t0)
        if trained_index_path:
            os.makedirs(os.path.dirname(trained_index_path), exist_ok=True)
            extra = {"opq_rotation": self.opq_rotation} if self.opq_rotation is not None else {}
            np.savez(npz_base(trained_index_path), centroids=centroids, codebooks=codebooks, **extra)
        return centroids, codebooks

    # ------------------------------------------------------------ build
    def _build(self, embed_paths, centroids: np.ndarray, codebooks: np.ndarray) -> None:
        emb, self.index_id_to_db_id = load_all_embeddings(embed_paths, np.float32)
        self.n_valid = len(emb)
        t0 = time.perf_counter()
        self.refine_rows_i8, self.refine_scales = (
            quantize_rows_int8(emb) if self.refine_factor > 0 else (None, None)
        )
        t1 = time.perf_counter()
        x = torch.from_numpy(emb).to(self.device)
        cents = torch.from_numpy(np.asarray(centroids, np.float32)).to(self.device)
        assignments = assign_clusters(x, cents, self.ncentroids, metric="ip")
        t2 = time.perf_counter()
        residuals = x - cents[assignments]
        del x
        if self.opq_rotation is not None:
            residuals = residuals @ torch.from_numpy(np.asarray(self.opq_rotation, np.float32)).to(self.device)
        codes = pq_encode(residuals, torch.from_numpy(np.asarray(codebooks, np.float32)).to(self.device)).cpu().numpy()
        del residuals
        t3 = time.perf_counter()
        self.layout = build_list_layout(codes, assignments.cpu().numpy(), self.ncentroids, TILE)
        self.centroids = np.asarray(centroids, np.float32)
        self.codebooks = np.asarray(codebooks, np.float32)
        self.build_seconds.update(
            refine_quantize=t1 - t0, assign=t2 - t1, encode=t3 - t2, layout=time.perf_counter() - t3
        )

    # ------------------------------------------------------------ io
    def _save(self, index_path: str, meta_file: str) -> None:
        os.makedirs(os.path.dirname(index_path), exist_ok=True)
        base = npz_base(index_path)
        extra = {}
        if self.refine_rows_i8 is not None:
            extra.update(refine_rows_i8=self.refine_rows_i8, refine_scales=self.refine_scales)
        if self.opq_rotation is not None:
            extra["opq_rotation"] = self.opq_rotation
        np.savez(
            base,
            centroids=self.centroids,
            codebooks=self.codebooks,
            codes=self.layout.sorted_rows.astype(np.uint8),
            row_flat_ids=self.layout.row_flat_ids,
            tile_start=self.layout.tile_start,
            tile_count=self.layout.tile_count,
            list_len=self.layout.list_len,
            n_valid=np.int64(self.n_valid),
            **extra,
        )
        np.save(meta_file + ".tmp.npy", self.index_id_to_db_id)
        os.replace(meta_file + ".tmp.npy", meta_file)
        if self.refine_rows_i8 is not None:
            # raw int8 rows (D bytes each) for the host-streamed refine
            sidecar = base + ".refine.bin"
            with open(sidecar + ".tmp", "wb") as f:
                f.write(np.ascontiguousarray(self.refine_rows_i8).tobytes())
            os.replace(sidecar + ".tmp", sidecar)
            self.refine_row_file = sidecar

    def _load(self, index_path: str, meta_file: str) -> None:
        data = np.load(index_path)
        self.centroids = data["centroids"]
        self.codebooks = data["codebooks"]
        self.layout = IVFListLayout(
            data["codes"], data["row_flat_ids"], data["tile_start"], data["tile_count"], data["list_len"],
        )
        self.n_valid = int(data["n_valid"])
        self.opq_rotation = data["opq_rotation"] if "opq_rotation" in data else None
        sidecar = npz_base(index_path) + ".refine.bin"
        if (
            self.refine_mode == "host"
            and self.refine_factor > 0
            and os.path.exists(sidecar)
            and "refine_scales" in data
        ):
            # host-streamed refine: rows stay on disk, only the scales load
            self.refine_row_file = sidecar
            self.refine_rows_i8 = None
            self.refine_scales = data["refine_scales"]
        elif "refine_rows_i8" in data:
            self.refine_rows_i8 = data["refine_rows_i8"]
            self.refine_scales = data["refine_scales"]
        else:
            self.refine_rows_i8, self.refine_scales = None, None
            if self.refine_factor > 0:
                logger.warning(
                    "refine_factor=%d requested but the saved index has no int8 refinement rows; "
                    "rebuild with refine_factor>0 to refine; refinement disabled",
                    self.refine_factor,
                )
                self.refine_factor = 0
        self.index_id_to_db_id = np.load(meta_file)

    def _place_on_device(self) -> None:
        dev = self.device
        total_tiles = max(int(self.layout.tile_count.sum()), 1)
        codes = np.ascontiguousarray(self.layout.sorted_rows, np.uint8).reshape(total_tiles, TILE, self.m)
        self.code_tiles_dev = torch.from_numpy(codes).to(dev)
        self.row_ids_dev = torch.from_numpy(self.layout.row_flat_ids.astype(np.int32)).to(dev)
        self.centroids_dev = torch.from_numpy(np.asarray(self.centroids, np.float32)).to(dev)
        self.codebooks_dev = torch.from_numpy(np.asarray(self.codebooks, np.float32)).to(dev)
        self.tile_start_dev = torch.from_numpy(self.layout.tile_start.astype(np.int32)).to(dev)
        self.tile_count_dev = torch.from_numpy(self.layout.tile_count.astype(np.int32)).to(dev)
        self.refine_rows_dev = None
        if self.refine_factor > 0 and self.refine_mode == "device" and self.refine_rows_i8 is not None:
            self.refine_rows_dev = torch.from_numpy(np.asarray(self.refine_rows_i8, np.int8)).to(dev)
            self.refine_scales_dev = torch.from_numpy(np.asarray(self.refine_scales, np.float32)).to(dev)
        self.opq_rotation_dev = (
            None if self.opq_rotation is None
            else torch.from_numpy(np.asarray(self.opq_rotation, np.float32)).to(dev)
        )

    # ------------------------------------------------------------ search
    def scan_inputs(self, query_embs: np.ndarray, nprobe: int | None = None):
        """What the scan takes for a batch: (queries f32 [B, D], (lut [B, m,
        ksub], coarse [B, P], tile_ids [B, T] int32, valid [B, T],
        probe_of_tile [B, T]))."""
        nprobe = int(nprobe or self.probe)
        q = torch.from_numpy(np.asarray(query_embs, np.float32)).to(self.device)
        coarse, probe_ids = select_probes(q, self.centroids_dev, nprobe)
        max_tiles = default_max_tiles(self.layout.list_len, nprobe, TILE, self.probe_slack)
        tile_ids, valid, probe_of = probe_tile_schedule(probe_ids, self.tile_start_dev, self.tile_count_dev, max_tiles)
        # query LUT q_sub . codebooks [B, m, ksub]; with OPQ the query rotates
        # first (q.r == (qR).(rR))
        q_lut = q if self.opq_rotation_dev is None else q @ self.opq_rotation_dev
        dsub = int(self.codebooks.shape[2])
        lut = torch.einsum("bmd,mkd->bmk", q_lut.reshape(q.shape[0], self.m, dsub), self.codebooks_dev)
        lut = lut.contiguous()  # einsum may hand back a permuted view; the kernels read rows
        return q, (lut, coarse, tile_ids, valid, probe_of)

    def search_ids(self, query_embs: np.ndarray, k: int, nprobe: int | None = None):
        """(scores [B, k] f32, flat ids [B, k]; -1 past the candidates)."""
        with torch.inference_mode():
            q, (lut, coarse, tile_ids, valid, probe_of) = self.scan_inputs(query_embs, nprobe)
            k_eff = min(k, self.n_valid)
            refine_dev = self.refine_factor > 0 and self.refine_rows_dev is not None
            refine_host = self.refine_factor > 0 and self.refine_mode == "host" and (
                self.refine_row_file is not None or self.refine_rows_i8 is not None
            )
            k_scan = k_eff
            if refine_dev or refine_host:
                k_scan = min(self.refine_factor * k_eff, int(tile_ids.shape[1]) * TILE)
            args = (lut, coarse, self.code_tiles_dev, self.row_ids_dev, tile_ids, valid, probe_of, k_scan)
            if self.device.type == "cuda":
                if self.n_bits > 8:
                    raise ValueError(f"the ADC kernels take codes of at most 8 bits, not {self.n_bits}")
                scores, ids = pq_scan_topk_tiles(*args)
            else:
                scores, ids = pq_scan_topk(*args)
            if refine_dev:
                scores, ids = self._refine(q, scores, ids, k_eff)
            elif refine_host:
                return self._refine_host(np.asarray(query_embs), ids.cpu().numpy(), k_eff)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def _refine(self, q: torch.Tensor, pq_scores, pq_ids, k: int):
        """Exact int8 re-rank of the PQ candidates on the device."""
        safe = pq_ids.clamp_min(0)
        rows = self.refine_rows_dev[safe].float()                          # [B, R, D]
        ip = torch.einsum("brd,bd->br", rows, q.float())
        scores = torch.where(pq_ids >= 0, ip * self.refine_scales_dev[safe], NEG_INF)
        top_s, top_pos = torch.topk(scores, min(k, scores.shape[1]), dim=-1)
        top_i = torch.gather(pq_ids, 1, top_pos)
        return top_s, torch.where(top_s <= NEG_INF / 2, -1, top_i)

    def _read_refine_rows(self, uniq_ids: np.ndarray) -> np.ndarray:
        """Exact int8 rows of ``uniq_ids``: threaded preads from the sidecar
        file (native/rstpu_io.cpp), or a slice of the rows held in RAM."""
        d = self.dimension
        if self.refine_row_file is not None:
            from retrieval_scaling_tpu_torch.data.native_io import pread_lines_native

            spans = [(int(i) * d, d) for i in uniq_ids]
            blobs = pread_lines_native(self.refine_row_file, spans)
            if blobs is None:  # no native library: plain seek/read
                blobs = []
                with open(self.refine_row_file, "rb") as f:
                    for start, length in spans:
                        f.seek(start)
                        blobs.append(f.read(length))
            return np.frombuffer(b"".join(blobs), np.int8).reshape(len(uniq_ids), d)
        return np.asarray(self.refine_rows_i8)[uniq_ids]

    def _refine_host(self, q_np: np.ndarray, ids: np.ndarray, k: int):
        """Host re-rank: the candidates' int8 rows (deduplicated across the
        batch) stream from disk and the products run in host f32; device
        memory holds only the m-byte codes."""
        b, r = ids.shape
        safe = np.maximum(ids, 0)
        uniq, inv = np.unique(safe, return_inverse=True)
        rows = self._read_refine_rows(uniq)[inv.reshape(b, r)].astype(np.float32)  # [B, R, D]
        ip = np.einsum("brd,bd->br", rows, np.asarray(q_np, np.float32))
        scores = ip * np.asarray(self.refine_scales)[safe]
        scores = np.where(ids >= 0, scores, NEG_INF).astype(np.float32)
        kk = min(k, r)
        top_pos = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
        part = np.take_along_axis(scores, top_pos, axis=1)
        top_pos = np.take_along_axis(top_pos, np.argsort(-part, axis=1, kind="stable"), axis=1)
        top_s = np.take_along_axis(scores, top_pos, axis=1)
        top_i = np.take_along_axis(ids, top_pos, axis=1)
        return top_s, np.where(top_s <= NEG_INF / 2, -1, top_i)

    def get_retrieved_passages(self, all_indices):
        return fetch_passages(self.passage_store, self.index_id_to_db_id, all_indices)

    def search(self, query_embs: np.ndarray, k: int = 4096):
        scores, ids = self.search_ids(query_embs, k)
        scores, id_rows = filter_pad_hits(scores, ids)
        passages, db_ids = self.get_retrieved_passages(id_rows)
        return scores, passages, db_ids
