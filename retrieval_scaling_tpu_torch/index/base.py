"""Index facade: path resolution and dispatch over index types.

Ports ``retrieval_scaling_tpu/index/base.py``: the index directory is
derived from the embedding dir and the sorted shard-id group
(``index_{type}/{id0_id1_...}``) and artifact names encode the index type,
so both packages read and write the same files. ``Flat`` (bf16 or the SQ8
datastore, with ``approx_recall``), ``IVFFlat`` (bf16 or SQ8 tiles) and
``IVFPQ`` are ported; the anisotropic PQ codebooks (``pq_aniso``) raise.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import List, Sequence, Tuple

import torch

from retrieval_scaling_tpu_torch.index.flat import FlatIndex
from retrieval_scaling_tpu_torch.index.ivf_flat import IVFFlatIndex
from retrieval_scaling_tpu_torch.index.ivf_pq import IVFPQIndex

logger = logging.getLogger(__name__)


def get_index_dir_and_embedding_paths(cfg, index_shard_ids=None) -> Tuple[str, List[str]]:
    embedding_args = cfg.datastore.embedding
    index_args = cfg.datastore.index
    index_type = index_args.index_type

    shard_ids = index_shard_ids if index_shard_ids is not None else index_args.get("index_shard_ids", None)
    if shard_ids:
        shard_ids = sorted(int(i) for i in shard_ids)
        embedding_paths = [
            os.path.join(embedding_args.embedding_dir, f"{embedding_args.prefix}_{sid:02d}.pkl")
            for sid in shard_ids
        ]
        index_dir_name = "_".join(str(sid) for sid in shard_ids)
        index_dir = os.path.join(
            os.path.dirname(embedding_paths[0]), f"index_{index_type}", index_dir_name
        )
    else:
        embedding_paths = glob.glob(index_args.passages_embeddings)
        embedding_paths = sorted(
            embedding_paths,
            key=lambda p: int(p.rsplit(f"{embedding_args.prefix}_", 1)[-1].split(".pkl")[0]),
        )
        n_sub = index_args.get("num_subsampled_embedding_files", -1)
        if n_sub != -1:
            embedding_paths = embedding_paths[:n_sub]
        index_dir = os.path.join(os.path.dirname(embedding_paths[0]), f"index_{index_type}")
    return index_dir, embedding_paths


class Indexer:
    """Config-driven index constructor + search delegate."""

    def __init__(self, cfg, device: torch.device, index_shard_ids: Sequence[int] | None = None):
        self.cfg = cfg
        self.args = cfg.datastore.index
        self.index_type = self.args.index_type
        quantization = self.args.get("quantization", None)
        if self.index_type == "IVFPQ" and quantization not in (None, "", "none"):
            raise ValueError(
                "datastore.index.quantization applies to Flat/IVFFlat only "
                f"(got index_type={self.index_type!r}); for IVFPQ use the "
                "int8 refinement tier (pq_refine_factor) instead"
            )
        if self.index_type == "IVFPQ" and self.args.get("pq_aniso", False):
            raise NotImplementedError("anisotropic PQ codebooks (datastore.index.pq_aniso) are not ported yet")
        if self.index_type not in ("Flat", "IVFFlat", "IVFPQ"):
            raise NotImplementedError(f"index_type={self.index_type}")

        passage_dir = cfg.datastore.embedding.passages_dir
        index_dir, embedding_paths = get_index_dir_and_embedding_paths(cfg, index_shard_ids)
        os.makedirs(index_dir, exist_ok=True)
        logger.info("Index dir %s over embeddings %s", index_dir, embedding_paths)

        if "IVF" in self.index_type:
            formatted = (
                f"index_{self.index_type}.{self.args.sample_train_size}."
                f"{self.args.projection_size}.{self.args.ncentroids}.tpu"
            )
        else:
            formatted = f"index_{self.index_type}.tpu"
        common = dict(
            embed_paths=embedding_paths,
            index_path=os.path.join(index_dir, formatted + ".npz"),
            meta_file=os.path.join(index_dir, formatted + ".ids.npy"),
            passage_dir=passage_dir,
            pos_map_save_path=os.path.join(index_dir, "passage_pos_id_map.pkl"),
            dimension=self.args.projection_size,
        )
        trained_path = os.path.join(index_dir, formatted + ".trained.npz")
        if self.index_type == "Flat":
            self.datastore = FlatIndex(
                device, approx_recall=self.args.get("approx_recall", None), quantization=quantization, **common
            )
        elif self.index_type == "IVFFlat":
            self.datastore = IVFFlatIndex(
                device,
                trained_index_path=trained_path,
                sample_train_size=self.args.sample_train_size,
                ncentroids=self.args.ncentroids,
                probe=self.args.probe,
                quantization=quantization,
                **common,
            )
        else:
            self.datastore = IVFPQIndex(
                device,
                trained_index_path=trained_path,
                sample_train_size=self.args.sample_train_size,
                ncentroids=self.args.ncentroids,
                probe=self.args.probe,
                n_subquantizers=self.args.n_subquantizers,
                n_bits=self.args.n_bits,
                refine_factor=self.args.get("pq_refine_factor", 0),
                opq=self.args.get("pq_opq", False),
                refine_mode=self.args.get("pq_refine_mode", "device"),
                **common,
            )

    def search(self, query_embs, k: int = 5):
        return self.datastore.search(query_embs, k)
