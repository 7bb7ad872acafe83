"""Index-build stage: one dense index per shard-group in ``index_shard_ids``
(nested lists = several indexes), or the host BM25 index. Ports
``retrieval_scaling_tpu/pipeline/index_build.py``."""

from __future__ import annotations

import logging

import torch

from retrieval_scaling_tpu_torch.index.base import Indexer

logger = logging.getLogger(__name__)


def build_dense_index(cfg, device: torch.device) -> None:
    ids = list(cfg.datastore.index.index_shard_ids)
    groups = ids if ids and isinstance(ids[0], (list, tuple)) else [ids]
    for group in groups:
        logger.info("Building index over shards %s", group)
        Indexer(cfg, device, index_shard_ids=list(group))


def build_index(cfg, device: torch.device) -> None:
    if cfg.model.get("sparse_retriever", None) == "bm25":
        from retrieval_scaling_tpu_torch.search.bm25 import build_bm25_index

        build_bm25_index(cfg)
    else:
        build_dense_index(cfg, device)
