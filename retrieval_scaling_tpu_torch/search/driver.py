"""Offline top-k search driver and multi-index merging.

Ports ``retrieval_scaling_tpu/search/driver.py``: embed the queries once,
search every index shard-group, attach ``ctxs`` records
``{id, source, "retrieval text", "retrieval score"}`` to the eval data and
write per-group ``*_retrieved_results.jsonl`` files (scores stringified, as
the JAX package and the reference write them), then merge groups by score,
or, with ``merge_multi_source_results`` and ``topk_subsample_p``, run the
multi-source merge of ``search/postprocess.py``. ``model.sparse_retriever``
routes to BM25 (``search/bm25.py``). The paths are the JAX package's, so
both packages read each other's files.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import pickle
from typing import List, Sequence

import numpy as np
import torch

from retrieval_scaling_tpu_torch.data.eval_data import load_eval_data
from retrieval_scaling_tpu_torch.index.base import Indexer
from retrieval_scaling_tpu_torch.search.encoder import (
    EncodeOptions,
    TorchEncoder,
    load_encoder,
    projection_out_dim,
)

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------- paths
def _shard_groups(index_shard_ids) -> List[List[int]]:
    """``[0, 1]`` = one index over shards 0+1; ``[[0], [1]]`` = two indexes."""
    ids = list(index_shard_ids)
    if ids and isinstance(ids[0], (list, tuple)):
        return [list(g) for g in ids]
    return [ids]


def get_search_output_path(cfg, index_shard_ids: Sequence[int]) -> str:
    eval_args = cfg.evaluation
    postfix = "_".join(str(s) for s in index_shard_ids)
    output_dir = os.path.join(eval_args.eval_output_dir, postfix)
    base = os.path.basename(eval_args.data.eval_data).replace(".jsonl", "_retrieved_results.jsonl")
    return os.path.join(output_dir, base)


def _merged_postfix(cfg) -> str:
    groups = _shard_groups(cfg.datastore.index.index_shard_ids)
    parts = [
        "_".join(str(s) for s in group)
        for group in sorted(groups, key=lambda g: int(g[0]))
    ]
    return "-".join(parts)


def get_merged_search_output_path(cfg) -> str:
    eval_args = cfg.evaluation
    output_dir = os.path.join(eval_args.eval_output_dir, _merged_postfix(cfg))
    base = os.path.basename(eval_args.data.eval_data).replace(".jsonl", "_retrieved_results.jsonl")
    return os.path.join(output_dir, base)


def get_merged_subsampled_search_output_path(cfg) -> str:
    eval_args = cfg.evaluation
    p = eval_args.search.get("topk_subsample_p", None)
    if p:
        seed = eval_args.search.get("subsample_seed", 1000)
        output_dir = os.path.join(
            eval_args.eval_output_dir, f"subsampled_{p}_seed_{seed}", _merged_postfix(cfg)
        )
    else:
        output_dir = os.path.join(eval_args.eval_output_dir, _merged_postfix(cfg))
    base = os.path.basename(eval_args.data.eval_data).replace(".jsonl", "_retrieved_results.jsonl")
    return os.path.join(output_dir, base)


# ---------------------------------------------------------------- io
def safe_write_jsonl(data: List[dict], output_file: str) -> None:
    """Write-or-delete: partial output never survives an exception."""
    try:
        with open(output_file, "w") as f:
            for ex in data:
                f.write(json.dumps(ex) + "\n")
    except BaseException:
        if os.path.exists(output_file):
            os.remove(output_file)
        raise
    logger.info("Saved results to %s", output_file)


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------- search
def add_passages_to_eval_data(data, passages, scores, db_ids, valid_query_idx, domain=None):
    """Attach ctxs records; scores are stringified for byte-compatible files."""
    if len(valid_query_idx) != len(passages):
        raise ValueError(f"{len(passages)} result rows for {len(valid_query_idx)} queries")
    valid = set(valid_query_idx)
    idx = 0
    for i, ex in enumerate(data):
        if i in valid:
            k = len(passages[idx])
            ex["ctxs"] = [
                {
                    "id": db_ids[idx][c],
                    "source": domain,
                    "retrieval text": passages[idx][c],
                    "retrieval score": str(scores[idx][c]),
                }
                for c in range(k)
            ]
            idx += 1
        else:
            ex["ctxs"] = [None]


def embed_eval_queries(cfg, queries: List[str], device: torch.device, encoder: TorchEncoder | None = None) -> np.ndarray:
    search_args = cfg.evaluation.search
    cache_path = search_args.get("query_embedding_save_path", None)
    if search_args.get("cache_query_embedding", False) and cache_path and os.path.exists(cache_path):
        logger.info("Loading cached query embeddings from %s", cache_path)
        with open(cache_path, "rb") as f:
            return pickle.load(f)

    if encoder is None:
        encoder = load_encoder(cfg.model.query_encoder, device, tokenizer_name=cfg.model.query_tokenizer)
    opts = EncodeOptions(
        batch_size=search_args.get("per_device_batch_size", search_args.get("per_gpu_batch_size", 64)),
        maxlength=search_args.question_maxlength,
        lowercase=search_args.get("lowercase", False),
        normalize_text=search_args.get("normalize_text", False),
        out_dim=projection_out_dim(cfg, encoder),
        packed=bool(search_args.get("packing", False)),
    )
    embeddings = encoder.encode_queries(queries, opts)

    if search_args.get("cache_query_embedding", False) and cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump(embeddings, f)
    return embeddings


def search_dense_topk(cfg, device: torch.device, encoder: TorchEncoder | None = None, tokenizer=None) -> None:
    index_args = cfg.datastore.index
    eval_args = cfg.evaluation
    groups = _shard_groups(index_args.index_shard_ids)

    all_exist = all(os.path.exists(get_search_output_path(cfg, g)) for g in groups)
    if all_exist and not eval_args.search.overwrite:
        logger.info("All search results exist, skipping search")
    else:
        data = load_eval_data(cfg, tokenizer=tokenizer)
        queries, valid_query_idx = [], []
        for i, ex in enumerate(data):
            if ex.get("raw_query"):
                queries.append(ex["raw_query"])
                valid_query_idx.append(i)
        logger.info("Searching %d queries from %d eval samples", len(queries), len(data))

        query_embs = embed_eval_queries(cfg, queries, device, encoder)
        if eval_args.search.get("cache_query_embedding_only", False):
            return

        for group in groups:
            output_path = get_search_output_path(cfg, group)
            if os.path.exists(output_path) and not eval_args.search.overwrite:
                logger.info("%s exists, skipping", output_path)
                continue
            copied = copy.deepcopy(data)
            index = Indexer(cfg, device, index_shard_ids=group)
            scores, passages, db_ids = index.search(query_embs, eval_args.search.n_docs)
            add_passages_to_eval_data(
                copied, passages, scores, db_ids, valid_query_idx, domain=cfg.datastore.domain
            )
            os.makedirs(os.path.dirname(output_path), exist_ok=True)
            safe_write_jsonl(copied, output_path)

    if eval_args.search.get("merge_multi_source_results", False) and eval_args.search.get(
        "topk_subsample_p", None
    ):
        from retrieval_scaling_tpu_torch.search.postprocess import post_hoc_merge_topk_multi_domain

        post_hoc_merge_topk_multi_domain(cfg)
    elif eval_args.search.get("merge_multi_index_results", True):
        post_hoc_merge_topk(cfg)


def _read_group_file(path: str) -> List[dict]:
    data = []
    for ex in read_jsonl(path):
        if not ex.get("ctxs") or ex["ctxs"][0] is None:
            ex["ctxs"] = []
        data.append(ex)
    return data


def post_hoc_merge_topk(cfg) -> None:
    """Merge per-group result files: concat ctxs, sort by score desc,
    truncate to n_docs."""
    groups = _shard_groups(cfg.datastore.index.index_shard_ids)
    output_path = get_merged_search_output_path(cfg)
    if os.path.exists(output_path) and not cfg.evaluation.search.overwrite:
        logger.info("Merged output exists: %s", output_path)
        return
    if len(groups) <= 1:
        logger.info("Single-index mode: nothing to merge")
        return

    n_docs = cfg.evaluation.search.n_docs
    merged: List[dict] = []
    for i, group in enumerate(groups):
        part = _read_group_file(get_search_output_path(cfg, group))
        if i == 0:
            merged = part
            continue
        for ex_merged, ex_new in zip(merged, part):
            if ex_merged["raw_query"] != ex_new["raw_query"]:
                raise ValueError("per-group result files disagree on their queries")
            ex_merged["ctxs"].extend(ex_new["ctxs"])
            if ex_merged["ctxs"]:
                ex_merged["ctxs"] = sorted(
                    ex_merged["ctxs"], key=lambda c: float(c["retrieval score"]), reverse=True
                )[:n_docs]

    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    safe_write_jsonl(merged, output_path)


def search_topk(cfg, device: torch.device, encoder: TorchEncoder | None = None, tokenizer=None) -> None:
    """Task entry: sparse (BM25, on the host) or dense search."""
    if cfg.model.get("sparse_retriever", None):
        from retrieval_scaling_tpu_torch.search.bm25 import search_sparse_topk

        search_sparse_topk(cfg)
    else:
        search_dense_topk(cfg, device, encoder=encoder, tokenizer=tokenizer)
