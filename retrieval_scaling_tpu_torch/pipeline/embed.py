"""Datastore embedding stage: shard -> chunk -> encode -> pickle.

Ports ``retrieval_scaling_tpu/pipeline/embed.py`` (dense only): a per-shard
loop with skip-if-exists and ``passages_{i:02d}.pkl`` ``(ids, fp16 [N, D])``
output shards, the files the JAX package and the reference write;
``datastore.embedding.quantization`` and ``.packing`` go to the encoder.
"""

from __future__ import annotations

import logging
import os
import pickle

import torch

from retrieval_scaling_tpu_torch.data.sharding import load_jsonl_shard
from retrieval_scaling_tpu_torch.search.encoder import EncodeOptions, TorchEncoder, load_encoder

logger = logging.getLogger(__name__)


def embedding_shard_path(args, shard_id: int) -> str:
    return os.path.join(args.embedding_dir, f"{args.prefix}_{shard_id:02d}.pkl")


def generate_passage_embeddings(cfg, device: torch.device, encoder: TorchEncoder | None = None) -> None:
    if cfg.model.get("sparse_retriever", None):
        logger.info("sparse retriever configured; skipping the embedding step")
        return
    args = cfg.datastore.embedding
    os.makedirs(args.embedding_dir, exist_ok=True)

    todo = []
    for shard_id in list(args.shard_ids):
        out_path = embedding_shard_path(args, shard_id)
        if os.path.exists(out_path) and args.get("use_saved_if_exists", True):
            logger.info("Embeddings exist, skipping shard %d (%s)", shard_id, out_path)
            continue
        todo.append(shard_id)
    if not todo:
        return

    if encoder is None:
        encoder = load_encoder(args.model_name_or_path, device, tokenizer_name=args.get("tokenizer", None),
                               quantize=args.get("quantization", "none") or "none")

    # truncate to the index's projection size when the encoder is wider
    proj = args.get("projection_size", None) or cfg.datastore.index.get("projection_size", None)
    out_dim = proj if proj and proj < encoder.cfg.hidden_size else None
    opts = EncodeOptions(
        batch_size=args.get("per_device_batch_size", args.get("per_gpu_batch_size", 512)),
        maxlength=args.passage_maxlength,
        lowercase=args.get("lowercase", False),
        normalize_text=args.get("normalize_text", False),
        no_title=args.get("no_title", False),
        out_dim=out_dim,
        packed=bool(args.get("packing", False)),
    )

    for shard_id in todo:
        out_path = embedding_shard_path(args, shard_id)
        passages = load_jsonl_shard(args, shard_id)
        if not passages:
            logger.warning("Shard %d produced no passages", shard_id)
            continue
        logger.info("Embedding shard %d: %d passages", shard_id, len(passages))
        ids, embeddings = encoder.encode_passages(passages, opts)
        tmp = out_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump((ids, embeddings), f)
        os.replace(tmp, out_path)
        logger.info("Wrote %s: %s", out_path, embeddings.shape)
