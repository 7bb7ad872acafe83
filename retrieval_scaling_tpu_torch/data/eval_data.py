"""Evaluation-data preparation (perplexity windows, lm-eval/mmlu queries).

A copy of ``retrieval_scaling_tpu/data/eval_data.py``: the port never imports
the JAX package. ``tests/test_torch_pipeline.py`` holds it to the original.

Parity with the reference eval-data prep (reference: src/data.py:271-436):

  * ``perplexity``: tokenize every document with the *reader* tokenizer,
    concatenate (``merge=True``), then slide a window of
    ``max_eval_data_seq_length`` with stride ``eval_stride``; only the new
    suffix of each window is scored, the prefix acts as the retrieval query.
    Records carry decoded ``raw_inputs`` (full window) and ``raw_query``
    (unscored prefix), exactly the reference's fields.
  * ``lm-eval``: ``query`` -> ``raw_query``.
  * ``mmlu``: ``prompt_end`` -> ``raw_query``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def load_jsonl(path: str) -> List[dict]:
    assert os.path.exists(path), path
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_parquet(path: str) -> List[dict]:
    import pandas as pd

    df = pd.read_parquet(path)
    return [{"text": t} for t in df.text if t]


def stride_windows(
    flat_ids: np.ndarray,
    max_seq_length: int,
    stride: int,
    pad_token_id: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stride-window a flat token stream into (inputs, targets) pairs.

    Targets are next-token labels with everything before the new suffix (and
    padding) set to ``pad_token_id`` (reference: src/data.py:389-428 — the pad
    id doubles as the "not scored" marker so queries stay decodable).
    """
    all_inputs, all_targets = [], []
    prev_end = 0
    n = len(flat_ids)
    for begin in range(0, n - 1, stride):
        end = min(begin + max_seq_length, n - 1)
        trg_len = end - prev_end

        input_ids = flat_ids[begin:end].copy()
        target_ids = flat_ids[begin + 1 : end + 1].copy()
        target_ids[: len(target_ids) - trg_len] = pad_token_id

        if end == n - 1 and len(input_ids) < max_seq_length:
            pads = np.full(max_seq_length - len(input_ids), pad_token_id, dtype=flat_ids.dtype)
            input_ids = np.concatenate([input_ids, pads])
            target_ids = np.concatenate([target_ids, pads])

        all_inputs.append(input_ids)
        all_targets.append(target_ids)
        prev_end = end
        if end == n - 1:
            break
    return np.stack(all_inputs), np.stack(all_targets)


def prepare_perplexity_eval_data(
    data: List[dict],
    tokenizer,
    max_seq_length: int,
    stride: int,
    merge: bool = True,
    num_eval_samples: int | None = None,
    seed: int = 310,
) -> List[dict]:
    if tokenizer is None:
        return [{"raw_inputs": ex["text"]} for ex in data]

    token_lists = [tokenizer(ex["text"])["input_ids"] for ex in data]
    pad_id = tokenizer.pad_token_id if tokenizer.eos_token_id is None else tokenizer.eos_token_id

    if merge:
        flat = np.asarray([t for ids in token_lists for t in ids])
        inputs, targets = stride_windows(flat, max_seq_length, stride, pad_id)
    else:
        parts = [stride_windows(np.asarray(ids), max_seq_length, stride, pad_id) for ids in token_lists]
        inputs = np.concatenate([p[0] for p in parts], axis=0)
        targets = np.concatenate([p[1] for p in parts], axis=0)

    if num_eval_samples:
        rng = np.random.RandomState(seed)
        keep = rng.permutation(len(inputs))[:num_eval_samples]
        inputs, targets = inputs[keep], targets[keep]

    records = []
    for ids, tgt in zip(inputs, targets):
        query_ids = [int(i) for i, t in zip(ids.tolist(), tgt.tolist()) if t == pad_id]
        records.append(
            {
                "raw_inputs": tokenizer.decode(ids.tolist(), skip_special_tokens=True),
                "raw_query": tokenizer.decode(query_ids, skip_special_tokens=True),
            }
        )
    logger.info("Built %d perplexity evaluation windows", len(records))
    return records


def prepare_lm_eval_data(data: List[dict]) -> List[dict]:
    for ex in data:
        ex["raw_query"] = ex["query"]
    return data


def prepare_mmlu_eval_data(data: List[dict]) -> List[dict]:
    for ex in data:
        ex["raw_query"] = ex["prompt_end"]
    return data


def load_eval_data(cfg, tokenizer=None) -> List[dict]:
    """Load + prepare eval data per ``tasks.eval.task_name`` (reference: src/data.py:271-307)."""
    path = cfg.evaluation.data.eval_data
    task_name = cfg.tasks.eval.task_name

    if tokenizer is None:
        from retrieval_scaling_tpu_torch.models.hf_convert import load_tokenizer

        tokenizer = load_tokenizer(cfg.model.lm_model)

    if path.endswith(".jsonl"):
        data = load_jsonl(path)
    elif path.endswith(".parquet"):
        data = load_parquet(path)
    else:
        raise ValueError(f"Unsupported eval data format: {path}")

    if task_name in ("perplexity", "perplexity_calibration"):
        args = cfg.evaluation.data
        return prepare_perplexity_eval_data(
            data,
            tokenizer,
            args.max_eval_data_seq_length,
            args.eval_stride,
            args.merge,
            args.num_eval_samples,
            args.seed,
        )
    if task_name == "lm-eval":
        return prepare_lm_eval_data(data)
    if task_name == "mmlu":
        return prepare_mmlu_eval_data(data)
    raise ValueError(f"Unknown eval task: {task_name!r}")
