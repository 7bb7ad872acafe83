"""Multi-source merge and retrieval post-processing, host-only.

A copy of ``retrieval_scaling_tpu/search/postprocess.py`` (the port
imports nothing of the JAX package) over the port's own driver, eval-data
and deduplication modules; ``tests/test_torch_offline.py`` holds its
output files to the original's, byte for byte.

Multi-source merge + retrieval post-processing.

Parity with the reference's multi-domain pipeline
(reference: src/search.py:386-546): merge per-domain result files (domain
annotated from the path), rerank by score, MinHash dedup with query
decontamination, coin-flip top-k subsampling, optional lexical rerankers,
and short-chunk removal — producing the
``full_subsampled_{p}_{seed}_*.jsonl`` artifact the eval stage consumes.
"""

from __future__ import annotations

import logging
import os
import random
import re
from collections import Counter
from typing import Dict, List

from retrieval_scaling_tpu_torch.data.eval_data import load_eval_data, load_jsonl
from retrieval_scaling_tpu_torch.search.driver import read_jsonl, safe_write_jsonl
from retrieval_scaling_tpu_torch.utils.deduplication import multiprocess_deduplication

logger = logging.getLogger(__name__)

_DOMAIN_RE = re.compile(r"/([^/]+)_datastore")


def subsample_by_coin_flip(items: List, probability: float) -> List:
    return [item for item in items if random.random() < probability]


def merge_result_files(paths: List[str], n_docs: int) -> List[dict]:
    merged: List[dict] = []
    for domain_idx, path in enumerate(paths):
        logger.info("Merging %s", path)
        matches = _DOMAIN_RE.findall(path)
        ds_domain = matches[0] if matches else None

        part = []
        for ex in read_jsonl(path):
            if not ex.get("ctxs") or ex["ctxs"][0] is None:
                ex["ctxs"] = []
            else:
                for ctx in ex["ctxs"]:
                    if not ctx.get("source"):
                        ctx["source"] = ds_domain
            part.append(ex)

        if domain_idx == 0:
            merged = part
            continue
        for ex_merged, ex_new in zip(merged, part):
            assert ex_merged["raw_query"] == ex_new["raw_query"]
            ex_merged["ctxs"].extend(ex_new["ctxs"])
            if ex_merged["ctxs"]:
                ex_merged["ctxs"] = sorted(
                    ex_merged["ctxs"], key=lambda c: float(c["retrieval score"]), reverse=True
                )[:n_docs]
    return merged


# ---------------------------------------------------------------- rerankers
def normalize_answer_text(text: str) -> str:
    """SQuAD-style normalization (reference: src/search.py:755-766)."""
    text = text.lower()
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def inclusion_metric(ctx_text: str, answers: List[str]) -> int:
    if not ctx_text or not answers:
        return 0
    norm_ctx = normalize_answer_text(ctx_text)
    return max(1 if normalize_answer_text(a) in norm_ctx else 0 for a in answers)


def unigram_f1_metric(ctx_text: str, answers: List[str]) -> float:
    if not ctx_text or not answers:
        return 0.0
    ctx_tokens = normalize_answer_text(ctx_text).split()
    ctx_counts = Counter(ctx_tokens)
    best = 0.0
    for answer in answers:
        ans_tokens = normalize_answer_text(answer).split()
        common = sum((ctx_counts & Counter(ans_tokens)).values())
        if common == 0 or not ctx_tokens or not ans_tokens:
            continue
        p = common / len(ctx_tokens)
        r = common / len(ans_tokens)
        best = max(best, 2 * p * r / (p + r))
    return best


def rerank_ctxs(ctxs: List[dict], answers: List[str], method: str) -> List[dict]:
    good = [c for c in ctxs if c.get("quality score", 1)]
    bad = [c for c in ctxs if not c.get("quality score", 1)]
    if method == "inclusion":
        good.sort(key=lambda c: inclusion_metric(c["retrieval text"], answers), reverse=True)
    elif method == "unigram_f1":
        good.sort(key=lambda c: unigram_f1_metric(c["retrieval text"], answers), reverse=True)
    elif method == "lexical":
        # stable multi-key: retrieval score, then unigram F1, then inclusion
        good.sort(key=lambda c: float(c["retrieval score"]), reverse=True)
        good.sort(key=lambda c: unigram_f1_metric(c["retrieval text"], answers), reverse=True)
        good.sort(key=lambda c: inclusion_metric(c["retrieval text"], answers), reverse=True)
    else:
        raise ValueError(f"Unknown rerank method: {method!r}")
    return good + bad


def extract_rerank_docs(ctxs: List[dict], rerank_n_docs):
    filtered = [c for c in ctxs if c.get("quality score")]
    if rerank_n_docs is None or len(filtered) >= rerank_n_docs:
        return filtered[:rerank_n_docs], 0
    return filtered, 1


def remove_short_chunks(ctxs: List[dict], min_words: int = 12) -> List[dict]:
    return [c for c in ctxs if len(c["retrieval text"].split(" ")) > min_words]


def extract_ppl_answer(raw_inputs: str, raw_query: str) -> str:
    inputs = raw_inputs.replace("<|endoftext|>", "")
    query = raw_query.replace("<|endoftext|>", "")
    answer = inputs.replace(query, "")
    if answer == inputs and query:
        answer = inputs.replace(query[:-1], "")
    if answer == inputs:
        answer = inputs[-len(inputs) // 2 :]
    return answer


def get_answers(cfg) -> Dict[str, List[str]] | List[List[str]]:
    """Gold answers for reranking (reference: src/search.py:637-663)."""
    task = cfg.tasks.eval.task_name
    if task == "perplexity":
        eval_data = load_eval_data(cfg)
        return {
            ex["raw_query"]: [extract_ppl_answer(ex["raw_inputs"], ex["raw_query"])]
            for ex in eval_data
        }
    answer_path = cfg.evaluation.search.answer_path
    answers: Dict[str, List[str]] = {}
    for ex in load_jsonl(answer_path):
        if "triviaqa" in answer_path:
            answers[ex["query"]] = ex["answer"]["normalized_aliases"]
        else:
            ans = ex["answer"]
            answers[ex["query"]] = ans if isinstance(ans, list) else [ans]
    return answers


# ---------------------------------------------------------------- pipeline
def post_hoc_merge_topk_multi_domain(cfg) -> None:
    search_args = cfg.evaluation.search
    paths_file = search_args.paths_to_merge
    base_merged_path = search_args.merged_path
    merged_path = os.path.join(
        os.path.dirname(base_merged_path),
        os.path.basename(base_merged_path).removeprefix("dedup_"),
    )

    use_saved = search_args.get("use_saved_dedup_data", False)
    if os.path.exists(base_merged_path) and use_saved:
        merged = read_jsonl(base_merged_path)
    else:
        if os.path.exists(merged_path):
            merged = read_jsonl(merged_path)
        else:
            with open(paths_file) as f:
                paths = [line.strip() for line in f if line.strip()]
            for p in paths:
                assert os.path.exists(p), p
            merged = merge_result_files(paths, search_args.n_docs)
            os.makedirs(os.path.dirname(merged_path), exist_ok=True)
            safe_write_jsonl(merged, merged_path)

        merged = multiprocess_deduplication(merged)
        os.makedirs(os.path.dirname(base_merged_path), exist_ok=True)
        safe_write_jsonl(merged, base_merged_path)

    seed = search_args.get("subsample_seed", 1000)
    p_sub = search_args.get("topk_subsample_p", 1)
    if p_sub < 1:
        random.seed(seed)
        for ex in merged:
            ex["ctxs"] = subsample_by_coin_flip(ex["ctxs"], p_sub)

    method = search_args.get("rerank_method", None)
    if method:
        rerank_n_docs = search_args.get("rerank_n_docs", None)
        short_count = 0
        for ex in merged:
            ex["ctxs"], missing = extract_rerank_docs(ex["ctxs"], rerank_n_docs)
            short_count += missing
        if short_count:
            logger.warning("%d examples lack enough docs for reranking", short_count)
        answers = get_answers(cfg)
        for ex in merged:
            ex["ctxs"] = rerank_ctxs(ex["ctxs"], answers.get(ex["raw_query"], []), method)

    for ex in merged:
        ex["ctxs"] = remove_short_chunks(ex["ctxs"])

    low = sum(1 for ex in merged if len(ex["ctxs"]) < 3)
    if low:
        logger.warning("%d examples have fewer than 3 docs after post-processing", low)

    output_path = os.path.join(
        os.path.dirname(base_merged_path),
        f"full_subsampled_{p_sub}_{seed}_{os.path.basename(base_merged_path)}",
    )
    if method:
        output_path = output_path.replace(".jsonl", f"_rerank_{method}.jsonl")
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    safe_write_jsonl(merged, output_path)
    logger.info("Saved multi-domain merged results to %s", output_path)
