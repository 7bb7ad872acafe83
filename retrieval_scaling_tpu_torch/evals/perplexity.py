"""Retrieval-augmented perplexity with a PyTorch reader LM.

Ports ``retrieval_scaling_tpu/evals/perplexity.py`` (single device):

  * ``build_doc_prompts`` prepends up to ``concate_k`` retrieved docs in
    reverse relevance order with ``' \\n'`` separators;
  * context tokens are label-masked to -100 and rows left-truncate to the
    reader's ``max_position_embeddings``;
  * rows are length-sorted into fixed (batch, bucket) shapes, as in the JAX
    reader, and scored by one forward each of a GPT-NeoX or llama-family
    reader; on the card the loss streams the vocab head block by block
    (``models/loss.py``);
  * PPL = exp(avg loss), bits-per-byte = log2(PPL) / 8, one-line log record;
  * ``build_doc_prompts`` drops docs that overlap the answer
    (``evaluation.decontamination``) and can place each doc's continuation
    (``use_continuation``) or both (``use_both_doc_and_continuation``);
  * ``evaluate_calibration`` (``task_name=perplexity_calibration``) scores
    the answer under each retrieved doc alone and reports the min-loss
    mixture, writing the per-example losses to ``calibration_losses.pkl``.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from retrieval_scaling_tpu_torch.data.eval_data import load_eval_data
from retrieval_scaling_tpu_torch.search.driver import (
    get_merged_search_output_path,
    get_search_output_path,
    read_jsonl,
)
from retrieval_scaling_tpu_torch.utils.decontamination import check_below_lexical_overlap_threshold

logger = logging.getLogger(__name__)

IGNORE = -100


@dataclass
class PplEvalOutput:
    cfg: object
    average_loss: float
    perplexity: float
    bit_per_byte: float
    no_enough_docs_count: int = 0

    def log_message(self) -> str:
        cfg = self.cfg
        msg = (
            f"Domain = {cfg.evaluation.domain}"
            f"\t DS_domain = {cfg.datastore.domain}"
            f"\tconcate_k = {cfg.evaluation.concate_k}"
            f"\tavg Loss = {self.average_loss:.4f}"
            f"\tperplexity = {self.perplexity:.4f}"
            f"\tbpb = {self.bit_per_byte:.4f}"
            f"\ttotal shards = {cfg.datastore.embedding.num_shards}"
            f"\tsampled shards = {len(cfg.datastore.index.index_shard_ids)}"
            f"\t#eval samples = {cfg.evaluation.data.num_eval_samples}"
            f"\tds chunk size = {cfg.datastore.embedding.chunk_size}"
            f"\teval chunk size = {cfg.evaluation.data.max_eval_data_seq_length}"
            f"\teval stride = {cfg.evaluation.data.eval_stride}"
            f"\tall shards = {cfg.datastore.index.index_shard_ids}"
        )
        if self.no_enough_docs_count:
            msg += f"\tno enough docs = {self.no_enough_docs_count}"
        return msg


# ---------------------------------------------------------------- prompts
def extract_answer(raw_inputs: str, raw_query: str) -> str:
    inputs = raw_inputs.replace("<|endoftext|>", "")
    query = raw_query.replace("<|endoftext|>", "")
    answer = inputs.replace(query, "")
    if answer == inputs and query:
        answer = inputs.replace(query[:-1], "")
    if answer == inputs and query:
        answer = inputs[-len(inputs) // 2 :]
    return answer


def build_doc_prompts(eval_data: List[dict], eval_args) -> Tuple[List[str], List[str], int]:
    """(contexts, answers, no_enough_docs_count); context = docs + query."""
    num_docs = eval_args.concate_k
    decon = eval_args.get("decontamination", False)
    threshold = eval_args.get("contamination_threshold", 0.5)
    method = eval_args.get("decontamination_method", "longest")
    use_cont = eval_args.get("use_continuation", False)
    use_both = eval_args.get("use_both_doc_and_continuation", False)

    contexts, answers = [], []
    no_enough_docs = 0
    # the first stride window has no query prefix and is not scored
    for ex in eval_data[1:]:
        answer = extract_answer(ex["raw_inputs"], ex["raw_query"])
        doc = ""
        if num_docs > 0 and ex.get("ctxs") and ex["ctxs"][0] is not None:
            added, idx = 0, 0
            while added < num_docs and idx < len(ex["ctxs"]):
                ctx = ex["ctxs"][idx]
                if use_both:
                    text = ctx["retrieval text"] + ctx["retrieval next text"] + " \n"
                elif use_cont:
                    text = ctx["retrieval next text"] + " \n"
                else:
                    text = ctx["retrieval text"] + " \n"
                if not decon or check_below_lexical_overlap_threshold(text, answer, threshold, method):
                    doc = text + doc  # reverse order: most relevant closest to the query
                    added += 1
                idx += 1
            if added < num_docs:
                no_enough_docs += 1
        contexts.append(doc + ex["raw_query"])
        answers.append(answer)
    return contexts, answers, no_enough_docs


# ---------------------------------------------------------------- scoring
def _bucketize(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def make_row_loss_fn(cfg):
    """``fn(model, ids, labels) -> (NLL sum [B], scored-token count [B])``
    over a padded batch; position t scores label t+1."""
    from retrieval_scaling_tpu_torch.models.hf_convert import (
        reader_hidden,
        reader_logits,
        reader_logits_from_hidden,
    )
    from retrieval_scaling_tpu_torch.models.loss import blockwise_row_lm_loss, use_blockwise

    def fn(model, ids, labels):
        if use_blockwise(ids.shape[1], cfg.vocab_size, ids.device):
            hidden = reader_hidden(model, cfg, ids)
            return blockwise_row_lm_loss(lambda h: reader_logits_from_hidden(model, cfg, h), hidden, labels)
        logits = reader_logits(model, cfg, ids)
        shift_labels = labels[:, 1:]
        mask = shift_labels != IGNORE
        safe = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
        logprobs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        token_ll = torch.gather(logprobs, -1, safe[..., None])[..., 0]
        return -(token_ll * mask).sum(dim=-1), mask.sum(dim=-1)

    return fn


class TorchReader:
    """Batched scorer around a reader module (GPT-NeoX or llama family) on one device."""

    def __init__(self, model, tokenizer, device: torch.device, batch_size: int = 8, dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self._row_loss = make_row_loss_fn(self.cfg)

    @classmethod
    def from_pretrained(cls, path: str, device: torch.device, batch_size: int = 8, dtype: torch.dtype = torch.bfloat16):
        from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_reader, load_tokenizer

        model = load_hf_reader(path, device=device, dtype=dtype)
        return cls(model, load_tokenizer(path), device, batch_size, dtype)

    def score(self, contexts: List[str], targets: List[str]) -> List[float]:
        """Per-sample mean NLL over target tokens (context label-masked,
        rows left-truncated to the reader's max positions)."""
        max_pos = self.cfg.max_position_embeddings
        rows = []
        for i, (ctx, tgt) in enumerate(zip(contexts, targets)):
            ctx_ids = self.tokenizer(ctx)["input_ids"]
            tgt_ids = self.tokenizer(tgt)["input_ids"]
            ids = (ctx_ids + tgt_ids)[-max_pos:]
            labels = ([IGNORE] * len(ctx_ids) + tgt_ids)[-max_pos:]
            rows.append((i, ids, labels))

        buckets = [b for b in (128, 256, 512, 1024, 2048, 4096) if b < max_pos]
        buckets.append(max_pos)
        per_sample = np.zeros(len(rows), np.float64)
        rows.sort(key=lambda r: len(r[1]))
        pad_id = (
            self.tokenizer.pad_token_id
            if self.tokenizer.eos_token_id is None
            else self.tokenizer.eos_token_id
        )

        with torch.inference_mode():
            for pos in range(0, len(rows), self.batch_size):
                batch = rows[pos : pos + self.batch_size]
                bucket = _bucketize(max(len(r[1]) for r in batch), buckets)
                ids_np = np.full((self.batch_size, bucket), pad_id, np.int64)
                lab_np = np.full((self.batch_size, bucket), IGNORE, np.int64)
                for row, (_, ids, labels) in enumerate(batch):
                    ids_np[row, : len(ids)] = ids
                    lab_np[row, : len(labels)] = labels
                loss_sums, counts = self._row_loss(
                    self.model,
                    torch.from_numpy(ids_np).to(self.device),
                    torch.from_numpy(lab_np).to(self.device),
                )
                loss_sums = loss_sums.double().cpu().numpy()
                counts = counts.cpu().numpy()
                for row, (orig, _, _) in enumerate(batch):
                    per_sample[orig] = loss_sums[row] / max(int(counts[row]), 1)
        return per_sample.tolist()


# ---------------------------------------------------------------- drivers
def _load_eval_examples(cfg) -> List[dict]:
    eval_args = cfg.evaluation
    if not eval_args.concate_k:  # LM-only
        return load_eval_data(cfg)
    path = eval_args.search.get("merged_path", None) or get_merged_search_output_path(cfg)
    if not os.path.exists(path):
        # single-group runs write only the per-group file
        groups = cfg.datastore.index.index_shard_ids
        if groups and not isinstance(groups[0], (list, tuple)):
            path = get_search_output_path(cfg, groups)
        elif len(groups) == 1:
            path = get_search_output_path(cfg, groups[0])
    return read_jsonl(path)


def _reader(cfg, device: torch.device) -> TorchReader:
    return TorchReader.from_pretrained(
        cfg.model.lm_model, device, batch_size=cfg.evaluation.get("per_device_eval_batch_size", 8)
    )


def evaluate_perplexity(cfg, device: torch.device, reader: TorchReader | None = None) -> PplEvalOutput:
    """Task entry (reference: src/evaluate_perplexity.py:72-149)."""
    if cfg.tasks.eval.task_name == "perplexity_calibration":
        return evaluate_calibration(cfg, device, reader)
    eval_args = cfg.evaluation
    eval_data = _load_eval_examples(cfg)
    contexts, answers, no_enough = build_doc_prompts(eval_data, eval_args)

    if reader is None:
        reader = _reader(cfg, device)

    per_sample = reader.score(contexts, answers)
    average_loss = float(np.mean(per_sample))
    perplexity = math.exp(average_loss)
    bit_per_byte = math.log2(perplexity) / 8

    out = PplEvalOutput(cfg, average_loss, perplexity, bit_per_byte, no_enough)
    logger.info(out.log_message())
    return out


def evaluate_calibration(cfg, device: torch.device, reader: TorchReader | None = None) -> PplEvalOutput:
    """Per-document calibration: score the answer under each retrieved doc
    separately and report the min-loss mixture
    (reference: src/evaluate_perplexity.py:219-324)."""
    eval_args = cfg.evaluation
    eval_data = _load_eval_examples(cfg)
    if reader is None:
        reader = _reader(cfg, device)

    k = eval_args.concate_k
    contexts, answers, owners, scores = [], [], [], []
    for i, ex in enumerate(eval_data[1:]):
        answer = extract_answer(ex["raw_inputs"], ex["raw_query"])
        ctxs = [c for c in (ex.get("ctxs") or []) if c is not None][:k]
        if not ctxs:
            contexts.append(ex["raw_query"])
            answers.append(answer)
            owners.append(i)
            scores.append(None)
            continue
        for ctx in ctxs:
            contexts.append(ctx["retrieval text"] + " \n" + ex["raw_query"])
            answers.append(answer)
            owners.append(i)
            scores.append(float(ctx["retrieval score"]))

    per_sample = reader.score(contexts, answers)

    by_example: dict = {}
    for loss, owner, score in zip(per_sample, owners, scores):
        by_example.setdefault(owner, []).append((loss, score))

    min_losses = [min(loss for loss, _ in pairs) for pairs in by_example.values()]
    average_loss = float(np.mean(min_losses))
    perplexity = math.exp(average_loss)
    bit_per_byte = math.log2(perplexity) / 8

    out_dir = eval_args.get("calibration_out_dir", None)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "calibration_losses.pkl"), "wb") as f:
            pickle.dump(by_example, f)

    out = PplEvalOutput(cfg, average_loss, perplexity, bit_per_byte)
    logger.info(out.log_message())
    return out
