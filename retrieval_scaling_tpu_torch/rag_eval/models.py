"""The reader backend of the RAG evaluation harness, on PyTorch.

Ports ``encode_pair``, ``_bucket``, ``chat_template_formatter`` and
``JaxReaderLM`` (as ``TorchReaderLM``) of ``retrieval_scaling_tpu/rag_eval/models.py``.
The backend implements the lm-eval ``LM`` contract (reference:
rag-evaluation-harness/lm_eval/api/model.py): ``loglikelihood(pairs) ->
[(ll_sum, is_greedy)]``, ``loglikelihood_rolling(texts) -> [ll]`` and
``generate_until(reqs) -> [text]``, over a GPT-NeoX reader on one explicit
device, with length-bucketed batches padded to ``batch_size`` rows (as in
JAX, so the quantized matmuls see the same row counts), KV-cache
generation (``gen_engine`` "static", "continuous", "speculative" or
"continuous_spec": prompt-lookup speculative decoding with ``draft_len``
drafted tokens a round, alone or in the slot pool), quantized weights
(``quantization`` None, "int8", "int4" or "bf16") and an int8 KV cache,
for GPT-NeoX and llama-family readers. Scoring at long rows streams the
vocab head block by block on the card (``models/loss.py``).

Mamba (module 16), data parallelism and tensor parallelism (module 14)
raise ``NotImplementedError``. The harness CLI around the
backend (``rag_eval/__main__.py``, the task registry, the evaluator) waits
for module 12.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def encode_pair(tokenizer, ctx: str, cont: str, eos_id: int):
    """(ctx_ids, cont_ids): jointly encoded then split at the context
    length, lm-eval style; trailing context whitespace moves onto the
    continuation so the split falls on a token boundary."""
    n_spaces = len(ctx) - len(ctx.rstrip())
    if n_spaces > 0:
        cont = ctx[-n_spaces:] + cont
        ctx = ctx[:-n_spaces]
    if not ctx:
        return [eos_id], tokenizer(cont, add_special_tokens=False)["input_ids"]
    whole = tokenizer(ctx + cont)["input_ids"]
    ctx_ids = tokenizer(ctx)["input_ids"]
    cont_ids = whole[len(ctx_ids):]
    if not cont_ids:
        # retokenization merged the boundary token: encode the continuation alone
        cont_ids = tokenizer(cont, add_special_tokens=False)["input_ids"]
        ctx_ids = whole[: max(len(whole) - len(cont_ids), 1)]
    return ctx_ids, cont_ids


def _bucket(length: int, cap: int) -> int:
    b = 32
    while b < length:
        b *= 2
    return min(b, max(cap, 1))


def chat_template_formatter(tokenizer):
    """Render a prompt through the tokenizer's chat template (lm_eval
    --apply_chat_template)."""

    def fmt(context: str, system_instruction=None, shots=None) -> str:
        messages = []
        if system_instruction:
            messages.append({"role": "system", "content": system_instruction})
        for shot_q, shot_a in shots or []:
            messages.append({"role": "user", "content": shot_q})
            messages.append({"role": "assistant", "content": shot_a})
        messages.append({"role": "user", "content": context})
        return tokenizer.apply_chat_template(messages, tokenize=False, add_generation_prompt=True)

    return fmt


class TorchReaderLM:
    """PyTorch reader backend: GPT-NeoX / Pythia or the llama family on one device."""

    def __init__(self, model, cfg, tokenizer, batch_size: int = 8, max_length: int | None = None, mesh=None,
                 quantization: str | None = None, kv_cache: str | None = None, gen_engine: str | None = None,
                 draft_len: int = 7, tensor_parallel: bool = False):
        from retrieval_scaling_tpu_torch.models.generate import embedding
        from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig
        from retrieval_scaling_tpu_torch.models.llama import LlamaConfig

        if not isinstance(cfg, (GPTNeoXConfig, LlamaConfig)):
            raise NotImplementedError(f"{type(cfg).__name__} readers wait for module 16 (mamba)")
        if quantization not in (None, "", "none", "int8", "int4", "bf16"):
            raise ValueError(f"unknown reader quantization {quantization!r}")
        if kv_cache not in (None, "", "none", "int8"):
            raise ValueError(f"unknown kv_cache {kv_cache!r}")
        if gen_engine not in (None, "", "static", "continuous", "speculative", "continuous_spec"):
            raise ValueError(f"unknown gen_engine {gen_engine!r}")
        if mesh is not None or tensor_parallel:
            raise NotImplementedError("data- and tensor-parallel readers wait for module 14")
        if quantization in ("int8", "int4", "bf16"):
            # one quantized parameter set serves scoring and generation
            from retrieval_scaling_tpu_torch.models.generate import quantize_decode_params

            model = quantize_decode_params(model, cfg, scheme=quantization)
        self.model, self.cfg, self.tokenizer = model, cfg, tokenizer
        self.device = embedding(model).weight.device
        self.kv_cache = kv_cache if kv_cache == "int8" else None
        self.batch_size = batch_size
        self.max_length = max_length or cfg.max_position_embeddings
        self.gen_engine = gen_engine or "static"
        self.draft_len = int(draft_len)
        self._gen_fns: dict = {}
        self._cb_engine = None
        self.apply_chat_template = chat_template_formatter(tokenizer)

    @classmethod
    def from_pretrained(cls, name_or_path: str, device, batch_size: int = 8, mesh=None,
                        quantization: str | None = None, kv_cache: str | None = None,
                        gen_engine: str | None = None, draft_len: int = 7, tensor_parallel: bool = False):
        from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_reader, load_tokenizer

        model = load_hf_reader(name_or_path, device=device)
        return cls(model, model.cfg, load_tokenizer(name_or_path), batch_size, mesh=mesh,
                   quantization=quantization, kv_cache=kv_cache, gen_engine=gen_engine, draft_len=draft_len,
                   tensor_parallel=tensor_parallel)

    def _eos_id(self) -> int:
        eos = self.tokenizer.eos_token_id
        return eos if eos is not None else (self.tokenizer.pad_token_id or 0)

    # ------------------------------------------------------------ ll
    @torch.inference_mode()
    def _row_ll(self, ids_np, lab_np):
        from retrieval_scaling_tpu_torch.models.hf_convert import reader_hidden, reader_logits_from_hidden
        from retrieval_scaling_tpu_torch.models.loss import blockwise_row_ll_greedy, use_blockwise

        ids = torch.from_numpy(ids_np).to(self.device)
        labels = torch.from_numpy(lab_np).to(self.device)
        hidden = reader_hidden(self.model, self.cfg, ids)
        head = lambda h: reader_logits_from_hidden(self.model, self.cfg, h)  # noqa: E731
        if use_blockwise(ids.shape[1], self.cfg.vocab_size, ids.device):
            ll, is_greedy = blockwise_row_ll_greedy(head, hidden, labels)
        else:
            logits = head(hidden)
            shift_logits, shift_labels = logits[:, :-1], labels[:, 1:]
            mask = shift_labels != -100
            safe = torch.where(mask, shift_labels, 0)
            logprobs = torch.log_softmax(shift_logits.float(), dim=-1)
            token_ll = logprobs.gather(-1, safe[..., None])[..., 0]
            ll = (token_ll * mask).sum(dim=-1)
            greedy = shift_logits.argmax(dim=-1) == safe
            is_greedy = torch.where(mask, greedy, True).all(dim=-1)
        return ll.double().cpu().numpy(), is_greedy.cpu().numpy()

    def _score_rows(self, rows):
        """(ll, greedy) per row of ``rows = [(key, ids, labels)]``, in
        length-sorted batches of ``batch_size`` rows at a length bucket."""
        order = sorted(range(len(rows)), key=lambda i: len(rows[i][1]))
        out = [None] * len(rows)
        pad_id = self._eos_id()
        for pos in range(0, len(order), self.batch_size):
            take = order[pos: pos + self.batch_size]
            width = _bucket(max(len(rows[i][1]) for i in take), self.max_length)
            ids_np = np.full((self.batch_size, width), pad_id, np.int64)
            lab_np = np.full((self.batch_size, width), -100, np.int64)
            for r, i in enumerate(take):
                ids_np[r, : len(rows[i][1])] = rows[i][1]
                lab_np[r, : len(rows[i][2])] = rows[i][2]
            ll, greedy = self._row_ll(ids_np, lab_np)
            for r, i in enumerate(take):
                out[i] = (float(ll[r]), bool(greedy[r]))
        return out

    def loglikelihood(self, pairs: Sequence[Tuple[str, str]]):
        rows = []
        for ctx, cont in pairs:
            ctx_ids, cont_ids = encode_pair(self.tokenizer, ctx, cont, self._eos_id())
            rows.append((None, (ctx_ids + cont_ids)[-self.max_length:],
                         ([-100] * len(ctx_ids) + cont_ids)[-self.max_length:]))
        return self._score_rows(rows)

    def loglikelihood_rolling(self, texts: Sequence[str]):
        """Whole-document loglikelihood in disjoint max_length windows, each
        anchored by the previous token (EOS for the first); windows of all
        documents pack into length-sorted batches."""
        rows = []
        for di, text in enumerate(texts):
            ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
            pos = 0
            while pos < len(ids):
                prev = self._eos_id() if pos == 0 else ids[pos - 1]
                window = ids[pos: pos + self.max_length - 1]
                rows.append((di, [prev] + window, [-100] + window))
                pos += len(window)
        totals = np.zeros(len(texts), np.float64)
        for (di, _, _), (ll, _) in zip(rows, self._score_rows(rows)):
            totals[di] += ll
        return totals.tolist()

    # ------------------------------------------------------------ gen
    def _gen_fn(self, max_new: int, temperature: float = 0.0):
        key = (max_new, temperature)
        if key not in self._gen_fns:
            if self.gen_engine == "speculative":
                from retrieval_scaling_tpu_torch.models.speculative import make_speculative_generate_fn

                # temperature > 0 runs speculative rejection sampling
                self._gen_fns[key] = make_speculative_generate_fn(
                    self.cfg, max_new, self._eos_id(), draft_len=self.draft_len, kv_cache=self.kv_cache,
                    temperature=temperature)
            else:
                from retrieval_scaling_tpu_torch.models.generate import make_generate_fn

                self._gen_fns[key] = make_generate_fn(self.cfg, max_new, self._eos_id(), kv_cache=self.kv_cache,
                                                      temperature=temperature)
        return self._gen_fns[key]

    def _gen_headroom(self) -> int:
        # a verify segment writes draft_len + 1 positions past the last real
        # token: the prompt budget shrinks only by what overflows the
        # position table, so the truncation (and the text) matches the
        # static engine's whenever max_length leaves slack
        if self.gen_engine != "speculative":
            return 0
        return max(0, self.max_length + self.draft_len + 1 - self.cfg.max_position_embeddings)

    @staticmethod
    def _req_temperature(r: dict) -> float:
        # vLLM-backend semantics: do_sample=False or no temperature -> greedy
        gk = r.get("gen_kwargs", {})
        if not gk.get("do_sample", True):
            return 0.0
        return max(float(gk.get("temperature", 0.0)), 0.0)

    def _decode(self, toks) -> str:
        eos = self._eos_id()
        return self.tokenizer.decode([t for t in toks if t != eos], skip_special_tokens=True)

    @staticmethod
    def _cut_at_stops(text: str, stops) -> str:
        for stop in stops:
            idx = text.find(stop)
            if idx >= 0:
                text = text[:idx]
        return text

    def _generate_continuous(self, reqs: Sequence[dict]) -> List[str]:
        from retrieval_scaling_tpu_torch.models.continuous_batching import ContinuousBatcher

        if self._cb_engine is None:
            self._cb_engine = ContinuousBatcher(self.model, self.cfg, self._eos_id(), slots=self.batch_size,
                                                max_len=self.max_length,
                                                speculative=self.gen_engine == "continuous_spec",
                                                draft_len=self.draft_len)
        requests, stops = [], []
        for r in reqs:
            requests.append((self.tokenizer(r["context"])["input_ids"], r["gen_kwargs"].get("max_gen_toks", 32)))
            stops.append([s for s in r["gen_kwargs"].get("until", []) if s])

        def stop_check(i: int, toks: List[int]) -> bool:  # a tail window of 48 tokens
            return bool(stops[i]) and any(s in self._decode(toks[-48:]) for s in stops[i])

        return [self._cut_at_stops(self._decode(toks), stops[i])
                for i, toks in enumerate(self._cb_engine.generate(requests, stop_check))]

    def generate_until(self, reqs: Sequence[dict]):
        if self.gen_engine in ("continuous", "continuous_spec"):
            # the slot pools decode greedily; sampled requests take the static path
            sampled = [i for i, r in enumerate(reqs) if self._req_temperature(r) > 0]
            if not sampled:
                return self._generate_continuous(reqs)
            greedy = [i for i in range(len(reqs)) if i not in set(sampled)]
            results = [""] * len(reqs)
            if greedy:
                for i, text in zip(greedy, self._generate_continuous([reqs[i] for i in greedy])):
                    results[i] = text
            for i, text in zip(sampled, self._generate_static([reqs[i] for i in sampled])):
                results[i] = text
            return results
        return self._generate_static(reqs)

    def _generate_static(self, reqs: Sequence[dict]):
        results: List[str] = [""] * len(reqs)
        # temperature-homogeneous batches sorted by (temperature, length)
        order = sorted(range(len(reqs)), key=lambda i: (self._req_temperature(reqs[i]), len(reqs[i]["context"])))
        pos = 0
        while pos < len(order):
            temp = self._req_temperature(reqs[order[pos]])
            take = [i for i in order[pos: pos + self.batch_size] if self._req_temperature(reqs[i]) == temp]
            batch = [reqs[i] for i in take]
            max_new = max(r["gen_kwargs"].get("max_gen_toks", 32) for r in batch)
            budget = self.max_length - self._gen_headroom()
            max_new = min(max_new, budget - 16)  # keep at least 16 prompt tokens
            enc = [self.tokenizer(r["context"])["input_ids"][-(budget - max_new):] for r in batch]
            width = _bucket(max(len(e) for e in enc), budget - max_new)
            ids_np = np.full((self.batch_size, width), self._eos_id(), np.int64)
            len_np = np.ones(self.batch_size, np.int64)
            for r, e in enumerate(enc):
                ids_np[r, : len(e)] = e
                len_np[r] = len(e)
            tokens = self._gen_fn(max_new, temp)(
                self.model, torch.from_numpy(ids_np).to(self.device), torch.from_numpy(len_np).to(self.device), pos
            ).cpu().numpy()
            for r, i in enumerate(take):
                # a mixed batch decodes to the batch max; each request keeps its own
                own_max = reqs[i]["gen_kwargs"].get("max_gen_toks", 32)
                text = self._decode(tokens[r, :own_max].tolist())
                results[i] = self._cut_at_stops(text, reqs[i]["gen_kwargs"].get("until", []))
            pos += len(take)
        return results
