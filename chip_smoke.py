#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (retrieval_scaling_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--passages 32768] [--datastore-rows 1048576]

Phases, each of which must pass (any failure exits nonzero):
  1. print the card's name and power limit; no CUDA device -> exit 1;
  2. build the kernels from retrieval_scaling_tpu_torch/csrc with nvcc
     (sm_90a), one nvcc per source, all started together: K1/K2/K2s
     (flash_attn_fwd.cu), K4/K12/K5a/K5b (ivf_gather.cu), K3
     (flash_decode.cu), K6/K7/K8/K9/K10 (quant_matmul.cu), K13
     (stream_probe.cu), K11 (fused_scan.cu) and S1/S2/S5
     (decode_probes.cu);
  3. hold K1 against its plain PyTorch version (f32 math on the same bf16
     inputs) at the main path's shapes: max abs error <= 2e-2, the bf16
     envelope of tests/test_ops.py, and a fully masked row exactly 0;
  4. drive the port's quick-start pipeline through its CLI entry point
     (example_config: Contriever embed -> Flat index -> exact search ->
     Pythia-1B perplexity) at full model width with random weights made
     from --seed, and check what comes out and that every attention call
     went through K1;
  5. time the encoder, the reader and K1 against the plain version;
  6. slice 2 through the same CLI: the Flat run's embeddings indexed as
     IVF-Flat and as IVF-PQ with the index keys of configs/ivf_flat.yaml and
     configs/ivf_pq.yaml, then search and perplexity again; every query
     carries its ctxs, the loss stays near ln V, K4 and K5b launched;
  7. a datastore at a size users run (1,048,576 x 768 fp16 rows in four
     shards, clustered, made on the card from --seed), IVF-Flat and IVF-PQ
     built through Indexer at the configs' own settings and searched at
     nprobe 64 (search_ids: K4, K5b + refine; the scan wrappers on the same
     scan inputs: K12, K5a); build seconds per step, QPS at b64 and
     latency at b1; then the checks: IVF-Flat equals the float64 top-10 of
     the probed rows, IVF-PQ's kernel route equals its plain scan, host
     refine equals device refine, recall@10 against an exact scan above the
     JAX tests' floors; the plain versions ran 0 times on CUDA in 6-7;
  8. hold K4 (bf16 and int8 tiles), K12, K5a and K5b against their plain
     versions at the datastore's b64 nprobe-64 shapes (relative error
     <= 1e-5, top-k ids equal apart from ties) and time each against its
     bound and its plain version;
  9. serving at full width: the port's worker (python -m
     retrieval_scaling_tpu_torch.serve --mode worker) on phase 4's Flat
     index with phase 4's Pythia-1B as serve.generation_model (4 slots,
     1,024-slot pool), 16 POST /search and 8 concurrent POST /generate
     (prompts of ~100-900 tokens, 32-64 new tokens); /search ids equal a
     direct search apart from ties, every greedy /generate text equals the
     static make_generate_fn's, K3 launched on every layer of every decode
     step and the plain attention / plain K3 ran 0 times on CUDA;
 10. the reader backend TorchReaderLM on the same checkpoint with
     quantization None, bf16, int8 and int4 (batch 8, 8 generate_until requests
     on ~256-token c4_sample contexts with 64 new tokens, 8 loglikelihood
     pairs): K6, K7 and K9 launched (K8 in int4) and their plain versions
     ran 0 times on CUDA; bf16 first-step logits within 2e-2 of max |logit|
     of the float model's, int8 per-row cosine > 0.99, int4 > 0.9 (and the
     int4 path with a planted fault below it); each quantized scheme's path
     also held call by call (check_path); ms per decode step per scheme;
 11. K3, K6, K7 and K9 against their plain versions at the path's shapes,
     timed against their bounds and, where one PyTorch call computes the
     same function, that call (SDPA for K3, torch.matmul for the bf16
     scheme's K6 / K7). Limits: K3 1e-4 (f32) or 1e-2 (bf16) of max |y|,
     K6 / K7 1e-4 of max |y|, K9 one f32 ulp; K9 also at the reader's
     m = 2048 on the strided column slices and row parts of qkv_mi / ao_mo
     and on the head, through the store helpers;
 12. Llama-3.1-8B (published widths, 32 layers, random f32 weights from
     --seed, built on the card) through TorchReaderLM with quantization
     None, bf16, int8 and int4, one scheme on the card at a time (batch 8,
     8 generate_until on ~256-token contexts with 64 new tokens, 8
     loglikelihood pairs): K1, K3, K6 (bf16 / int8), K9 (int8) and K8
     (int4) launched, plain versions 0 calls on CUDA; one decode step
     launches exactly 129 K6 (bf16 / int8) or 225 K8 (int4) and 32 K3;
     each quantized scheme's path held call by call (every K1 / K3 / K6 /
     K8 / K9 launch of a prefill and a decode step within its limit of its
     plain version on its own inputs, the step equal when run twice); the
     first 4 layers (full width, the same weights) held against float:
     bf16 within 2e-2 of max |logit|, int8 row cosine > 0.99, int4 > 0.5
     and > 0.99 against the float path on its own dequantized weights (a
     planted fault below both), and the same differences printed at 2, 8,
     16 and 32 layers (WHOLE_PATH); the JAX
     int4 test's own 2-layer reader on the card above 0.95 (INT4_COSINE,
     median of 8 weight draws); ms per decode step per scheme beside the
     K13 floor of the same weight buffers; the checks of phases 12-15 note
     a failure and go on, and the run fails at the end if any was noted;
 13. a Llama-3.1-8B-width checkpoint cut to 4 layers (bf16 on disk) through
     the perplexity CLI on phase 4's Flat index (loss within 0.5 of
     ln 128256, K1 launched) and through the worker's /generate (4 slots,
     4 concurrent requests, each text equal to the static greedy text, K1
     and K3 launched);
 14. Gemma-2-9B (published widths, 42 layers, random bf16 weights) through
     TorchReaderLM, bf16 and int4: loglikelihood of two ~7,000-token
     contexts (batch 2) and one generate_until of a >4096-token prompt with
     32 new tokens; K2 launched with the window on the 21 sliding layers and
     the cap on all 42 of each forward, K3 with the cap, K8 in int4;
     every K2 / K3 (/ K8) launch of the long prompt's prefill and first
     decode step within its limit of its plain version on its own inputs,
     the step equal when run twice; the first 2 layers' first-step logits
     against the same layers with every kernel swapped for its plain
     version, the same token fed to both: bf16 within 2e-2 of max |logit|,
     int4 row cosine > 0.99; the difference printed at 4, 8, 16 and 42
     layers (WHOLE_PATH);
 15. K2 (Gemma-2, Mistral and Phi-3 shapes at S 4096-8192, window and cap;
     a padded row exactly 0), K3 with the cap (Gemma-2 decode, 4,096-8,192
     slots, window folded into the mask), the capped cases with q scaled so
     that the scores reach the cap and the plain version's capped and
     uncapped outputs differ by more than ten times the limit, K8 (Llama-3.1-8B's projections
     and head at b8, q_w / gate_w at m = 2048; 1e-5 of max |y|) and K13
     (a decode step's int4 buffers; byte sum equal) against their plain
     versions, timed against their bounds and, where one exists, the
     PyTorch call that computes the same function;
 16. packed and int8-FFN encoding through the CLI at BERT-base width (phase
     4's checkpoint): 20,480 passages of 48 words (~51 tokens,
     passage_maxlength 256) and 127 queries of 96 tokens (question_maxlength
     512) through embed -> Flat index -> search, four ways: bucketed, packed
     (datastore.embedding.packing and evaluation.search.packing), int8
     (datastore.embedding.quantization=int8; the queries stay float, as in
     the JAX CLI) and packed + int8. Each run's ctxs equal a fresh search and
     its top-3 ids a float64 scan of its written embeddings apart from ties;
     K1 launches 12 per encoder forward, K2s 12 per packed forward, K9 and
     K10 12 per int8 forward, the plain versions 0 times on CUDA; packed rows
     against bucketed ones row cosine > 0.999, int8 against float > 0.995
     (held on the first 2 layers, with the full depth printed, if 12 random
     layers amplify past it). Then passages/s bucketed against packed on
     65,536 passages at mean lengths of ~40 and ~96 tokens of 256 (with
     each route's device seconds from torch.profiler and the token
     positions it computes), and with the bf16 against
     the int8 FFN at 2048 x 256 (and one layer's FFN tail on the card);
 17. GTR-T5-base (T5 encoder + 768 -> 768 Dense) and Qwen3-Embedding-0.6B
     (28 x 1024, last-token pooling, the query instruction) at their
     published widths, random bf16 weights written as local checkpoint
     directories, through the CLI (load_encoder dispatches on config.json):
     finite embeddings, GTR's unit-norm, the search equal to a float64 scan
     apart from ties, the Qwen3 embedder's K1 launches equal to 28 per
     forward (T5's attention adds a position bias and runs plain torch, as
     XLA in the JAX package);
 18. K2s (packed passages b64 h12 S256 d64 with segments of ~40 tokens,
     packed queries b16 h12 S512 d64 of ~96, and the encoder's packed batch
     b2048 h12 S256 d64 of ~40, timed beside K1 at that shape and at the
     bucketed shape b2048 S64 of the same lengths; limit 2e-2, pad rows
     exactly 0)
     and K10 (m 2048 x 256, 3072 -> 768 bf16: one bf16 ulp of the plain f32
     result, or 1e-5 of max |y| where the LayerNorm's + beta cancels; m
     65536 f32: 1e-4 of max |y|) against their plain versions, timed
     against their bounds and SDPA with a block-diagonal mask (K2s; no
     PyTorch call computes K10);
 19. the Flat scan slice and the rest of the offline pipeline: phase 7's
     shards as a bf16 Flat index through Indexer (1,048,576 x 768); the
     path flat_topk_fused (K11 + K4) top-100 at b1 and b64 with n_valid =
     N - 77, counted (K11, K4 launched, plain versions 0 calls on CUDA);
     K11 against its plain version (1e-5 of max |score|, masked segments
     exactly -1e30), the top-100 against a float64 scan of the bf16 rows
     and against FlatIndex.search_ids apart from ties; K11, flat_topk_fused,
     cuBLAS + amax and chunked_topk_scores timed (L2 flushed) against the
     bound; the SQ8 Flat index (approx_recall 0.95) beside bf16: QPS at
     b64, ms at b1, recall@10 against the bf16 scan. Then through the CLI
     on phase 4's run: SQ8 + approx_recall (ids equal a float64 scan of the
     dequantized rows and queries apart from ties), BM25 (build seconds,
     ctxs in score order), merge_search over both result files (p 0.5,
     rerank lexical: no ctxs list over n_docs, no duplicate text), and
     perplexity with decontamination, with continuation and as calibration
     (loss within 0.5 of ln V, K1 launched, plain attention 0 calls on
     CUDA, calibration_losses.pkl one row per example). Its checks note a
     failure and go on.
 20. speculative decoding and the decode probes: make_speculative_generate_fn
     on phase 4's Pythia-1B at b8, draft_len 7, 64 new tokens on ~256-token
     c4_sample prompts, for the float, bf16, int8 and int4 weights, each with
     the float and the int8 cache, against make_generate_fn's tokens (K3
     verify launches = layers x verify forwards with the float cache, 0 with
     the int8 cache's plain attention; K6 / K7 or K8 launched; plain
     versions 0 calls on CUDA). A stream that leaves static greedy's is
     excused only where the scheme is not row-exact (float weights, the int8
     cache) and static greedy's top-2 logit gap at that token is below the
     max |logit| difference, measured in the same run, between verify
     forwards and one-token forwards on the same prefix; each case is
     printed. Scripted emission at prompt-copy rates 0 / 50 / 90 %: tokens
     a round, ms a round, tokens/s against static greedy's. TorchReaderLM
     gen_engine "speculative" and "continuous_spec" (Pythia-1B int8) and
     "speculative" on phase 13's 4-layer Llama-3.1-8B-width reader (bf16,
     int8), and the worker with serve.generation_speculative=true
     serve.generation_draft_len=7 (4 slots, 8 concurrent /generate), each
     against the static greedy output under the same rule. K3 with
     per-query positions against its plain version at the verify shapes
     (Pythia f32, Llama GQA bf16, Gemma-2 window 4096 + cap 50 with the
     window's edge inside the segment; 1e-4 / 1e-2 of max |y|, a query with
     no visible key exactly 0), timed against its bound and SDPA with the
     same mask. The decode probes S1 (cur, preq, dual, w8bf16, touch =
     K13 per buffer, bf16, dual-bf16), S2 (16 launches / one launch) and
     S5 (a [8, 128] copy): their path at Pythia-1B's shapes counted, each
     against its plain version (one bf16 ulp of the plain f32 result for
     the s8 products, 1e-4 of max |y| for the bf16 ones, S5 exact) and
     timed (L2 flushed) against its byte bound, torch.matmul (S1-bf16), a
     copy (S5) and K6 (beside S1-w8bf16). Its checks note a failure and go
     on.
Numbers go to earlier lines, tagged with the card; the second-to-last line
is the kernels JSON and the last line the device JSON.
"""


from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
C4_SAMPLE = os.path.join(REPO, "examples", "c4_sample.jsonl")
TOL = 2e-2
TOPICS = ["astronomy", "biology", "chemistry", "geology", "history",
          "mathematics", "music", "philosophy", "physics", "poetry"]
PIECE_RE = re.compile(r"\w+|[^\w\s]+")

# (label, B, H, Hkv, Sq, Sk, D, causal, key mask): the encoder's padded
# batches, the reader's 1024/2048 buckets, and a GQA row with sq < sk
KERNEL_CASES = [
    ("encoder b8 h12 S256 d64 key-mask", 8, 12, 12, 256, 256, 64, False, True),
    ("reader b2 h8 S1024 d256 causal", 2, 8, 8, 1024, 1024, 256, True, False),
    ("reader b2 h8 S2048 d256 causal", 2, 8, 8, 2048, 2048, 256, True, False),
    ("gqa b2 h8/hkv2 Sq200 Sk700 d128 causal", 2, 8, 2, 200, 700, 128, True, False),
]
TIMED_CASE = "reader b2 h8 S2048 d256 causal"


def log(msg: str) -> None:
    print(msg, flush=True)


# Slice 4's checks note a failure here and go on, so that one run prints
# every phase's numbers; main raises at the end if any was noted.
FAILURES: list = []


def fail_later(msg: str) -> None:
    log(f"CHECK FAILED: {msg}")
    FAILURES.append(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 3
def check_kernel(device, seed: int, tag: str) -> dict:
    from retrieval_scaling_tpu_torch.ops.flash_attention import attention_reference, flash_attention

    gen = torch.Generator(device=device).manual_seed(seed)
    worst, timing = 0.0, {}
    for label, b, h, hkv, sq, sk, d, causal, masked in KERNEL_CASES:
        q = torch.randn(b, h, sq, d, generator=gen, device=device).to(torch.bfloat16)
        k = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(torch.bfloat16)
        mask = None
        if masked:
            lengths = torch.randint(1, sk + 1, (b,), generator=gen, device=device)
            lengths[-1] = 0  # a padded batch row: no visible key at all
            mask = torch.arange(sk, device=device)[None, :] < lengths[:, None]
        out = flash_attention(q, k, v, kv_mask=mask, causal=causal)
        ref = attention_reference(q.float(), k.float(), v.float(), kv_mask=mask, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not math.isfinite(err) or err > TOL:
            raise AssertionError(f"K1 {label}: max abs error {err} > {TOL}")
        if masked and not bool((out[-1] == 0).all()):
            raise AssertionError(f"K1 {label}: fully masked row is not exactly 0")
        worst = max(worst, err)
        log(f"K1 check {label}: max_abs_err={err:.3e} (tol {TOL}) {tag}")
        if label.startswith("reader"):
            ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), iters=20)
            plain = cuda_ms(lambda: attention_reference(q, k, v, causal=causal), iters=5)
            sdpa = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True), iters=20
            )
            flops = 2 * 2 * b * h * sq * sk * d / 2  # two causal products
            log(f"K1 time {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                f"plain {plain:.4f} ms, torch SDPA (not a repo kernel) {sdpa:.4f} ms {tag}")
            timing[label] = (ms, plain, sdpa)
    torch.cuda.synchronize()
    ms, plain, sdpa = timing[TIMED_CASE]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain, "library_ms": sdpa}


# ---------------------------------------------------------------- phase 4
def write_corpus(path: str, n_docs: int, words_per_doc: int, seed: int) -> None:
    """make_synthetic_data.py-style docs: topic terms, a period every 16 words."""
    rng = np.random.RandomState(seed)
    terms = np.asarray([[f"{t}_term_{i}" for i in range(401)] for t in TOPICS])
    draws = rng.randint(0, 401, size=(n_docs, words_per_doc))
    with open(path, "w") as f:
        for i in range(n_docs):
            words = terms[i % len(TOPICS)][draws[i]].tolist()
            for j in range(15, words_per_doc, 16):
                words[j] += "."
            f.write(json.dumps({"text": " ".join(words), "meta": {"id": i}}) + "\n")


def make_tokenizer(corpus_words):
    from retrieval_scaling_tpu_torch.models.hf_convert import WordLevelTokenizer

    pieces = set(corpus_words)
    with open(C4_SAMPLE) as f:
        for line in f:
            pieces.update(PIECE_RE.findall(json.loads(line)["text"]))
    specials = ["[PAD]", "[UNK]", "<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(specials + sorted(pieces))}
    return WordLevelTokenizer(vocab, "[UNK]", specials, pad_token="[PAD]", eos_token="<|endoftext|>")


def make_checkpoints(root: str, device, seed: int, enc_cfg, reader_cfg):
    from retrieval_scaling_tpu_torch.models.bert import init_bert_params
    from retrieval_scaling_tpu_torch.models.gpt_neox import init_gpt_neox_params
    from retrieval_scaling_tpu_torch.models.hf_convert import save_hf_checkpoint

    corpus_words = [f"{t}_term_{i}" for t in TOPICS for i in range(401)] + ["."]
    tok = make_tokenizer(corpus_words)
    gen = torch.Generator(device=device).manual_seed(seed)
    enc_dir = os.path.join(root, "contriever-base-random")
    reader_dir = os.path.join(root, "pythia-1b-random")
    for path, model in (
        (enc_dir, init_bert_params(enc_cfg, gen, device=device, dtype=torch.bfloat16)),
        (reader_dir, init_gpt_neox_params(reader_cfg, gen, device=device, dtype=torch.bfloat16)),
    ):
        if model.cfg.vocab_size < tok.vocab_size:
            raise AssertionError(f"tokenizer vocab {tok.vocab_size} > model vocab {model.cfg.vocab_size}")
        save_hf_checkpoint(model, path)
        tok.save_pretrained(path)
    return enc_dir, reader_dir


def pipeline_argv(root: str, corpus: str, enc_dir: str, reader_dir: str, device) -> list:
    return [
        "--config-name", "example_config", "--device", device.type,
        f"datastore.raw_data_path={corpus}",
        f"datastore.datastore_root_dir={root}/scaling_out",
        f"model.datastore_encoder={enc_dir}", f"model.datastore_tokenizer={enc_dir}",
        f"model.query_encoder={enc_dir}", f"model.query_tokenizer={enc_dir}",
        f"model.lm_model={reader_dir}",
        f"evaluation.data.eval_data={C4_SAMPLE}",
        "evaluation.data.num_eval_samples=128",
        f"evaluation.results_only_log_file={root}/results.log",
        "evaluation.search.cache_query_embedding=true",
        f"evaluation.search.query_embedding_save_path={root}/query_embeddings.pkl",
    ]


def ids_agree(port_ids, q64, db64, k: int, candidates=None) -> int:
    """Rows where the card's top-k ids differ from the float64 scan by more
    than ties: a differing id must score within the bf16 error bound of the
    reference's k-th score (each product of bf16-rounded operands is off by
    at most 2^-8 relative, so a score by at most 2^-8 * sum|q_i x_i|).
    ``candidates[qi]``, where given, are the row ids query qi's scan saw."""
    bad = 0
    for qi in range(q64.shape[0]):
        cand = np.arange(len(db64)) if candidates is None else np.asarray(candidates[qi])
        rows = db64 if candidates is None else db64[cand]
        scores = rows @ q64[qi]
        top = np.argsort(-scores, kind="stable")[:k]
        if set(port_ids[qi].tolist()) == set(cand[top].tolist()):
            continue
        bound = 2.0 ** -8 * (np.abs(rows) @ np.abs(q64[qi])).max()
        score_of = dict(zip(cand.tolist(), scores.tolist()))
        if any(score_of.get(int(i), -np.inf) < scores[top[-1]] - 2 * bound for i in port_ids[qi]):
            bad += 1
    return bad


def run_pipeline(root: str, device, seed: int, n_passages: int, enc_cfg, reader_cfg, tag: str) -> dict:
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.index.base import get_index_dir_and_embedding_paths
    from retrieval_scaling_tpu_torch.index.flat import FlatIndex
    from retrieval_scaling_tpu_torch.ops.flash_attention import attention_reference, flash_attention
    from retrieval_scaling_tpu_torch.pipeline import main as pipeline_main
    from retrieval_scaling_tpu_torch.search.driver import get_search_output_path, read_jsonl

    t0 = time.perf_counter()
    corpus = os.path.join(root, "corpus.jsonl")
    write_corpus(corpus, n_passages, 256, seed)
    enc_dir, reader_dir = make_checkpoints(root, device, seed, enc_cfg, reader_cfg)
    log(f"fixtures: {n_passages} passages, random encoder + reader checkpoints "
        f"in {time.perf_counter() - t0:.1f} s")

    argv = pipeline_argv(root, corpus, enc_dir, reader_dir, device)
    flash_attention.launches = 0
    attention_reference.cuda_calls = 0
    result = pipeline_main.main(argv)
    sync(device)
    launches, plain_calls = flash_attention.launches, attention_reference.cuda_calls

    cfg = load_config("example_config", overrides=argv[4:])
    with open(os.path.join(cfg.datastore.embedding.embedding_dir, "passages_00.pkl"), "rb") as f:
        _, emb = pickle.load(f)
    if emb.shape != (n_passages, enc_cfg.hidden_size) or not np.isfinite(emb.astype(np.float32)).all():
        raise AssertionError(f"embeddings: shape {emb.shape}, finite {np.isfinite(emb).all()}")

    rows = read_jsonl(get_search_output_path(cfg, [0]))
    queried = [ex for ex in rows if ex.get("raw_query")]
    if not queried or any(len(ex["ctxs"]) != 3 for ex in queried):
        raise AssertionError("every query must carry 3 ctxs")

    index_dir, _ = get_index_dir_and_embedding_paths(cfg, [0])
    index = FlatIndex(
        device,
        index_path=os.path.join(index_dir, "index_Flat.tpu.npz"),
        meta_file=os.path.join(index_dir, "index_Flat.tpu.ids.npy"),
    )
    db64 = np.load(os.path.join(index_dir, "index_Flat.tpu.npz"))["embeddings"].astype(np.float64)
    with open(cfg.evaluation.search.query_embedding_save_path, "rb") as f:
        q_pipeline = pickle.load(f)
    rng = np.random.RandomState(seed)
    extra = db64[rng.randint(0, len(db64), max(0, 64 - len(q_pipeline)))]
    extra = (extra + 0.05 * rng.randn(*extra.shape) * np.abs(extra).mean()).astype(np.float16)
    queries = np.concatenate([q_pipeline, extra])[:64]
    _, port_ids = index.search_ids(queries, 3)
    ctx_ids = np.asarray([[c["id"][1] for c in ex["ctxs"]] for ex in queried])
    if not np.array_equal(ctx_ids, port_ids[: len(queried)]):
        raise AssertionError("pipeline ctxs differ from a fresh search of the same index")
    bad = ids_agree(port_ids, queries.astype(np.float64), db64, 3)
    if bad:
        raise AssertionError(f"exact search: {bad}/64 queries differ from the float64 scan beyond ties")
    log("search check: 64 queries, top-3 ids agree with a float64 numpy scan of the fp16 index (ties aside)")

    ppl = result["ppl"]
    ln_v = math.log(reader_cfg.vocab_size)
    if not math.isfinite(ppl.perplexity) or abs(ppl.average_loss - ln_v) > 0.5:
        raise AssertionError(f"avg loss {ppl.average_loss} not within 0.5 of ln V = {ln_v:.4f}")

    # every encoder batch and every reader batch runs K1 once per layer
    n_rows = len(rows) - 1
    n_queries = len(queried)
    enc_batches = math.ceil(n_passages / cfg.datastore.embedding.per_device_batch_size) + math.ceil(
        n_queries / cfg.evaluation.search.per_device_batch_size
    )
    need = enc_cfg.num_layers * enc_batches + reader_cfg.num_layers * math.ceil(
        n_rows / cfg.evaluation.per_device_eval_batch_size
    )
    if launches < need or plain_calls != 0:
        raise AssertionError(f"K1 launches {launches} (need >= {need}), plain CUDA calls {plain_calls} (need 0)")
    log(f"pipeline: avg loss {ppl.average_loss:.4f} (ln V = {ln_v:.4f}), ppl {ppl.perplexity:.2f}, "
        f"{n_queries} queries, {n_rows} scored rows, K1 launches {launches} (>= {need}), "
        f"plain attention on CUDA {plain_calls}")
    for name, sec in result["stage_seconds"].items():
        log(f"stage {name}: {sec:.3f} s {tag}")
    sync(device)
    return {"launches": launches, "enc_dir": enc_dir, "reader_dir": reader_dir, "cfg": cfg, "corpus": corpus}


# ---------------------------------------------------------------- phase 5
def measure_rates(run: dict, device, tag: str) -> None:
    from retrieval_scaling_tpu_torch.evals.perplexity import TorchReader, _load_eval_examples, build_doc_prompts
    from retrieval_scaling_tpu_torch.search.encoder import EncodeOptions, load_encoder

    with open(run["corpus"]) as f:
        texts = [json.loads(next(f))["text"] for _ in range(8192)]
    encoder = load_encoder(run["enc_dir"], device)
    opts = EncodeOptions(batch_size=2048, maxlength=256)
    encoder.encode(texts[:2048], opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encoder.encode(texts, opts)
    sec = time.perf_counter() - t0
    log(f"encoder: {len(texts) / sec:.1f} passages/s (BERT-base, 256 tokens, batch 2048, "
        f"host tokenization included) {tag}")
    del encoder
    torch.cuda.empty_cache()

    cfg = run["cfg"]
    contexts, answers, _ = build_doc_prompts(_load_eval_examples(cfg), cfg.evaluation)
    reader = TorchReader.from_pretrained(run["reader_dir"], device, batch_size=8)
    tok = reader.tokenizer
    n_tok = sum(min(len(tok(c)["input_ids"]) + len(tok(a)["input_ids"]), 2048) for c, a in zip(contexts, answers))
    reader.score(contexts, answers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reader.score(contexts, answers)
    sec = time.perf_counter() - t0
    log(f"reader: {n_tok / sec:.1f} tokens/s scored (Pythia-1B, {len(contexts)} rows, batch 8, "
        f"blockwise loss) {tag}")
    torch.cuda.synchronize()


# ---------------------------------------------------------------- phases 6-8 (slice 2: IVF)
IVF_TOL = 1e-5          # max |kernel - plain| / max |plain|: f32 sums taken in another order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 700 W: HBM3 peak rate
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
NPROBE = 64             # bench.py's IVF scale: nprobe 64 at b64
# the index keys of configs/ivf_flat.yaml and configs/ivf_pq.yaml, as overrides
IVF_CLI_KEYS = {
    "IVFFlat": ["datastore.index.index_type=IVFFlat", "datastore.index.probe=128"],
    "IVFPQ": [
        "datastore.index.index_type=IVFPQ", "datastore.index.probe=256",
        "datastore.index.n_subquantizers=16", "datastore.index.n_bits=8", "datastore.index.pq_opq=true",
        "datastore.index.pq_aniso=false", "datastore.index.pq_refine_factor=4",
        "datastore.index.pq_refine_mode=device",
    ],
}
# cuts that a 32,768-passage datastore forces: 4096 lists of ~8 rows and a
# 1M training sample are not possible there
IVF_CLI_CUTS = ["datastore.index.ncentroids=256", "datastore.index.sample_train_size=32768"]
# the synthetic datastore: N(0, I) centres plus a within-cluster spread of
# total variance DATA_SPREAD^2 * 768 whose per-direction scale decays as
# i^-DATA_ALPHA in a random basis (embedding covariances put most variance in
# a few directions; here the first direction holds 39 % of it, the first 16
# directions 83 %). scripts/torch_datastore_spectrum.py gives the recall of
# other spectra; recall figures are properties of this synthetic spectrum,
# not of IVF on real embeddings
DATA_ALPHA, DATA_SPREAD = 0.75, 0.35


def ivf_kernels() -> dict:
    from retrieval_scaling_tpu_torch.ops import ivf_gather as g

    return {"K4": g.gather_score_tiles, "K12": g.gather_score_tiles_grouped,
            "K5a": g.gather_adc_tiles, "K5b": g.gather_adc_tiles_grouped}


def ivf_plain_versions() -> list:
    from retrieval_scaling_tpu_torch.index.ivf_common import ivf_scan_topk
    from retrieval_scaling_tpu_torch.index.ivf_pq import pq_scan_topk
    from retrieval_scaling_tpu_torch.ops import ivf_gather as g

    return [g.gather_score_tiles_reference, g.gather_adc_tiles_reference, ivf_scan_topk, pq_scan_topk]


def reset_ivf_counts() -> None:
    for fn in ivf_kernels().values():
        fn.launches = 0
    for fn in ivf_plain_versions():
        fn.cuda_calls = 0


def ivf_counts():
    """({kernel: launches}, plain calls on CUDA tensors)."""
    return {k: fn.launches for k, fn in ivf_kernels().items()}, sum(fn.cuda_calls for fn in ivf_plain_versions())


def run_ivf_cli(run: dict, device, reader_vocab: int, tag: str) -> None:
    """Phase 6: pipeline.main with IVFFlat, then IVFPQ, on the Flat run's
    embeddings and cached query embeddings (embedding is skipped, search and
    perplexity run again)."""
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.index.base import get_index_dir_and_embedding_paths
    from retrieval_scaling_tpu_torch.index.ivf_flat import IVFFlatIndex
    from retrieval_scaling_tpu_torch.pipeline import main as pipeline_main
    from retrieval_scaling_tpu_torch.search.driver import get_search_output_path, read_jsonl

    root = os.path.dirname(run["corpus"])
    base = pipeline_argv(root, run["corpus"], run["enc_dir"], run["reader_dir"], device)
    base += ["evaluation.search.overwrite=true"] + IVF_CLI_CUTS
    ln_v = math.log(reader_vocab)
    for index_type, keys in IVF_CLI_KEYS.items():
        argv = base + keys + [f"evaluation.results_only_log_file={root}/results_{index_type}.log"]
        before, _ = ivf_counts()
        result = pipeline_main.main(argv)
        sync(device)
        after, plain_calls = ivf_counts()
        cfg = load_config("example_config", overrides=argv[4:])
        queried = [ex for ex in read_jsonl(get_search_output_path(cfg, [0])) if ex.get("raw_query")]
        if not queried or any(len(ex["ctxs"]) != 3 for ex in queried):
            raise AssertionError(f"{index_type}: every query must carry 3 ctxs")
        ppl = result["ppl"]
        if not math.isfinite(ppl.perplexity) or abs(ppl.average_loss - ln_v) > 0.5:
            raise AssertionError(f"{index_type}: avg loss {ppl.average_loss} not within 0.5 of ln V = {ln_v:.4f}")
        kernel = "K4" if index_type == "IVFFlat" else "K5b"
        if after[kernel] <= before[kernel] or plain_calls:
            raise AssertionError(f"{index_type}: {kernel} launches {before[kernel]} -> {after[kernel]}, "
                                 f"plain IVF calls on CUDA {plain_calls} (need growth and 0)")
        log(f"CLI {index_type}: {len(queried)} queries with 3 ctxs each, avg loss {ppl.average_loss:.4f} "
            f"(ln V = {ln_v:.4f}), {kernel} launches {after[kernel] - before[kernel]}, plain IVF calls on CUDA 0; "
            + ", ".join(f"{k} {v:.3f} s" for k, v in result["stage_seconds"].items()) + f" {tag}")
        if index_type == "IVFFlat":
            index_dir, _ = get_index_dir_and_embedding_paths(cfg, [0])
            a = cfg.datastore.index
            name = f"index_IVFFlat.{a.sample_train_size}.{a.projection_size}.{a.ncentroids}.tpu"
            index = IVFFlatIndex(device, index_path=os.path.join(index_dir, name + ".npz"),
                                 meta_file=os.path.join(index_dir, name + ".ids.npy"), probe=a.probe)
            with open(cfg.evaluation.search.query_embedding_save_path, "rb") as f:
                q_pipeline = pickle.load(f)
            _, fresh = index.search_ids(q_pipeline, 3)
            ctx_ids = np.asarray([[c["id"][1] for c in ex["ctxs"]] for ex in queried])
            if not np.array_equal(ctx_ids, fresh[: len(queried)]):
                raise AssertionError("IVF-Flat ctxs differ from a fresh search_ids of the saved index")
            log("CLI IVFFlat: ctxs ids equal a fresh search_ids of the saved index")


def make_datastore(d: int, n_centres: int, seed: int, device, alpha: float = DATA_ALPHA,
                   spread: float = DATA_SPREAD):
    """A sampler of clustered rows on ``device``: ``draw(m)`` gives [m, d] f32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centres = torch.randn(n_centres, d, generator=gen, device=device)
    basis = torch.linalg.qr(torch.randn(d, d, generator=gen, device=device))[0]
    scale = torch.arange(1, d + 1, dtype=torch.float32, device=device) ** -alpha
    scale = spread * scale * (d / (scale**2).sum()).sqrt()  # total variance spread^2 * d

    def draw(m: int) -> torch.Tensor:
        labels = torch.randint(0, n_centres, (m,), generator=gen, device=device)
        return centres[labels] + (torch.randn(m, d, generator=gen, device=device) * scale) @ basis.T

    return draw


def write_datastore(ds_root: str, device, seed: int, rows: int, centres: int, shards: int,
                    alpha: float = DATA_ALPHA, spread: float = DATA_SPREAD):
    """``shards`` passages_XX.pkl shards of clustered 768-wide fp16 rows under
    ``ds_root/embeddings`` (no passage texts: the IVF phases read ids only),
    64 fresh queries and their exact top-10 over the rows, on the device.
    Returns (embedding dir, passages dir, rows, queries, top-10 ids)."""
    t0 = time.perf_counter()
    emb_dir, psg_dir = os.path.join(ds_root, "embeddings"), os.path.join(ds_root, "passages")
    os.makedirs(emb_dir)
    os.makedirs(psg_dir)
    d = 768
    draw = make_datastore(d, centres, seed, device, alpha, spread)
    per = rows // shards
    parts = []
    for shard in range(shards):
        part = draw(per).half().cpu().numpy()
        with open(os.path.join(emb_dir, f"passages_{shard:02d}.pkl"), "wb") as f:
            pickle.dump((list(range(per)), part), f)
        parts.append(part)
    emb = np.concatenate(parts)
    queries = draw(64).cpu().numpy()
    db = torch.from_numpy(emb).to(device).float()
    truth = torch.topk(torch.from_numpy(queries).to(device) @ db.T, 10, dim=-1).indices.cpu().numpy()
    del db
    log(f"datastore: {rows} x {d} fp16 rows in {shards} shards, {centres} clusters (spectrum alpha {alpha}, "
        f"spread {spread}), made on {device.type} and written in {time.perf_counter() - t0:.1f} s; "
        f"64 fresh queries, exact top-10 on {device.type}")
    return emb_dir, psg_dir, emb, queries, truth


def recall_at_10(ids: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean([len(set(ids[b][:10].tolist()) & set(truth[b].tolist())) / 10 for b in range(len(truth))]))


def timed_search(index, queries, reps: int, **kw) -> float:
    """Seconds per ``search_ids`` call, host clock (each call ends on the host)."""
    index.search_ids(queries, 10, **kw)
    t0 = time.perf_counter()
    for _ in range(reps):
        index.search_ids(queries, 10, **kw)
    return (time.perf_counter() - t0) / reps


def build_datastore(root: str, device, seed: int, tag: str, rows: int, centres: int, lists: int,
                    nprobe: int, shards: int = 4, alpha: float = DATA_ALPHA, spread: float = DATA_SPREAD) -> dict:
    """Phase 7 (path): write the datastore, build both indexes through
    Indexer at the configs' settings, search and time them."""
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.index.base import Indexer
    from retrieval_scaling_tpu_torch.ops.ivf_gather import ivf_scan_topk_tiles, pq_scan_topk_tiles

    ds_root = os.path.join(root, "datastore")
    emb_dir, psg_dir, emb, queries, truth = write_datastore(ds_root, device, seed, rows, centres, shards,
                                                            alpha, spread)
    common = [
        f"datastore.datastore_root_dir={ds_root}", "datastore.domain=synthetic", "evaluation.domain=none",
        "evaluation.data.eval_data=none.jsonl", f"evaluation.results_only_log_file={ds_root}/results.log",
        f"datastore.embedding.embedding_dir={emb_dir}", f"datastore.embedding.passages_dir={psg_dir}",
        "datastore.index.index_shard_ids=[" + ",".join(str(i) for i in range(shards)) + "]",
    ]
    if lists != 4096 or rows < 1000000:  # a rehearsal below the configs' scale
        common += [f"datastore.index.ncentroids={lists}", f"datastore.index.sample_train_size={rows}"]
    out = {"queries": queries, "truth": truth, "emb": emb, "nprobe": nprobe, "ds_root": ds_root, "shards": shards}
    for kind, config in (("IVFFlat", "ivf_flat"), ("IVFPQ", "ivf_pq")):
        cfg = load_config(config, overrides=common)
        t1 = time.perf_counter()
        index = Indexer(cfg, device, index_shard_ids=list(range(shards))).datastore
        sync(device)
        steps = ", ".join(f"{k} {v:.2f} s" for k, v in index.build_seconds.items())
        held = (index.tiles_dev.nbytes if kind == "IVFFlat" else
                index.code_tiles_dev.nbytes + (0 if index.refine_rows_dev is None else index.refine_rows_dev.nbytes))
        log(f"build {kind}: {time.perf_counter() - t1:.2f} s through Indexer ({steps}); "
            f"{held / 1e9:.3f} GB of lists/rows on the device {tag}")
        out[kind] = index
        out[kind + "_cfg"] = cfg
    flat, pq = out["IVFFlat"], out["IVFPQ"]
    out["flat_ids"] = flat.search_ids(queries, 10, nprobe=nprobe)[1]
    out["pq_ids"] = pq.search_ids(queries, 10, nprobe=nprobe)[1]
    # no search_ids runs K12 or K5a (IVF-Flat scans with K4 and IVF-PQ with
    # K5b, as in the JAX package): the scan wrappers launch them on the
    # indexes' own scan inputs, K5a without the refine
    with torch.inference_mode():
        q, tile_ids, valid = flat.scan_inputs(queries, nprobe)
        out["flat_ids_k12"] = ivf_scan_topk_tiles(q, flat.tiles_dev, flat.row_ids_dev, tile_ids, valid, 10,
                                                  grouped=True, tile_row_scales=flat.tile_scales_dev)[1].cpu().numpy()
        _, (lut, coarse, p_ids, p_valid, probe_of) = pq.scan_inputs(queries, nprobe)
        out["pq_raw_k5a"] = tuple(t.cpu().numpy() for t in pq_scan_topk_tiles(
            lut, coarse, pq.code_tiles_dev, pq.row_ids_dev, p_ids, p_valid, probe_of, 11, grouped=False))
    for kind, index in (("IVF-Flat", flat), ("IVF-PQ + refine", pq)):
        b64 = timed_search(index, queries, 10, nprobe=nprobe)
        b1 = timed_search(index, queries[:1], 20, nprobe=nprobe)
        log(f"search {kind} nprobe {nprobe}: {64 / b64:.1f} QPS at b64 ({b64 * 1e3:.3f} ms/batch), "
            f"{b1 * 1e3:.3f} ms at b1 (host clock, query upload and result download included) {tag}")
    return out


def top_ids_apart_from_ties(s_a, i_a, s_b, i_b, k: int, tol: float) -> int:
    """Rows whose top-k id sets differ although the k-th and (k+1)-th scores
    are further apart than ``tol`` (both inputs carry k + 1 columns)."""
    bad = 0
    for row in range(i_a.shape[0]):
        if set(i_a[row, :k].tolist()) == set(i_b[row, :k].tolist()):
            continue
        if abs(s_b[row, k - 1] - s_b[row, k]) > tol:
            bad += 1
    return bad


def check_datastore(ds: dict, device, tag: str) -> None:
    """Phase 7 checks, after the path's counts were read."""
    from retrieval_scaling_tpu_torch.index.ivf_pq import IVFPQIndex, pq_scan_topk
    from retrieval_scaling_tpu_torch.ops.ivf_gather import pq_scan_topk_tiles

    flat, pq, queries, truth, nprobe = ds["IVFFlat"], ds["IVFPQ"], ds["queries"], ds["truth"], ds["nprobe"]
    # IVF-Flat: the float64 top-10 over the rows the scan was given
    _, tile_ids, valid = flat.scan_inputs(queries, nprobe)
    tiles = [t[v] for t, v in zip(tile_ids.cpu().numpy(), valid.cpu().numpy())]
    row_ids = flat.layout.row_flat_ids.reshape(-1, 128)
    cand = [np.sort(r[r >= 0]) for r in (row_ids[t].ravel() for t in tiles)]
    q64 = queries.astype(np.float64)
    for name, ids in (("K4", ds["flat_ids"]), ("K12", ds["flat_ids_k12"])):
        bad = ids_agree(ids, q64, ds["emb"], 10, candidates=cand)
        if bad:
            raise AssertionError(f"IVF-Flat ({name}): {bad}/64 queries differ from the probed rows' float64 top-10")
    log(f"IVF-Flat nprobe {nprobe}: T = {tile_ids.shape[1]} slots, {np.mean([len(c) for c in cand]):.0f} rows "
        f"scanned per query; K4 and K12 top-10 equal the float64 top-10 of the probed rows (ties aside)")

    # IVF-PQ: the kernel routes (K5b here, K5a on the path) against the
    # plain scan, raw (no refine)
    with torch.inference_mode():
        _, scan = pq.scan_inputs(queries, nprobe)
        args = (scan[0], scan[1], pq.code_tiles_dev, pq.row_ids_dev, *scan[2:], 11)
        s_k, i_k = (t.cpu().numpy() for t in pq_scan_topk_tiles(*args))
        s_p, i_p = (t.cpu().numpy() for t in pq_scan_topk(*args))
    tol = IVF_TOL * np.abs(s_p).max()
    for name, (s_r, i_r) in (("K5b", (s_k, i_k)), ("K5a", ds["pq_raw_k5a"])):
        bad = top_ids_apart_from_ties(s_r, i_r, s_p, i_p, 10, tol)
        if bad or not np.allclose(s_r, s_p, rtol=0, atol=tol):
            raise AssertionError(f"IVF-PQ through {name} vs plain scan: {bad}/64 rows differ beyond ties")
    # host refine against device refine, on the saved files
    a = ds["IVFPQ_cfg"].datastore.index
    base = pq.refine_row_file[: -len(".refine.bin")]
    host = IVFPQIndex(device, index_path=base + ".npz", meta_file=base + ".ids.npy", ncentroids=a.ncentroids,
                      probe=a.probe, n_subquantizers=a.n_subquantizers, n_bits=a.n_bits,
                      refine_factor=a.pq_refine_factor, refine_mode="host")
    s_h, i_h = host.search_ids(queries, 11, nprobe=nprobe)
    s_d, i_d = pq.search_ids(queries, 11, nprobe=nprobe)
    tol_r = 1e-5 * np.abs(s_d).max()
    bad = top_ids_apart_from_ties(s_h, i_h, s_d, i_d, 10, tol_r)
    if bad:
        raise AssertionError(f"host refine vs device refine: {bad}/64 rows differ beyond ties")
    log("IVF-PQ: K5b and K5a ids equal the plain scan's and host refine equals device refine (ties aside)")

    r_flat, r_raw, r_ref = (recall_at_10(ids, truth) for ids in (ds["flat_ids"], i_k, ds["pq_ids"]))
    log(f"recall@10 vs exact scan, nprobe {nprobe}: IVF-Flat {r_flat:.4f}, raw IVF-PQ {r_raw:.4f}, "
        f"IVF-PQ + refine x4 {r_ref:.4f}")
    if r_flat < 0.85 or r_raw < 0.59:
        raise AssertionError(f"recall below the JAX tests' floors: IVF-Flat {r_flat} (>= 0.85), raw PQ {r_raw} (>= 0.59)")


def cuda_ms_cold(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device ms per launch: CUDA events around each launch, L2 flushed
    before it. A sleep kernel first holds the card while the host queues all
    launches, so the events see device time, not the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(n_bytes: float, n_ops: float, rate: str):
    """(least ms on the card, what bounds it): bytes over HBM, ops over peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[rate]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_ivf_kernels(ds: dict, device, tag: str) -> dict:
    """Phase 8: each IVF kernel against its plain version at the datastore's
    b64 nprobe-64 shapes; times (the wrapper call, L2 flushed before each),
    bounds."""
    from retrieval_scaling_tpu_torch.index.flat import quantize_rows_sq8
    from retrieval_scaling_tpu_torch.ops import ivf_gather as g

    flat, pq, nprobe = ds["IVFFlat"], ds["IVFPQ"], ds["nprobe"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def padded(ids, multiple):
        return torch.nn.functional.pad(ids, (0, -ids.shape[1] % multiple)).contiguous()

    results = {}
    with torch.inference_mode():
        q, tile_ids, valid = flat.scan_inputs(ds["queries"], nprobe)
        safe = torch.where(valid, tile_ids, 0).to(torch.int32).contiguous()
        safe4, valid4 = padded(safe, 4), padded(valid, 4)
        _, (lut, _, p_ids, p_valid, _) = pq.scan_inputs(ds["queries"], nprobe)
        p_safe = torch.where(p_valid, p_ids, 0).to(torch.int32).contiguous()
        p_safe8, p_valid8 = padded(p_safe, 8), padded(p_valid, 8)
        tiles, codes = flat.tiles_dev, pq.code_tiles_dev
        # the SQ8 tiles an IVFFlatIndex with quantization="int8" places
        tiles_i8 = torch.from_numpy(quantize_rows_sq8(flat.layout.sorted_rows)[0]).to(device).reshape(tiles.shape)
        b, d = q.shape
        m, ksub = lut.shape[1], lut.shape[2]
        q_bf, qf = q.to(torch.bfloat16).float(), q.float()
        cases = [  # (id, kernel call, plain call, slot ids, slot mask, tile bytes, rate of the products)
            ("K4", lambda: g.gather_score_tiles(q, tiles, safe),
             lambda: g.gather_score_tiles_reference(q_bf, tiles, safe), safe, valid, 128 * d * 2, "bf16"),
            ("K4 int8", lambda: g.gather_score_tiles(qf, tiles_i8, safe),
             lambda: g.gather_score_tiles_reference(qf, tiles_i8, safe), safe, valid, 128 * d, "f32"),
            ("K12", lambda: g.gather_score_tiles_grouped(qf, tiles, safe4),
             lambda: g.gather_score_tiles_reference(qf, tiles, safe4), safe4, valid4, 128 * d * 2, "f32"),
            ("K5a", lambda: g.gather_adc_tiles(lut, codes, p_safe),
             lambda: g.gather_adc_tiles_reference(lut, codes, p_safe), p_safe, p_valid, 128 * m, "f32"),
            ("K5b", lambda: g.gather_adc_tiles_grouped(lut, codes, p_safe8),
             lambda: g.gather_adc_tiles_reference(lut, codes, p_safe8), p_safe8, p_valid8, 128 * m, "f32"),
        ]
        for name, kernel, plain, ids, mask, tile_bytes, rate in cases:
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            if not math.isfinite(rel) or rel > IVF_TOL:
                raise AssertionError(f"{name}: max abs error {err} = {rel:.3e} of max |score| > {IVF_TOL}")
            flat_mask = mask[:, :, None].expand_as(out).reshape(b, -1)
            s_k, i_k = torch.topk(torch.where(flat_mask, out.reshape(b, -1), -1e30), 11)
            s_p, i_p = torch.topk(torch.where(flat_mask, ref.reshape(b, -1), -1e30), 11)
            bad = top_ids_apart_from_ties(*(t.cpu().numpy() for t in (s_k, i_k, s_p, i_p)), 10,
                                          IVF_TOL * ref.abs().max().item())
            if bad:
                raise AssertionError(f"{name}: top-10 slots differ from the plain version's in {bad}/{b} rows")
            del out, ref
            ms = cuda_ms_cold(kernel, 20, flush)
            plain_ms = cuda_ms_cold(plain, 3, flush)
            t = ids.shape[1]
            uniq = int(torch.unique(ids).numel())
            if name.startswith("K5"):
                n_bytes = uniq * tile_bytes + b * m * ksub * 4 + b * t * 4 + b * t * 128 * 4
                n_ops = b * t * 128 * m
            else:
                n_bytes = uniq * tile_bytes + b * d * 4 + b * t * 4 + b * t * 128 * 4
                n_ops = 2 * b * t * 128 * d
            bound_ms, bound_by = bound(n_bytes, n_ops, rate)
            gathered = b * t * tile_bytes
            log(f"{name}: max abs error {err:.3e} ({rel:.2e} of max |score|, tol {IVF_TOL}), top-10 slots equal "
                f"(ties aside); b{b} T {t} ({uniq} distinct tiles, {gathered / 1e9:.4f} GB gathered per call): "
                f"kernel {ms:.4f} ms ({gathered / ms / 1e6:.1f} GB/s gathered), plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e9:.4f} GB, {n_ops / 1e9:.3f} Gop) {tag}")
            results[name] = {"max_abs_err": err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by, "T": t}
    results["K4"]["max_abs_err"] = max(results["K4"]["max_abs_err"], results.pop("K4 int8")["max_abs_err"])
    return results


# ---------------------------------------------------------------- phases 9-11 (slice 3: generation, serving)
GEN_SLOTS, GEN_MAX_LEN = 4, 1024   # configs/serving.yaml's generation defaults


def decode_counters():
    """{name: wrapper or plain version} of the reader path's kernels and the
    plain versions whose CUDA calls must stay 0."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
    from retrieval_scaling_tpu_torch.ops import stream_probe as sp

    kernels = {"K1": fa.flash_attention, "K3": fa.flash_decode, "K6": qm.w8_stream, "K7": qm.w8_splitk,
               "K8": qm.int4_decode_matmul, "K9": qm.int8_matmul, "K13": sp.stream_probe}
    plain = [fa.flash_decode_reference, fa.attention_reference, qm.w8_stream_reference, qm.w8_splitk_reference,
             qm.int8_matmul_reference, qm.int4_matmul_reference, sp.stream_probe_reference]
    return kernels, plain


def reset_decode_counts() -> None:
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa

    kernels, plain = decode_counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plain:
        fn.cuda_calls = 0
    fa.flash_attention.window_launches = fa.flash_attention.cap_launches = 0
    fa.flash_decode.cap_launches = fa.flash_decode.verify_launches = 0


def read_decode_counts():
    """({kernel: launches}, plain calls on CUDA); "K2 window" / "K2 cap" /
    "K3 cap" count the K1 / K3 launches with a window or a cap, "K3 verify"
    the K3 launches of verify segments (per-query positions, Sq > 1)."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa

    kernels, plain = decode_counters()
    counts = {k: fn.launches for k, fn in kernels.items()}
    counts.update({"K2 window": fa.flash_attention.window_launches, "K2 cap": fa.flash_attention.cap_launches,
                   "K3 cap": fa.flash_decode.cap_launches, "K3 verify": fa.flash_decode.verify_launches})
    return counts, sum(fn.cuda_calls for fn in plain)


def c4_texts(n: int):
    with open(C4_SAMPLE) as f:
        return [json.loads(line)["text"] for line in f][:n]


def gen_prompts(tok, seed: int):
    """8 prompts of ~100-900 tokens cut from c4_sample, 32-64 new tokens each."""
    rng = np.random.RandomState(seed)
    pieces = [p for text in c4_texts(64) for p in PIECE_RE.findall(text)]
    out = []
    for i, n in enumerate(np.linspace(100, 900, 8).astype(int)):
        start = int(rng.randint(0, len(pieces) - n))
        out.append((" ".join(pieces[start:start + n]), int(32 + 32 * (i % 2))))
    return out


def http(port: int, route: str, payload=None):
    import urllib.request

    url = f"http://127.0.0.1:{port}{route}"
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def run_serving(run: dict, device, seed: int, tag: str, reader_dir: str | None = None, n_generate: int = 8,
                extra=()) -> dict:
    """Phase 9 (and 13, 20): the worker entry point on phase 4's index, with
    phase 4's reader (or ``reader_dir``) as the generation model; ``extra``
    overrides (phase 20: the speculative slot pool)."""
    import threading

    from retrieval_scaling_tpu_torch.models.generate import make_generate_fn
    from retrieval_scaling_tpu_torch.serve import __main__ as serve_main
    from retrieval_scaling_tpu_torch.serve.http_server import find_free_port

    root = os.path.dirname(run["corpus"])
    overrides = pipeline_argv(root, run["corpus"], run["enc_dir"], run["reader_dir"], device)[4:]
    argv = ["--mode", "worker", "--device", device.type, "--config-name", "example_config", "--registry", "",
            "--port", str(find_free_port(6000, 7000)), *overrides,
            f"serve.generation_model={reader_dir or run['reader_dir']}",
            f"serve.generation_slots={GEN_SLOTS}", f"serve.generation_max_len={GEN_MAX_LEN}", "serve.registry=null",
            *extra]
    with open(run["corpus"]) as f:
        queries = [" ".join(json.loads(next(f))["text"].split()[:12]) for _ in range(16)]

    reset_decode_counts()
    t0 = time.perf_counter()
    server = serve_main.main(argv, block=False)
    try:
        started = time.perf_counter() - t0
        gen = server.generator
        worker_tokens = {}  # prompt ids -> the tokens the worker emitted (eos cut), kept as each request finishes
        finish = gen._finish

        def recording_finish(req):
            finish(req)
            worker_tokens[tuple(req.prompt_ids)] = list(req.tokens)

        gen._finish = recording_finish
        prompts = gen_prompts(gen.tokenizer, seed)[:n_generate]
        search_out, search_ms = [None] * 16, [0.0] * 16

        def search(i):
            t = time.perf_counter()
            search_out[i] = http(server.port, "/search", {"query": queries[i], "n_docs": 10})["results"]
            search_ms[i] = (time.perf_counter() - t) * 1e3

        def generate(i):
            gen_out[i] = http(server.port, "/generate", {"prompt": prompts[i][0], "max_tokens": prompts[i][1]})

        for i in range(16):  # one at a time: per-request latency through HTTP
            search(i)
        gen_out = [None] * n_generate
        steps0 = gen.engine.stats["slot_steps"]
        t1 = time.perf_counter()
        threads = [threading.Thread(target=generate, args=(i,)) for i in range(n_generate)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gen_sec = time.perf_counter() - t1
        sync(device)
        launches, plain_calls = read_decode_counts()
        steps = (gen.engine.stats["slot_steps"] - steps0) // GEN_SLOTS
        if any(o is None for o in gen_out + search_out):
            raise AssertionError("a request failed")

        # checks, after the counts were read
        engine = next(iter(server.engines.values()))
        direct = engine.search_batch(queries, 10)
        bad = 0
        for got, ref in zip(search_out, direct):
            if [list(i) for i in got["IDs"][:5]] == [list(map(int, i)) for i in ref["IDs"][:5]]:
                continue
            tol = 2e-2 * max(abs(s) for s in ref["scores"])
            if abs(float(ref["scores"][4]) - float(ref["scores"][5])) > tol:
                bad += 1
        if bad:
            raise AssertionError(f"/search: {bad}/16 queries' top-5 ids differ from a direct search beyond ties")
        model, tok, eos = gen.engine.model, gen.tokenizer, gen.eos_id
        n_tokens = excused = 0
        for (prompt, max_new), out in zip(prompts, gen_out):
            ids = tok(prompt)["input_ids"]
            ids_t, lens_t = torch.tensor([ids], device=device), torch.tensor([len(ids)], device=device)
            full = make_generate_fn(model.cfg, max_new, eos)(model, ids_t, lens_t)
            toks = full[0].tolist()
            toks = toks[: toks.index(eos)] if eos in toks else toks
            got = worker_tokens.get(tuple(ids[-(gen.engine.max_len - max_new):]))
            if got != toks or out["text"] != tok.decode(toks, skip_special_tokens=True):
                # the first token where the worker leaves the static stream, and static greedy's top-2 gap there
                got = got or []
                t = next((j for j in range(min(len(got), len(toks))) if got[j] != toks[j]), min(len(got), len(toks)))
                step_logits, diff = verify_vs_step(model, model.cfg, ids_t, lens_t, full, gen.engine.draft_len,
                                                   None, device)
                if gen.engine.speculative:  # phase 20's rule
                    excused += divergence_verdict("/generate speculative", 0, t, step_logits[0], diff, False, tag)
                else:
                    top = step_logits[0, t - 1].topk(2).values if 1 <= t <= step_logits.shape[1] else None
                    gap = float(top[0] - top[1]) if top is not None else math.inf
                    fail_later(f"/generate ({len(ids)}-token prompt) differs from the static greedy text at token "
                               f"{t}; static greedy's top-2 logit gap there {gap:.4e} (the worker's rows run at "
                               f"another batch size than the static engine's one row)")
            n_tokens += out["n_tokens"]
        spec_stats = {k: gen.engine.stats[k] for k in ("spec_rounds", "spec_emitted")}
    finally:
        server.shutdown()
    need = model.cfg.num_layers * steps
    if launches["K3"] < need or launches["K1"] == 0 or plain_calls:
        raise AssertionError(f"serving: K3 launches {launches['K3']} (need >= {need}), K1 {launches['K1']}, "
                             f"plain calls on CUDA {plain_calls} (need 0)")
    p50 = float(np.percentile(search_ms, 50))
    log(f"serving: worker up in {started:.2f} s; 16 /search: p50 {p50:.2f} ms, max {max(search_ms):.2f} ms "
        f"(HTTP, host tokenizer, encoder, Flat scan, passage fetch); /search ids equal a direct search (ties aside) "
        f"{tag}")
    log(f"serving ({type(model.cfg).__name__}): {n_generate} concurrent /generate "
        f"({', '.join(str(len(gen.tokenizer(p)['input_ids'])) for p, _ in prompts)}"
        f"-token prompts) in {gen_sec:.3f} s: {n_tokens} tokens, {n_tokens / gen_sec:.1f} tokens/s at "
        f"{GEN_SLOTS} slots, {steps} decode steps; the token streams equal static greedy's but where noted; "
        f"K3 launches {launches['K3']} (>= {need}), K1 {launches['K1']}, plain attention / K3 on CUDA 0 {tag}")
    return {"K3": launches["K3"], "K1": launches["K1"], "search_p50_ms": p50, "tokens_per_s": n_tokens / gen_sec,
            "K3 verify": launches["K3 verify"], "spec": spec_stats, "excused": excused, "launches": launches,
            "layers": model.cfg.num_layers}


def _row_cosine(a, b):
    a, b = a.double(), b.double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()


# The JAX package's own limit for int4 logits against float ones
# (tests/test_quant_matmul.py:402): group-128 RTN int4 carries ~13 % weight
# noise, so on that test's reader (2 layers, hidden 256) a row cosine above
# 0.95 is the quality it holds; int4_quality_check holds the card to it on
# that configuration.
#
# WHOLE_PATH: with random N(0, 0.02) weights a reader carries a difference
# anywhere (a weight's int4 rounding, a sum taken in another order) layer by
# layer into the logits, and grows it the more the wider it is (weight
# variance x width: Llama-3.1-8B 0.0004 x 4096 = 1.64, Gemma-2-9B 1.43,
# Pythia-1B 0.82, the JAX int4 test's reader 0.10). On an H100 at 700 W,
# Llama-3.1-8B int4 against float: row cosine 0.837 / 0.731 / 0.577 /
# 0.393 / 0.257 at 2 / 4 / 8 / 16 / 32 layers, bf16 1.2e-2 to 5.0e-2 of max
# |logit|; Gemma-2-9B against the same layers with every kernel swapped for
# its plain version, bf16: 4.6e-3 / 3.0e-2 / 0.13 / 0.47 / 1.04 of max
# |logit| at 2 / 4 / 8 / 16 / 42 layers. So the deep readers' whole paths
# are held on their first layers (the same weights at full width) and the
# same differences at SWEEP_DEPTHS and full depth are printed:
#   * Llama-3.1-8B, 4 layers, against float: bf16 within 2e-2 of max
#     |logit|, int8 row cosine > 0.99; int4 > LLAMA_INT4_FLOOR, and int4
#     against the float path on its own dequantized weights > 0.99, which
#     leaves the kernels and the glue only the activations' int8 rounding;
#   * Gemma-2-9B, 2 layers, against the all-plain path: bf16 within 2e-2 of
#     max |logit|, int4 row cosine > 0.99.
# Each quantized or kernel path is also held call by call at full depth
# (check_path, kernel_swap: every launch of a prefill and a decode step
# against its plain version on that launch's own inputs, and the step run
# twice equal bit for bit). Pythia-1B (phase 10) keeps its whole-path
# limits, int4 at PYTHIA_INT4_FLOOR. Each int4 floor sits between the sound
# reading and a planted fault in the store (nibbles_swapped), which the run
# also measures and must fall below it.
INT4_COSINE = 0.95
PYTHIA_INT4_FLOOR = 0.9      # Pythia-1B int4 (16 layers) against float: 0.9397 sound, -0.0245 with the fault
LLAMA_INT4_FLOOR = 0.5       # Llama-3.1-8B int4, 4 layers, against float: 0.7314 sound, -0.0033 with the fault
LLAMA_HOLD_DEPTH, GEMMA_HOLD_DEPTH = 4, 2
SWEEP_DEPTHS = (2, 4, 8, 16)  # and the full depth


@torch.inference_mode()
def decode_step_logits(model, cfg, prompt, lens, nxt, device):
    """Logits [B, V] of the decode step that feeds ``nxt`` after a prefill
    of the right-padded ``prompt`` (f32 cache)."""
    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache

    b, width = prompt.shape
    cache = init_cache(cfg, b, width + 1, dtype=torch.float32, device=device)
    slots = torch.arange(width + 1, device=device)
    forward_with_cache(model, cfg, prompt, slots[:width].expand(b, width), cache, slots[None, :] < lens[:, None],
                       slots[None, :width] < lens[:, None], logits_rows=lens - 1)
    out, _ = forward_with_cache(model, cfg, nxt[:, None], lens[:, None], cache, slots[None, :] <= lens[:, None])
    return out[:, 0].float()


class kernel_swap:
    """Inside the block the reader path's K1/K2, K3, K6, K7, K8 and K9 calls
    go through stand-ins.

    mode "check": each call launches its kernel, then runs its plain version
    on the same inputs (as a check, never instead of it); ``ratio[kind]``
    holds the largest error over its limit, of max |y| of the plain version:
    K1/K2 1e-2 (bf16 in and out, K3's bf16 limit; phase 3's 2e-2 absolute
    assumes N(0, 1) inputs, a reader's V runs larger), K3, K6 and K7 1e-4
    (f32 out) or 1e-2 (16-bit out), K8 and K9 1e-5 (f32 out) or 1e-2.
    mode "plain": each call runs its plain version only, rounded to the
    kernel's output dtype (a check of a path's logits, never the path).

    A wrapper counts its launches on the function that its own module's name
    points at, so a stand-in put in the wrapper's module carries the
    wrapper's counters and hands them back on exit."""

    def __init__(self, mode: str = "check"):
        if mode not in ("check", "plain"):
            raise ValueError(mode)
        self.mode = mode

    def __enter__(self):
        from retrieval_scaling_tpu_torch.models import generate as pgen
        from retrieval_scaling_tpu_torch.ops import flash_attention as fa
        from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

        # each plain version returns (f32 result in the kernel's shape, the kernel's output dtype)
        def attention(q, k, v, kv_mask=None, causal=False, sm_scale=None, window=None, logit_cap=None,
                      segment_ids=None):
            return fa.attention_reference(q.float(), k.float(), v.float(), kv_mask, causal or window is not None,
                                          sm_scale, window, logit_cap, segment_ids), q.dtype

        def decode(q, k, v, kv_mask=None, sm_scale=None, logit_cap=None, q_pos=None, window=None):
            return fa.flash_decode_reference(q.float(), k.float(), v.float(), kv_mask, sm_scale, logit_cap, q_pos,
                                             window), q.dtype

        def k6(x2d, w, scale, out_dtype, x2=None, n_split=None):
            return qm.w8_stream_reference(x2d, w, scale, torch.float32, x2=x2, n_split=n_split), out_dtype

        def k7(xa, xb, w, sa, sb, out_dtype):
            return qm.w8_splitk_reference(xa, xb, w, sa, sb, torch.float32), out_dtype

        def k8(x, qw, out_dtype=torch.bfloat16):
            y = qm.int4_matmul_reference(x.reshape(-1, x.shape[-1]), qw.packed, qw.scale, torch.float32)
            return y.reshape(*x.shape[:-1], y.shape[-1]), out_dtype

        def k9(x, qw, bias=None, activation="none", out_dtype=torch.bfloat16):
            y = qm.int8_matmul_reference(x.reshape(-1, x.shape[-1]), qw.wq, qw.scale, bias, activation,
                                         torch.float32)
            return y.reshape(*x.shape[:-1], y.shape[-1]), out_dtype

        # kind: (module whose name the path calls, name, plain version, limit at f32 out, at 16-bit out)
        table = {"K1/K2": (fa, "flash_attention", attention, 1e-2, 1e-2),
                 "K3": (pgen, "flash_decode", decode, 1e-4, 1e-2),
                 "K6": (qm, "w8_stream", k6, 1e-4, 1e-2), "K7": (qm, "w8_splitk", k7, 1e-4, 1e-2),
                 "K8": (qm, "int4_decode_matmul", k8, 1e-5, 1e-2), "K9": (qm, "int8_matmul", k9, 1e-5, 1e-2)}
        self.ratio = {kind: 0.0 for kind in table}
        self.calls = {kind: 0 for kind in table}
        self.swaps = []
        for kind, (module, name, plain, tol32, tol16) in table.items():
            kernel = getattr(module, name)

            def stand_in(*args, _kind=kind, _kernel=kernel, _plain=plain, _tols=(tol32, tol16), **kw):
                if self.mode == "plain":
                    ref, dtype = _plain(*args, **kw)
                    return ref.to(dtype)
                out = _kernel(*args, **kw)
                ref, dtype = _plain(*args, **kw)
                tol = (_tols[0] if dtype == torch.float32 else _tols[1]) * ref.abs().max().item()
                err = (out.reshape(ref.shape).float() - ref).abs().max().item()
                self.ratio[_kind] = max(self.ratio[_kind], err / max(tol, 1e-30) if math.isfinite(err) else math.inf)
                self.calls[_kind] += 1
                return out

            carries = module.__name__ == kernel.__module__
            if carries:
                stand_in.__dict__.update(kernel.__dict__)
            self.swaps.append((module, name, kernel, stand_in, carries))
            setattr(module, name, stand_in)
        return self

    def __exit__(self, *exc):
        for module, name, kernel, stand_in, carries in self.swaps:
            if carries:
                kernel.__dict__.update(stand_in.__dict__)
            setattr(module, name, kernel)

    def verdict(self) -> str:
        return ", ".join(f"{k} {self.calls[k]} calls, worst {self.ratio[k]:.3f} of its limit"
                         for k in self.ratio if self.calls[k])

    def passed(self) -> bool:
        return all(v <= 1.0 for v in self.ratio.values())


def first_layers(model, cfg, depth: int):
    """(the reader cut to its first ``depth`` layers, its config): the same
    embeddings, final norm, head (float or quantized) and layer weights."""
    cut = types.SimpleNamespace(layers=model.layers[:depth], embed=model.embed, final_norm=model.final_norm)
    for name in ("lm_head", "q8"):
        if hasattr(model, name):
            setattr(cut, name, getattr(model, name))
    return cut, dataclasses.replace(cfg, num_layers=depth)


def int4_dequantized(qmodel, depth: int):
    """The first ``depth`` layers of an int4 llama reader with every weight
    (and the head) dequantized to f32, run by the float path: the int4
    weights' own error and nothing of the kernels or the int8 rounding of
    the activations. (A weight whose K is not a multiple of 128 is int8.)"""
    from retrieval_scaling_tpu_torch.models.generate import _LLAMA_PROJECTIONS
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    def weight(store, name):
        if f"{name}@q4" not in store:
            return store[f"{name}@q8"].float() * store[f"{name}@s"].reshape(1, -1)
        scale = store[f"{name}@s4g"].repeat_interleave(qm.INT4_GROUP, dim=0)
        return qm._int4_unpack(store[f"{name}@q4"]).float() * scale

    layers = []
    for layer in qmodel.layers[:depth]:
        plain = types.SimpleNamespace(**dict(layer.named_parameters(recurse=False)))
        for name in _LLAMA_PROJECTIONS:
            setattr(plain, name, weight(layer.q8, name))
        layers.append(plain)
    return types.SimpleNamespace(layers=layers, embed=qmodel.embed, final_norm=qmodel.final_norm,
                                 lm_head=weight(qmodel.q8, "lm_head"))


class nibbles_swapped:
    """A planted fault for the int4 whole-path limits: inside the block every
    int4 store of ``model`` holds its packed bytes with the two nibbles
    exchanged (row k of a weight read as row k + K/2 and back), in place."""

    def __init__(self, model):
        stores = [layer.q8 for layer in model.layers] + [model.q8]
        self.packed = [t for st in stores for key, t in st.items() if key.endswith("@q4")]

    def _swap(self):
        for t in self.packed:
            t.copy_((t << 4) | (t >> 4))

    def __enter__(self):
        self._swap()
        return self

    def __exit__(self, *exc):
        self._swap()


def check_path(model, cfg, prompt, lens, nxt, device, what: str, tag: str) -> torch.Tensor:
    """A quantized reader's path, call by call: a prefill and a decode step
    under kernel_swap (every kernel launch within its limit of its plain
    version on that launch's own inputs), and the same step run again gives
    the same logits bit for bit. Returns the step's logits."""
    with kernel_swap() as shadow:
        decode_step_logits(model, cfg, prompt, lens, nxt, device)
    a = decode_step_logits(model, cfg, prompt, lens, nxt, device)
    b = decode_step_logits(model, cfg, prompt, lens, nxt, device)
    same = bool(torch.equal(a, b))
    log(f"{what} path, every kernel call of a prefill and a decode step against its plain version on its own "
        f"inputs: {shadow.verdict()}; the step run twice gives equal logits: {same} {tag}")
    if not shadow.passed() or not same:
        fail_later(f"{what}: {shadow.verdict()}, repeat equal {same}")
    return a


def int4_quality_check(device, seed: int, tag: str, draws: int = 8) -> float:
    """The JAX int4 test's reader (tests/test_quant_matmul.py:371: llama,
    vocab 256, hidden 256, 2 layers, 4 heads over 2 KV heads, FFN 512,
    untied head) on the card: int4 logits of an 8-token prefill (b2)
    against float, through K1 and K8. The JAX test holds one draw of weights
    to a min row cosine above INT4_COSINE; that minimum moves with the draw
    (0.943-0.969 over eight seeds on the CPU), so the card holds the median
    over ``draws`` random N(0, 0.02) draws from --seed to it."""
    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache, quantize_decode_params
    from retrieval_scaling_tpu_torch.models.llama import LlamaConfig, init_llama_params

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                      intermediate_size=512, max_position_embeddings=64)
    pos = torch.arange(8, device=device).expand(2, 8)
    valid = (torch.arange(16, device=device)[None, :] < 8).expand(2, 16)
    cosines = []
    for draw in range(draws):
        gen = torch.Generator(device=device).manual_seed(seed * draws + draw)
        model = init_llama_params(cfg, gen, device=device)
        ids = torch.randint(0, 256, (2, 8), generator=gen, device=device)
        with torch.inference_mode():
            lf, _ = forward_with_cache(model, cfg, ids, pos, init_cache(cfg, 2, 16, torch.float32, device), valid,
                                       valid[:, :8])
            q4 = quantize_decode_params(model, cfg, scheme="int4")
            lq, _ = forward_with_cache(q4, cfg, ids, pos, init_cache(cfg, 2, 16, torch.float32, device), valid,
                                       valid[:, :8])
        cosines.append(_row_cosine(lq.reshape(-1, 256).float(), lf.reshape(-1, 256).float()))
    med = float(np.median(cosines))
    log(f"int4 on the JAX int4 test's reader (2 layers, hidden 256), {draws} weight draws: min row cosine "
        f"against float {', '.join(f'{c:.4f}' for c in cosines)}; median {med:.6f} (> {INT4_COSINE}, the JAX "
        f"limit) {tag}")
    if med <= INT4_COSINE:
        fail_later(f"int4 median cosine {med} <= {INT4_COSINE} on the JAX test's reader")
    return med


def run_reader_backend(run: dict, device, tag: str) -> dict:
    """Phase 10: TorchReaderLM with quantization None, bf16, int8 and int4."""
    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache
    from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_reader, load_tokenizer
    from retrieval_scaling_tpu_torch.rag_eval.models import TorchReaderLM

    model, tok = load_hf_reader(run["reader_dir"], device=device), load_tokenizer(run["reader_dir"])
    cfg = model.cfg
    stream = [p for t in c4_texts(128) for p in PIECE_RE.findall(t)]
    contexts = [" ".join(stream[300 * i: 300 * i + 256]) for i in range(8)]
    reqs = [{"context": c, "gen_kwargs": {"max_gen_toks": 64, "until": []}} for c in contexts]
    pairs = [(" ".join(stream[j: j + 200]), " " + " ".join(stream[j + 200: j + 220]))
             for j in range(2400, 2400 + 8 * 250, 250)]
    ids = [tok(c)["input_ids"] for c in contexts]
    width = max(len(i) for i in ids)
    prompt = torch.full((8, width), 0, dtype=torch.long, device=device)
    for r, i in enumerate(ids):
        prompt[r, : len(i)] = torch.tensor(i)
    lens = torch.tensor([len(i) for i in ids], device=device)
    out, launches_total, logits = {}, {}, {}
    for scheme in (None, "bf16", "int8", "int4"):
        lm = TorchReaderLM(model, cfg, tok, batch_size=8, quantization=scheme)
        reset_decode_counts()
        texts = lm.generate_until(reqs)
        scores = lm.loglikelihood(pairs)
        sync(device)
        launches, plain_calls = read_decode_counts()
        name = scheme or "float"
        if len(texts) != 8 or not all(math.isfinite(s) for s, _ in scores) or plain_calls:
            raise AssertionError(f"reader {name}: {len(texts)} texts, scores {scores}, plain calls on CUDA {plain_calls}")
        if scheme in ("bf16", "int8") and min(launches["K6"], launches["K7"]) == 0:
            raise AssertionError(f"reader {name}: launches {launches}")
        if scheme == "int8" and launches["K9"] == 0:
            raise AssertionError(f"reader int8: K9 launches {launches}")
        if (scheme == "int4") != (launches["K8"] > 0):
            raise AssertionError(f"reader {name}: K8 launches {launches['K8']}")
        for k in launches:
            launches_total[k] = launches_total.get(k, 0) + launches[k]
        # the first decode step's logits after a prefill, and ms per decode step
        with torch.inference_mode():
            cache = init_cache(cfg, 8, width + 32, dtype=torch.float32, device=device)
            slots = torch.arange(width + 32, device=device)
            pre, cache = forward_with_cache(lm.model, cfg, prompt, slots[:width].expand(8, width), cache,
                                            slots[None, :] < lens[:, None], slots[None, :width] < lens[:, None])
            nxt = logits["float"][1] if scheme else pre[torch.arange(8), lens - 1].argmax(-1)
            step_logits, _ = forward_with_cache(lm.model, cfg, nxt[:, None], lens[:, None], cache,
                                                slots[None, :] <= lens[:, None])
            logits[name] = (step_logits[:, 0].float(), nxt)
            if scheme is not None:
                check_path(lm.model, cfg, prompt, lens, nxt, device, f"reader {name}", tag)
            if scheme == "int4":
                with nibbles_swapped(lm.model):
                    logits["int4 fault"] = (decode_step_logits(lm.model, cfg, prompt, lens, nxt, device), nxt)
            cur = lens.clone()

            def step():
                nonlocal cur
                forward_with_cache(lm.model, cfg, nxt[:, None], cur[:, None], cache, slots[None, :] <= cur[:, None])
                cur = torch.clamp(cur + 1, max=width + 31)

            ms = cuda_ms(step, iters=20, warmup=3)
        out[name] = ms
        log(f"reader {name}: {sum(len(t) for t in texts)} chars generated, loglikelihood {scores[0][0]:.3f} "
            f"(pair 0), launches {launches}, plain calls on CUDA 0; decode step at b8 (1 token, "
            f"{width}-{width + 31} of {width + 32} slots, f32 cache): {ms:.4f} ms {tag}")
        del lm
    ref = logits["float"][0]
    err_bf16 = (logits["bf16"][0] - ref).abs().max().item() / ref.abs().max().item()
    cos_int8 = _row_cosine(logits["int8"][0], ref)
    cos_int4 = _row_cosine(logits["int4"][0], ref)
    cos_fault = _row_cosine(logits["int4 fault"][0], ref)
    log(f"reader logits, first decode step vs float: bf16 max |diff| {err_bf16:.3e} of max |logit| (tol 2e-2), "
        f"int8 min row cosine {cos_int8:.6f} (> 0.99), int4 {cos_int4:.6f} (> {PYTHIA_INT4_FLOOR}); the int4 "
        f"path with its nibbles swapped (a planted fault) {cos_fault:.6f} (< {PYTHIA_INT4_FLOOR}) {tag}")
    if err_bf16 > 2e-2 or cos_int8 <= 0.99 or cos_int4 <= PYTHIA_INT4_FLOOR or cos_fault >= PYTHIA_INT4_FLOOR:
        raise AssertionError(f"quantized logits: bf16 {err_bf16}, int8 cosine {cos_int8}, int4 {cos_int4}, "
                             f"int4 with a planted fault {cos_fault}")
    out["launches"] = launches_total
    return out


def check_decode_kernels(device, seed: int, tag: str) -> dict:
    """Phase 11: K3, K6, K7 and K9 against their plain versions, timed."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    # K3: (label, B, H, Hkv, M, D, dtype)
    cases = [(f"b{b} h8 D256 M{m} {name}", b, 8, 8, m, 256, dt) for b in (8, 1) for m in (1024, 2048)
             for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    for label, b, h, hkv, m, d, dt in cases + [("b8 h8/hkv2 D128 M1024 bf16", 8, 8, 2, 1024, 128, torch.bfloat16)]:
        q = torch.randn(b, h, 1, d, generator=gen, device=device).to(dt)
        k, v = (torch.randn(b, hkv, m, d, generator=gen, device=device).to(dt) for _ in range(2))
        lengths = torch.randint(m // 2, m + 1, (b,), generator=gen, device=device)
        mask = torch.arange(m, device=device)[None, :] < lengths[:, None]
        with torch.inference_mode():
            out = fa.flash_decode(q, k, v, kv_mask=mask)
            ref = fa.flash_decode_reference(q.float(), k.float(), v.float(), kv_mask=mask)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        # f32: 1e-4 of max |y|; bf16: 1e-2 of max |y|, a few bf16 ulps at the
        # output's scale
        tol = (1e-4 if dt == torch.float32 else 1e-2) * ref.abs().max().item()
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"K3 {label}: max abs error {err} > {tol}")
        ms = cuda_ms_cold(lambda: fa.flash_decode(q, k, v, kv_mask=mask), 20, flush)
        plain_ms = cuda_ms_cold(lambda: fa.flash_decode_reference(q, k, v, kv_mask=mask), 5, flush)
        lib_ms = cuda_ms_cold(lambda: sdpa(q, k, v, attn_mask=mask[:, None, None, :], enable_gqa=hkv != h), 20, flush)
        valid = int(lengths.sum().item())
        elt = torch.finfo(dt).bits // 8
        n_bytes = 2 * valid * hkv * d * elt + 2 * b * h * d * elt + b * m
        bound_ms, bound_by = bound(n_bytes, 4 * valid * h * d, "f32" if dt == torch.float32 else "bf16")
        log(f"K3 {label}: max abs error {err:.3e} (tol {tol:.1e}); kernel {ms:.4f} ms "
            f"({n_bytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, SDPA (not a repo kernel) {lib_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB of valid K/V) {tag}")
        results[f"K3 {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by}

    # K6 / K7 at Pythia-1B's decode shapes: (label, K, N)
    def weights(k, n, scheme):
        w = 0.02 * torch.randn(k, n, generator=gen, device=device)
        if scheme == "int8":
            return qm.quantize_weight(w)
        return qm.QuantizedWeight(w.to(torch.bfloat16), torch.ones(1, n, device=device))

    for scheme in ("int8", "bf16"):
        qkv_mi, head = weights(2048, 14336, scheme), weights(2048, 50304, scheme)
        wa, wb = weights(2048, 2048, scheme), weights(8192, 2048, scheme)
        ao_mo = torch.cat([wa.wq, wb.wq])
        elt = ao_mo.element_size()
        for m in (8, 64):
            x, x2 = (torch.randn(m, 2048, generator=gen, device=device) for _ in range(2))
            xa, xb = torch.randn(m, 2048, generator=gen, device=device), torch.randn(m, 8192, generator=gen, device=device)
            cases = [
                ("K6", f"qkv_mi 2048x14336 b{m}", lambda: qm.w8_stream(x, qkv_mi.wq, qkv_mi.scale, torch.float32),
                 lambda: qm.w8_stream_reference(x, qkv_mi.wq, qkv_mi.scale, torch.float32),
                 lambda: torch.matmul(x.to(torch.bfloat16), qkv_mi.wq), 2048, 14336),
                ("K6", f"qkv_mi dual input b{m}",
                 lambda: qm.w8_stream(x, qkv_mi.wq, qkv_mi.scale, torch.float32, x2=x2, n_split=6144),
                 lambda: qm.w8_stream_reference(x, qkv_mi.wq, qkv_mi.scale, torch.float32, x2=x2, n_split=6144),
                 None, 2048, 14336),
                ("K6", f"embed_out 2048x50304 b{m}", lambda: qm.w8_stream(x, head.wq, head.scale, torch.float32),
                 lambda: qm.w8_stream_reference(x, head.wq, head.scale, torch.float32),
                 lambda: torch.matmul(x.to(torch.bfloat16), head.wq), 2048, 50304),
                ("K7", f"ao_mo 10240x2048 b{m}",
                 lambda: qm.w8_splitk(xa, xb, ao_mo, wa.scale, wb.scale, torch.float32),
                 lambda: qm.w8_splitk_reference(xa, xb, ao_mo, wa.scale, wb.scale, torch.float32),
                 lambda: torch.matmul(torch.cat([xa, xb], 1).to(torch.bfloat16), ao_mo), 10240, 2048),
            ]
            for kid, label, kernel, plain, lib, kk, n in cases:
                with torch.inference_mode():
                    y, y_ref = kernel(), plain()
                torch.cuda.synchronize()
                err = (y - y_ref).abs().max().item()
                tol = 1e-4 * y_ref.abs().max().item()
                if not math.isfinite(err) or err > tol:
                    raise AssertionError(f"{kid} {scheme} {label}: max abs error {err} > {tol}")
                ms = cuda_ms_cold(kernel, 20, flush)
                plain_ms = cuda_ms_cold(plain, 5, flush)
                lib_ms = cuda_ms_cold(lib, 20, flush) if lib is not None and scheme == "bf16" else None
                n_x = 2 if "dual" in label else 1
                n_bytes = kk * n * elt + n_x * m * kk * 2 + m * n * 4 + 2 * n * 4
                bound_ms, bound_by = bound(n_bytes, 2 * m * kk * n, "bf16")
                lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
                log(f"{kid} {scheme} {label}: max abs error {err:.3e} ({err / y_ref.abs().max().item():.1e} of max |y|);"
                    f" kernel {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, torch.matmul "
                    f"(not a repo kernel) {lib_txt}, bound {bound_ms:.4f} ms ({bound_by}) {tag}")
                results[f"{kid} {scheme} {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                                     "library_ms": lib_ms, "bound_ms": bound_ms,
                                                     "bound_by": bound_by}
        del qkv_mi, head, wa, wb, ao_mo

    # K9 at prefill sizes, f32 activations (the reader's dtype): the whole
    # qkv_mi at m 1024 and a ragged 200, then the reader's own calls at
    # m = 8 x 256 through the store helpers, on column slices (row stride
    # 14336, nonzero column offset) and row parts of the fused weights, and
    # on the head
    qkv_mi, wa, wb, head = (weights(2048, 14336, "int8"), weights(2048, 2048, "int8"),
                            weights(8192, 2048, "int8"), weights(2048, 50304, "int8"))
    ao_mo = torch.cat([wa.wq, wb.wq])
    store = {"qkv_mi@q8": qkv_mi.wq, "qkv_mi@s": qkv_mi.scale, "ao_mo@q8": ao_mo, "ao_mo@sa": wa.scale,
             "ao_mo@sb": wb.scale, "embed_out@q8": head.wq, "embed_out@s": head.scale}
    x1k, x200, x, h = (torch.randn(m, k, generator=gen, device=device)
                       for m, k in ((1024, 2048), (200, 2048), (2048, 2048), (2048, 8192)))
    f32 = torch.float32
    cases = [  # (label, kernel call, the plain version's x, wq view and scale)
        ("qkv_mi 2048x14336 m1024", lambda: qm.int8_matmul(x1k, qkv_mi, out_dtype=f32), x1k, qkv_mi.wq, qkv_mi.scale),
        ("qkv_mi 2048x14336 m200", lambda: qm.int8_matmul(x200, qkv_mi, out_dtype=f32), x200, qkv_mi.wq,
         qkv_mi.scale),
        ("qkv_mi[:, :6144] m2048", lambda: qm.q8_col_slice_dot(store, "qkv_mi", x, 0, 6144), x,
         qkv_mi.wq[:, :6144], qkv_mi.scale[:, :6144]),
        ("qkv_mi[:, 6144:] m2048", lambda: qm.q8_col_slice_dot(store, "qkv_mi", x, 6144, 14336), x,
         qkv_mi.wq[:, 6144:], qkv_mi.scale[:, 6144:]),
        ("ao_mo[:2048] m2048", lambda: qm.q8_row_part_dot(store, "ao_mo", x, "a"), x, ao_mo[:2048], wa.scale),
        ("ao_mo[2048:] m2048", lambda: qm.q8_row_part_dot(store, "ao_mo", h, "b"), h, ao_mo[2048:], wb.scale),
        ("embed_out 2048x50304 m2048", lambda: qm.q8_dot(store, "embed_out", x, out_dtype=f32), x, head.wq,
         head.scale),
    ]
    for label, kernel, xin, wq, scale in cases:
        def plain():
            return qm.int8_matmul_reference(xin, wq, scale, None, "none", f32)

        with torch.inference_mode():
            y, y_ref = kernel(), plain()
        torch.cuda.synchronize()
        spacing = torch.finfo(f32).eps * y_ref.abs().clamp_min(1e-30)
        ulps = ((y - y_ref).abs() / spacing).max().item()
        err = (y - y_ref).abs().max().item()
        if not math.isfinite(ulps) or ulps > 1:
            raise AssertionError(f"K9 {label}: {ulps} ulps from the plain version (tol 1)")
        ms = cuda_ms_cold(kernel, 20, flush)
        plain_ms = cuda_ms_cold(plain, 3, flush)
        (m, k), n = xin.shape, wq.shape[1]
        n_ops = 2 * m * k * n
        n_bytes = m * k * 4 + k * n + m * n * 4 + n * 4
        bound_ms, bound_by = bound(n_bytes, n_ops, "int8")
        log(f"K9 {label}: {ulps:.2f} ulp from the plain version (max abs {err:.3e}); kernel "
            f"{ms:.4f} ms ({n_ops / ms / 1e9:.1f} TOP/s, row quantisation pre-pass included), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}) {tag}")
        results[f"K9 {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                                  "bound_ms": bound_ms, "bound_by": bound_by}
    return results


# ---------------------------------------------------------------- phases 12-15 (slice 4: llama-family reader)
def llama31_8b(num_layers: int = 32):
    """meta-llama/Llama-3.1-8B's config.json (published widths; depth may be cut)."""
    from retrieval_scaling_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=128256, hidden_size=4096, num_layers=num_layers, num_heads=32, num_kv_heads=8,
                       head_dim=128, intermediate_size=14336, max_position_embeddings=131072, rope_base=500000.0,
                       rms_eps=1e-5, rope_scaling_type="llama3", rope_factor=8.0, rope_low_freq_factor=1.0,
                       rope_high_freq_factor=4.0, rope_original_max_pos=8192)


def gemma2_9b():
    """google/gemma-2-9b's config.json, read the way the JAX package reads it."""
    from retrieval_scaling_tpu_torch.models.hf_convert import llama_config_from_hf

    return llama_config_from_hf({
        "model_type": "gemma2", "vocab_size": 256000, "hidden_size": 3584, "num_hidden_layers": 42,
        "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256, "intermediate_size": 14336,
        "max_position_embeddings": 8192, "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "sliding_window": 4096,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 256,
        "hidden_activation": "gelu_pytorch_tanh", "tie_word_embeddings": True,
    })


def stream_buffers(model) -> list:
    """The weight buffers a quantized decode step streams: every tensor of
    the layers' and the head's q8 stores (weights and scales)."""
    stores = [layer.q8 for layer in model.layers] + [model.q8]
    return [t for st in stores for t in st.values() if t.dim() == 2]


def c4_stream():
    return [p for t in c4_texts(200) for p in PIECE_RE.findall(t)]


def decode_step_counts(model, cfg, device):
    """Kernel launches of ONE decode step at b8 after a 16-token prefill."""
    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache

    with torch.inference_mode():
        cache = init_cache(cfg, 8, 32, dtype=torch.float32, device=device)
        slots = torch.arange(32, device=device)
        ids = torch.randint(3, 1000, (8, 16), device=device)
        valid = (slots[None, :] < 16).expand(8, 32)  # kernels take [B, M] masks
        forward_with_cache(model, cfg, ids, slots[:16].expand(8, 16), cache, valid, valid[:, :16])
        sync(device)
        reset_decode_counts()
        forward_with_cache(model, cfg, ids[:, :1], torch.full((8, 1), 16, device=device), cache,
                           (slots[None, :] <= 16).expand(8, 32))
        sync(device)
    return read_decode_counts()[0]


def run_llama_backend(device, seed: int, tok, tag: str) -> dict:
    """Phase 12: Llama-3.1-8B at full depth through TorchReaderLM, quantization
    None (f32), bf16, int8 and int4, one scheme on the card at a time."""
    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache
    from retrieval_scaling_tpu_torch.models.llama import init_llama_params
    from retrieval_scaling_tpu_torch.ops.stream_probe import stream_floor
    from retrieval_scaling_tpu_torch.rag_eval.models import TorchReaderLM

    cfg = llama31_8b()
    t0 = time.perf_counter()
    model = init_llama_params(cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    sync(device)
    log(f"llama: Llama-3.1-8B random f32 weights on the card in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters)")
    stream = c4_stream()
    contexts = [" ".join(stream[300 * i: 300 * i + 256]) for i in range(8)]
    reqs = [{"context": c, "gen_kwargs": {"max_gen_toks": 64, "until": []}} for c in contexts]
    pairs = [(" ".join(stream[j: j + 200]), " " + " ".join(stream[j + 200: j + 220]))
             for j in range(2400, 2400 + 8 * 250, 250)]
    ids = [tok(c)["input_ids"] for c in contexts]
    width = max(len(i) for i in ids)
    prompt = torch.zeros((8, width), dtype=torch.long, device=device)
    for r, i in enumerate(ids):
        prompt[r, : len(i)] = torch.tensor(i)
    lens = torch.tensor([len(i) for i in ids], device=device)
    out, totals, sweep, nxt = {"ms": {}, "floor": {}}, {}, {}, None
    depths = (*SWEEP_DEPTHS, cfg.num_layers)
    # one launch per weight stream of a decode step: qkv3, o_w, gateup, down_w
    # (K6) or the seven projections (K8) of every layer, and the head
    n_l = cfg.num_layers
    per_step = {"bf16": ("K6", 4 * n_l + 1), "int8": ("K6", 4 * n_l + 1), "int4": ("K8", 7 * n_l + 1)}
    for scheme in (None, "bf16", "int8", "int4"):
        name = scheme or "float"
        lm = TorchReaderLM(model, cfg, tok, batch_size=8, quantization=scheme)
        reset_decode_counts()
        texts = lm.generate_until(reqs)
        scores = lm.loglikelihood(pairs)
        sync(device)
        launches, plain_calls = read_decode_counts()
        if len(texts) != 8 or not all(math.isfinite(v) for v, _ in scores) or plain_calls:
            fail_later(f"llama {name}: {len(texts)} texts, scores {scores}, plain calls on CUDA {plain_calls}")
        if launches["K1"] == 0 or launches["K3"] < cfg.num_layers:
            fail_later(f"llama {name}: launches {launches}")
        if scheme in ("bf16", "int8") and launches["K6"] == 0 or scheme == "int8" and launches["K9"] == 0:
            fail_later(f"llama {name}: launches {launches}")
        if (scheme == "int4") != (launches["K8"] > 0):
            fail_later(f"llama {name}: K8 launches {launches['K8']}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        step = ""
        if scheme is not None:
            kid, want = per_step[scheme]
            got = decode_step_counts(lm.model, cfg, device)
            if got[kid] != want or got["K3"] != cfg.num_layers:
                fail_later(f"llama {name}: one decode step launched {got} ({kid} {want} and K3 "
                           f"{cfg.num_layers} expected)")
            step = f"; one decode step: {kid} {got[kid]}, K3 {got['K3']}"
        with torch.inference_mode():
            cache = init_cache(cfg, 8, width + 32, dtype=torch.float32, device=device)
            slots = torch.arange(width + 32, device=device)
            pre, cache = forward_with_cache(lm.model, cfg, prompt, slots[:width].expand(8, width), cache,
                                            slots[None, :] < lens[:, None], slots[None, :width] < lens[:, None])
            if nxt is None:  # the float model's greedy token feeds every scheme's first decode step
                nxt = pre[torch.arange(8), lens - 1].argmax(-1)
            if scheme is not None:
                check_path(lm.model, cfg, prompt, lens, nxt, device, f"llama {name}", tag)
            # the first decode step's logits of the first d layers (WHOLE_PATH)
            sweep[name] = {d: decode_step_logits(*first_layers(lm.model, cfg, d), prompt, lens, nxt, device)
                           for d in depths}
            if scheme == "int4":
                cut_cfg = first_layers(lm.model, cfg, LLAMA_HOLD_DEPTH)[1]
                sweep["int4 dequantized"] = decode_step_logits(int4_dequantized(lm.model, LLAMA_HOLD_DEPTH), cut_cfg,
                                                               prompt, lens, nxt, device)
                with nibbles_swapped(lm.model):
                    sweep["int4 fault"] = decode_step_logits(*first_layers(lm.model, cfg, LLAMA_HOLD_DEPTH), prompt,
                                                             lens, nxt, device)
            cur = lens.clone()

            def one_step():
                nonlocal cur
                forward_with_cache(lm.model, cfg, nxt[:, None], cur[:, None], cache, slots[None, :] <= cur[:, None])
                cur = torch.clamp(cur + 1, max=width + 31)

            ms = cuda_ms(one_step, iters=10, warmup=2)
        out["ms"][name] = ms
        floor_txt = ""
        if scheme is not None:
            before = read_decode_counts()[0]["K13"]
            floor = stream_floor(stream_buffers(lm.model), reps=10)
            floor["launches"] = read_decode_counts()[0]["K13"] - before
            out["floor"][name] = floor
            floor_txt = (f"; K13 floor of its {floor['bytes'] / 1e9:.3f} GB of weight buffers {floor['ms']:.4f} ms "
                         f"({floor['gb_per_s']:.1f} GB/s), step = {100 * floor['ms'] / ms:.1f} % of the floor's "
                         f"rate (step / floor {ms / floor['ms']:.2f})")
        log(f"llama {name}: {sum(len(t) for t in texts)} chars generated, loglikelihood {scores[0][0]:.3f} (pair 0), "
            f"launches {launches}, plain calls on CUDA 0{step}; decode step at b8 ({width}-{width + 31} of "
            f"{width + 32} slots, f32 cache): {ms:.4f} ms{floor_txt} {tag}")
        del lm
        torch.cuda.empty_cache()
    rows = {}
    for d in depths:
        ref = sweep["float"][d]
        rows[d] = {"bf16_max_diff": (sweep["bf16"][d] - ref).abs().max().item() / ref.abs().max().item(),
                   **{f"{k}_cosine": _row_cosine(sweep[k][d], ref) for k in ("bf16", "int8", "int4")}}
    out["by_depth"] = rows
    held = rows[LLAMA_HOLD_DEPTH]
    deq = sweep["int4 dequantized"]
    held["int4_vs_dequantized_cosine"] = _row_cosine(sweep["int4"][LLAMA_HOLD_DEPTH], deq)
    held["dequantized_cosine"] = _row_cosine(deq, sweep["float"][LLAMA_HOLD_DEPTH])
    fault = {"float": _row_cosine(sweep["int4 fault"], sweep["float"][LLAMA_HOLD_DEPTH]),
             "dequantized": _row_cosine(sweep["int4 fault"], deq)}
    out["fault"] = fault
    log("llama first-decode-step logits against float by depth (the first d layers of the same weights, WHOLE_PATH): "
        + "; ".join(f"{d} layers: bf16 max |diff| {r['bf16_max_diff']:.3e} of max |logit|, min row cosine bf16 "
                    f"{r['bf16_cosine']:.6f}, int8 {r['int8_cosine']:.6f}, int4 {r['int4_cosine']:.6f}"
                    for d, r in rows.items())
        + f"; held at {LLAMA_HOLD_DEPTH} layers: bf16 <= 2e-2, int8 > 0.99, int4 > {LLAMA_INT4_FLOOR} (with its "
          f"nibbles swapped, a planted fault: {fault['float']:.6f}); int4 against the float path on its own "
          f"dequantized weights {held['int4_vs_dequantized_cosine']:.6f} (> 0.99; the planted fault "
          f"{fault['dequantized']:.6f}), those dequantized weights against float {held['dequantized_cosine']:.6f} "
          f"{tag}")
    if (held["bf16_max_diff"] > 2e-2 or held["int8_cosine"] <= 0.99 or held["int4_cosine"] <= LLAMA_INT4_FLOOR
            or held["int4_vs_dequantized_cosine"] <= 0.99 or fault["float"] >= LLAMA_INT4_FLOOR
            or fault["dequantized"] >= 0.99):
        fail_later(f"llama at {LLAMA_HOLD_DEPTH} layers: {held}, int4 with a planted fault {fault}")
    out["int4_cosine_jax_reader"] = int4_quality_check(device, seed, tag)
    del model
    torch.cuda.empty_cache()
    out["launches"] = totals
    return out


def run_llama_cli(run: dict, device, seed: int, tok, tag: str) -> dict:
    """Phase 13: a Llama-3.1-8B-width checkpoint cut to 4 layers through the
    perplexity CLI (phase 4's Flat index) and the serving worker's /generate."""
    from retrieval_scaling_tpu_torch.models.hf_convert import save_hf_checkpoint
    from retrieval_scaling_tpu_torch.models.llama import init_llama_params
    from retrieval_scaling_tpu_torch.pipeline import main as pipeline_main

    root = os.path.dirname(run["corpus"])
    cfg = llama31_8b(num_layers=4)
    llama_dir = os.path.join(root, "llama-3.1-8b-width-4-layers-random")
    t0 = time.perf_counter()
    model = init_llama_params(cfg, torch.Generator(device=device).manual_seed(seed), device=device,
                              dtype=torch.bfloat16)
    # the head drawn at std 0.01: random logits of spread sigma cost ln V +
    # sigma^2 / 2, and at std 0.02 sigma is 1.28 at this width
    model.lm_head.mul_(0.5)
    save_hf_checkpoint(model, llama_dir)
    tok.save_pretrained(llama_dir)
    del model
    torch.cuda.empty_cache()
    log(f"llama checkpoint: 4 layers at Llama-3.1-8B width written in {time.perf_counter() - t0:.1f} s "
        f"({os.path.getsize(os.path.join(llama_dir, 'pytorch_model.bin')) / 1e9:.2f} GB, bf16)")
    argv = pipeline_argv(root, run["corpus"], run["enc_dir"], llama_dir, device)
    argv += ["evaluation.search.overwrite=true", f"evaluation.results_only_log_file={root}/results_llama.log"]
    reset_decode_counts()
    result = pipeline_main.main(argv)
    sync(device)
    launches, plain_calls = read_decode_counts()
    ppl = result["ppl"]
    ln_v = math.log(cfg.vocab_size)
    if not math.isfinite(ppl.perplexity) or abs(ppl.average_loss - ln_v) > 0.5 or launches["K1"] == 0 or plain_calls:
        fail_later(f"llama CLI: avg loss {ppl.average_loss} (ln V {ln_v:.4f}), K1 {launches['K1']}, "
                             f"plain calls on CUDA {plain_calls}")
    log(f"llama CLI: avg loss {ppl.average_loss:.4f} (ln V = {ln_v:.4f}), ppl {ppl.perplexity:.2f}, K1 launches "
        f"{launches['K1']}, plain attention on CUDA 0; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in result["stage_seconds"].items()) + f" {tag}")
    serving = run_serving(run, device, seed, tag, reader_dir=llama_dir, n_generate=4)
    return {"K1": launches["K1"], "serving": serving, "dir": llama_dir}


@torch.inference_mode()
def first_step_logits(model, cfg, ids, device, nxt):
    """Logits of the decode step that feeds ``nxt`` [1] after a prefill of
    ``ids`` [1, S] (bf16 cache); ``nxt`` None takes the prefill's greedy
    token. Returns (logits [1, V], the token fed)."""
    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache

    s = ids.shape[1]
    cache = init_cache(cfg, 1, s + 1, dtype=torch.bfloat16, device=device)
    slots = torch.arange(s + 1, device=device)
    pre, cache = forward_with_cache(model, cfg, ids, slots[:s][None], cache, slots[None, :] < s,
                                    slots[None, :s] < s, logits_rows=torch.tensor([s - 1], device=device))
    if nxt is None:
        nxt = pre[:, 0].argmax(-1)
    step, _ = forward_with_cache(model, cfg, nxt[:, None], torch.full((1, 1), s, device=device), cache,
                                 slots[None, :] <= s)
    return step[:, 0].float(), nxt


def run_gemma_backend(device, seed: int, tok, tag: str) -> dict:
    """Phase 14: Gemma-2-9B at full depth through TorchReaderLM, bf16 and int4:
    loglikelihood of ~7,000-token contexts (batch 2), one generate_until with
    a prompt longer than the 4096-token window."""
    from retrieval_scaling_tpu_torch.models.llama import init_llama_params
    from retrieval_scaling_tpu_torch.rag_eval.models import TorchReaderLM

    cfg = gemma2_9b()
    n_sliding = sum(cfg.sliding_pattern)
    t0 = time.perf_counter()
    model = init_llama_params(cfg, torch.Generator(device=device).manual_seed(seed + 1), device=device,
                              dtype=torch.bfloat16)
    sync(device)
    log(f"gemma: Gemma-2-9B random bf16 weights on the card in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, {n_sliding} sliding layers)")
    stream = c4_stream()
    pieces = len(stream)
    pairs = [(" ".join(stream[j: j + 7000]), " " + " ".join(stream[j + 7000: j + 7040])) for j in (0, pieces - 7100)]
    long_prompt = " ".join(stream[1000: 1000 + 4600])
    req = [{"context": long_prompt, "gen_kwargs": {"max_gen_toks": 32, "until": []}}]
    n_ctx = [len(tok(c)["input_ids"]) for c, _ in pairs]
    n_prompt = len(tok(long_prompt)["input_ids"])
    if min(n_ctx) < 6500 or n_prompt <= cfg.sliding_window:
        raise AssertionError(f"gemma inputs too short: contexts {n_ctx}, prompt {n_prompt}")
    ids = torch.tensor([tok(long_prompt)["input_ids"]], device=device)
    out = {"launches": {}, "tokens_per_s": {}}
    for scheme in (None, "int4"):
        name = scheme or "bf16"
        lm = TorchReaderLM(model, cfg, tok, batch_size=2, quantization=scheme)
        reset_decode_counts()
        scores = lm.loglikelihood(pairs)
        texts = lm.generate_until(req)
        sync(device)
        launches, plain_calls = read_decode_counts()
        forwards = 2  # one scoring batch, one prefill
        if (len(texts) != 1 or not all(math.isfinite(v) for v, _ in scores) or plain_calls
                or launches["K2 window"] != n_sliding * forwards or launches["K2 cap"] != cfg.num_layers * forwards
                or launches["K2 cap"] != launches["K1"] or launches["K3 cap"] < cfg.num_layers
                or (scheme == "int4") != (launches["K8"] > 0)):
            fail_later(f"gemma {name}: scores {scores}, launches {launches}, plain calls on CUDA {plain_calls}")
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        t1 = time.perf_counter()  # a second scoring call, timed
        lm.loglikelihood(pairs)
        sync(device)
        ll_sec = time.perf_counter() - t1
        tok_s = sum(n_ctx) / ll_sec
        out["tokens_per_s"][name] = tok_s
        # held call by call (WHOLE_PATH): every K2 / K3 / K8 launch of the
        # long prompt's prefill and first decode step against its plain
        # version on its own inputs, and the step run twice bit for bit
        got, nxt = first_step_logits(lm.model, cfg, ids, device, None)
        with kernel_swap() as shadow:
            first_step_logits(lm.model, cfg, ids, device, nxt)
        same = bool(torch.equal(got, first_step_logits(lm.model, cfg, ids, device, nxt)[0]))
        # the first d layers against the same layers with every kernel swapped
        # for its plain version (WHOLE_PATH), the same token fed to both,
        # held at GEMMA_HOLD_DEPTH
        by_depth = {}
        for d in (*SWEEP_DEPTHS, cfg.num_layers):
            cut = first_layers(lm.model, cfg, d)
            kern = got if d == cfg.num_layers else first_step_logits(*cut, ids, device, nxt)[0]
            with kernel_swap("plain"):
                want = first_step_logits(*cut, ids, device, nxt)[0]
            by_depth[d] = ((kern - want).abs().max().item() / want.abs().max().item(), _row_cosine(kern, want))
        out.setdefault("by_depth", {})[name] = by_depth
        log(f"gemma {name}: loglikelihood of {n_ctx}-token contexts at b2 in {ll_sec:.3f} s ({tok_s:.1f} tokens/s, "
            f"second call, host tokenization included), {scores[0][0]:.3f} (pair 0); generate_until of a "
            f"{n_prompt}-token prompt (window {cfg.sliding_window}); launches {launches}, plain calls on CUDA 0; "
            f"every kernel call of the prompt's prefill and first decode step against its plain version on its own "
            f"inputs: {shadow.verdict()}; the step run twice gives equal logits: {same}; first-step logits of the "
            f"first d layers against the same layers with every kernel swapped for its plain version: " + "; ".join(
                f"{d} layers max |diff| {e:.3e} of max |logit|, cosine {c:.6f}" for d, (e, c) in by_depth.items())
            + f" (held at {GEMMA_HOLD_DEPTH} layers: " + ("row cosine > 0.99" if scheme else "<= 2e-2 of max |logit|")
            + f") {tag}")
        if (not shadow.passed() or not same or shadow.calls["K1/K2"] != cfg.num_layers
                or (by_depth[GEMMA_HOLD_DEPTH][1] <= 0.99 if scheme else by_depth[GEMMA_HOLD_DEPTH][0] > 2e-2)):
            fail_later(f"gemma {name}: {shadow.verdict()}, repeat equal {same}, against the plain path at "
                       f"{GEMMA_HOLD_DEPTH} layers {by_depth[GEMMA_HOLD_DEPTH]}")
        del lm
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return out


CAP_SPREAD = 0.5  # phase 15's capped cases scale q so that the scores spread to about cap / 2


def cap_effect(cap, ref, uncapped, tol: float, label: str, tag: str) -> bool:
    """Does the cap move the plain output (``ref``, capped; ``uncapped()``
    without the cap) by more than ten times the limit, so that a kernel
    without it fails? True where there is no cap."""
    if not cap:
        return True
    moved = (uncapped() - ref.float()).abs().max().item()
    log(f"{label}: the plain version's capped and uncapped outputs differ by {moved:.3e} ({moved / tol:.0f} x the "
        f"limit {tol:.1e}) {tag}")
    return moved > 10 * tol


def check_slice4_kernels(device, seed: int, tag: str) -> dict:
    """Phase 15: K2, K3 + cap, K8 and K13 against their plain versions at the
    path's shapes, timed against their bounds and yardsticks."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
    from retrieval_scaling_tpu_torch.ops.stream_probe import stream_floor, stream_probe_reference

    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    bf = torch.bfloat16
    # K2: (label, B, H, Hkv, S, D, window, cap)
    for label, b, h, hkv, s_len, d, window, cap in (
        ("gemma2 b1 h16/kv8 S8192 d256 w4096 cap50", 1, 16, 8, 8192, 256, 4096, 50.0),
        ("mistral b1 h32/kv8 S8192 d128 w4096", 1, 32, 8, 8192, 128, 4096, None),
        ("phi3 b1 h32/kv32 S4096 d96 w2047", 1, 32, 32, 4096, 96, 2047, None),
    ):
        # with a cap, scores spread to about cap / 2 (CAP_SPREAD) so that the cap bites
        q = (torch.randn(b, h, s_len, d, generator=gen, device=device) * (CAP_SPREAD * cap if cap else 1.0)).to(bf)
        k, v = (torch.randn(b, hkv, s_len, d, generator=gen, device=device).to(bf) for _ in range(2))
        with torch.inference_mode():
            out = fa.flash_attention(q, k, v, causal=True, window=window, logit_cap=cap)
            ref = fa.attention_reference(q.float(), k.float(), v.float(), causal=True, window=window, logit_cap=cap)
            cap_moves = cap_effect(cap, ref, lambda: fa.attention_reference(q.float(), k.float(), v.float(),
                                                                             causal=True, window=window),
                                   TOL, f"K2 {label}", tag)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        del ref
        if not math.isfinite(err) or err > TOL or not cap_moves:
            fail_later(f"K2 {label}: max abs error {err} > {TOL}, or the cap moves the output too little")
        ms = cuda_ms_cold(lambda: fa.flash_attention(q, k, v, causal=True, window=window, logit_cap=cap), 10, flush)
        plain_ms = cuda_ms_cold(lambda: fa.attention_reference(q, k, v, causal=True, window=window, logit_cap=cap),
                                2, flush)
        lib_ms = None
        if cap is None:  # SDPA with an explicit band mask computes the uncapped case
            qi = torch.arange(s_len, device=device)
            band = (qi[None, :] <= qi[:, None]) & (qi[None, :] > qi[:, None] - window)
            lib_ms = cuda_ms_cold(lambda: sdpa(q, k, v, attn_mask=band, enable_gqa=hkv != h), 10, flush)
            del band
        pairs = sum(min(i + 1, window) for i in range(s_len))  # visible (query, key) pairs per head
        n_bytes = 2 * (b * h * s_len * d + 2 * b * hkv * s_len * d)
        bound_ms, bound_by = bound(n_bytes, 4 * b * h * pairs * d, "bf16")
        lib_txt = "n/a (no PyTorch call computes the soft-cap)" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"K2 {label}: max abs error {err:.3e} (tol {TOL}); kernel {ms:.4f} ms "
            f"({4 * b * h * pairs * d / ms / 1e9:.1f} TFLOP/s on {pairs / 1e6:.2f} M visible pairs a head), plain "
            f"{plain_ms:.4f} ms, SDPA with a band mask (not a repo kernel) {lib_txt}, bound {bound_ms:.4f} ms "
            f"({bound_by}) {tag}")
        results[f"K2 {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by}
        del q, k, v, out
    # a padded batch row under window and cap: exactly 0
    q = (torch.randn(2, 16, 2048, 256, generator=gen, device=device) * (CAP_SPREAD * 50.0)).to(bf)
    k, v = (torch.randn(2, 8, 2048, 256, generator=gen, device=device).to(bf) for _ in range(2))
    mask = torch.arange(2048, device=device)[None, :] < torch.tensor([[1500], [0]], device=device)
    out = fa.flash_attention(q, k, v, kv_mask=mask, causal=True, window=512, logit_cap=50.0)
    ref = fa.attention_reference(q.float(), k.float(), v.float(), mask, True, None, 512, 50.0)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    if err > TOL or not bool((out[1] == 0).all()):
        fail_later(f"K2 masked b2: error {err}, padded row exactly 0: {bool((out[1] == 0).all())}")
    log(f"K2 b2 h16/kv8 S2048 d256 w512 cap50 with a padded row: max abs error {err:.3e}, padded row exactly 0 {tag}")

    # K3 + cap at Gemma-2's decode shapes, a window of 4096 folded into the
    # mask; and Phi-3-mini's head dim (h32, d96, no cap, its 2047 window)
    for label, b, h, hkv, d, m, cap, window, dt in (
        ("b8 h16/kv8 D256 M4096 cap50 bf16", 8, 16, 8, 256, 4096, 50.0, 4096, bf),
        ("b8 h16/kv8 D256 M8192 cap50 bf16", 8, 16, 8, 256, 8192, 50.0, 4096, bf),
        ("b8 h16/kv8 D256 M8192 cap50 f32", 8, 16, 8, 256, 8192, 50.0, 4096, torch.float32),
        ("b8 h32/kv32 D96 M4096 bf16", 8, 32, 32, 96, 4096, None, 2047, bf),
    ):
        q = (torch.randn(b, h, 1, d, generator=gen, device=device) * (CAP_SPREAD * cap if cap else 1.0)).to(dt)
        k, v = (torch.randn(b, hkv, m, d, generator=gen, device=device).to(dt) for _ in range(2))
        lengths = torch.randint(m // 2, m + 1, (b,), generator=gen, device=device)
        slots = torch.arange(m, device=device)[None, :]
        mask = (slots < lengths[:, None]) & (slots > lengths[:, None] - 1 - window)
        with torch.inference_mode():
            out = fa.flash_decode(q, k, v, kv_mask=mask, logit_cap=cap)
            ref = fa.flash_decode_reference(q.float(), k.float(), v.float(), kv_mask=mask, logit_cap=cap)
            tol = (1e-4 if dt == torch.float32 else 1e-2) * ref.abs().max().item()
            cap_moves = cap_effect(cap, ref, lambda: fa.flash_decode_reference(q.float(), k.float(), v.float(),
                                                                               kv_mask=mask),
                                   tol, f"K3 {label}", tag)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        if not math.isfinite(err) or err > tol or not cap_moves:
            fail_later(f"K3 {label}: max abs error {err} > {tol}, or the cap moves the output too little")
        ms = cuda_ms_cold(lambda: fa.flash_decode(q, k, v, kv_mask=mask, logit_cap=cap), 20, flush)
        plain_ms = cuda_ms_cold(lambda: fa.flash_decode_reference(q, k, v, kv_mask=mask, logit_cap=cap), 5, flush)
        lib_ms = None
        if cap is None:
            lib_ms = cuda_ms_cold(lambda: sdpa(q, k, v, attn_mask=mask[:, None, None, :], enable_gqa=hkv != h), 20,
                                  flush)
        valid = int(mask.sum().item())
        elt = torch.finfo(dt).bits // 8
        n_bytes = 2 * valid * hkv * d * elt + 2 * b * h * d * elt + b * m
        bound_ms, bound_by = bound(n_bytes, 4 * valid * h * d, "f32" if dt == torch.float32 else "bf16")
        lib_txt = ("no PyTorch call computes the soft-cap" if lib_ms is None
                   else f"SDPA (not a repo kernel) {lib_ms:.4f} ms")
        log(f"K3 {label}: max abs error {err:.3e} (tol {tol:.1e}); kernel {ms:.4f} ms "
            f"({n_bytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, {lib_txt}, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB of valid K/V) {tag}")
        results[f"K3cap {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                     "bound_ms": bound_ms, "bound_by": bound_by}
        del q, k, v

    # K8 at Llama-3.1-8B's shapes (b8 decode, m 2048 prefill), f32 out
    for wname, kk, n in (("q_w", 4096, 4096), ("k_w", 4096, 1024), ("gate_w", 4096, 14336),
                         ("down_w", 14336, 4096), ("lm_head", 4096, 128256)):
        qw = qm.quantize_weight_int4(0.02 * torch.randn(kk, n, generator=gen, device=device))
        wbf = (0.02 * torch.randn(kk, n, generator=gen, device=device)).to(bf)
        for m in ((8, 2048) if wname in ("q_w", "gate_w") else (8,)):
            x = torch.randn(m, kk, generator=gen, device=device)
            with torch.inference_mode():
                y = qm.int4_decode_matmul(x, qw, out_dtype=torch.float32)
                y_ref = qm.int4_matmul_reference(x, qw.packed, qw.scale, torch.float32)
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            tol = 1e-5 * y_ref.abs().max().item()
            if not math.isfinite(err) or err > tol:
                fail_later(f"K8 {wname} m{m}: max abs error {err} > {tol}")
            ms = cuda_ms_cold(lambda: qm.int4_decode_matmul(x, qw, out_dtype=torch.float32), 20, flush)
            plain_ms = cuda_ms_cold(lambda: qm.int4_matmul_reference(x, qw.packed, qw.scale, torch.float32), 2, flush)
            xb = x.to(bf)
            mm_ms = cuda_ms_cold(lambda: torch.matmul(xb, wbf), 20, flush)
            n_bytes = qw.packed.numel() + qw.scale.numel() * 4 + m * kk * 4 + m * n * 4
            bound_ms, bound_by = bound(n_bytes, 2 * m * kk * n, "int8")
            log(f"K8 {wname} {kk}x{n} m{m}: max abs error {err:.3e} ({err / y_ref.abs().max().item():.1e} of max |y|,"
                f" tol 1e-5); kernel {ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s, row quantisation pre-pass "
                f"included), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); torch.matmul of a bf16 "
                f"weight of the same shape (context, not the same function) {mm_ms:.4f} ms {tag}")
            results[f"K8 {wname} {kk}x{n} m{m}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                                    "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                                                    "bf16_matmul_ms": mm_ms}
        del qw, wbf

    # K13 over a decode step's worth of int4 buffers (Llama-3.1-8B's shapes)
    shapes = [(2048, 4096), (2048, 1024), (2048, 1024), (2048, 4096), (2048, 14336), (2048, 14336), (7168, 4096)]
    bufs = [torch.randint(0, 256, shp, generator=gen, device=device, dtype=torch.uint8)
            for _ in range(32) for shp in shapes] + [torch.randint(0, 256, (2048, 128256), generator=gen,
                                                                   device=device, dtype=torch.uint8)]
    floor = stream_floor(bufs, reps=10)
    want = stream_probe_reference(bufs)
    if floor["checksum"] != want:
        fail_later(f"K13: byte sum {floor['checksum']} != plain {want}")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        sum(b.sum(dtype=torch.int64) for b in bufs)
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1) / 3
    bound_ms, bound_by = bound(floor["bytes"], floor["bytes"], "int8")
    log(f"K13 over {len(bufs)} int4 buffers ({floor['bytes'] / 1e9:.3f} GB): byte sum equals the plain version's; "
        f"kernel {floor['ms']:.4f} ms ({floor['gb_per_s']:.1f} GB/s, {100 * floor['gb_per_s'] / 3350:.1f} % of "
        f"3.35 TB/s), plain torch reduction {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) {tag}")
    results["K13 int4 decode buffers"] = {"max_abs_err": 0.0, "ms": floor["ms"], "plain_ms": plain_ms,
                                          "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    del bufs
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phases 16-18 (slice 5: encoder extras)
ENC_DOCS = 4096         # x 240 words, chunked at 48 words: 20,480 short passages (~51 tokens of 256)
ENC_COS_PACKED = 0.999  # packed against bucketed rows (the JAX limit, tests/test_models.py:283)
ENC_COS_INT8 = 0.995    # int8 FFN against float (the JAX limit, tests/test_quant_matmul.py:143)
K10_TOL = 1e-4          # of max |y| with f32 out; one ulp of the 16-bit type otherwise
# phase 18's shapes: K2s (label, B, H, S, D, mean segment length): packed
# passages at passage_maxlength 256 and packed queries at question_maxlength
# 512; K10 (label, m, K, N, dtype): BERT-base's FFN tail at 2048 x 256 rows
K2S_CASES = [("passages b64 h12 S256 d64 seg40", 64, 12, 256, 64, 40),
             ("queries b16 h12 S512 d64 seg96", 16, 12, 512, 64, 96),
             ("packed batch b2048 h12 S256 d64 seg40", 2048, 12, 256, 64, 40)]
K2S_BATCH = K2S_CASES[2][0]  # the encoder's packed batch: timed beside K1 too
RATE_PASSAGES = 65536   # phase 16's passages/s: ~5 packed batches of 2048 rows at 40 tokens, 32 bucketed
K10_CASES = [("m524288 3072->768 bf16", 2048 * 256, 3072, 768, torch.bfloat16),
             ("m65536 3072->768 f32", 65536, 3072, 768, torch.float32)]


def gtr_t5_base():
    """sentence-transformers/gtr-t5-base: its T5 encoder's config.json
    (published widths) and its 768 -> 768 Dense module."""
    from retrieval_scaling_tpu_torch.models.hf_convert import t5_config_from_hf

    return t5_config_from_hf({
        "model_type": "t5", "vocab_size": 32128, "d_model": 768, "d_kv": 64, "d_ff": 3072, "num_layers": 12,
        "num_heads": 12, "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
        "layer_norm_epsilon": 1e-6, "feed_forward_proj": "relu",
    }, projection_dim=768)


def qwen3_embedding_06b():
    """Qwen/Qwen3-Embedding-0.6B's config.json, as its model card publishes it."""
    from retrieval_scaling_tpu_torch.models.hf_convert import llama_config_from_hf

    return llama_config_from_hf({
        "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "vocab_size": 151669, "hidden_size": 1024,
        "num_hidden_layers": 28, "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 128,
        "intermediate_size": 3072, "max_position_embeddings": 32768, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
        "rope_scaling": None, "attention_bias": False, "hidden_act": "silu", "tie_word_embeddings": True,
        "sliding_window": None, "use_sliding_window": False,
    })


def encoder_counters():
    """{name: wrapper or plain version} of the encoder path's kernels."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    return {"K1": fa.flash_attention, "K9": qm.int8_matmul, "K10": qm.int8_matmul_residual_ln,
            "plain attention": fa.attention_reference, "plain K9": qm.int8_matmul_reference,
            "plain K10": qm.int8_res_ln_reference}


class count_encoder_path:
    """Sets the encoder kernels' counts to 0 on entry and counts the
    encoder forwards of the run (all, packed, int8; llama forwards): on exit
    ``launches`` holds K1 / K2s / K9 / K10 and the plain versions' CUDA calls."""

    def __enter__(self):
        from retrieval_scaling_tpu_torch.models import bert, llama

        self.bert, self.llama = bert, llama
        self.orig_bert, self.orig_llama = bert.BertModel.forward, llama.llama_forward
        self.forwards = {"bert": 0, "packed": 0, "int8": 0, "llama": 0}
        fw, orig_bert, orig_llama = self.forwards, self.orig_bert, self.orig_llama

        def bert_forward(model, input_ids, attention_mask, position_ids=None, segment_ids=None):
            fw["bert"] += 1
            fw["packed"] += segment_ids is not None
            fw["int8"] += isinstance(model.layers[0].mlp_in, bert.Int8Linear)
            return orig_bert(model, input_ids, attention_mask, position_ids, segment_ids)

        def llama_forward(*args, **kw):
            fw["llama"] += 1
            return orig_llama(*args, **kw)

        bert.BertModel.forward, llama.llama_forward = bert_forward, llama_forward
        for fn in encoder_counters().values():
            for attr in ("launches", "segment_launches", "cuda_calls"):
                if hasattr(fn, attr):
                    setattr(fn, attr, 0)
        return self

    def __exit__(self, *exc):
        self.bert.BertModel.forward, self.llama.llama_forward = self.orig_bert, self.orig_llama
        c = encoder_counters()
        self.launches = {"K1": c["K1"].launches, "K2s": c["K1"].segment_launches, "K9": c["K9"].launches,
                         "K10": c["K10"].launches}
        self.plain = {k: v.cuda_calls for k, v in c.items() if k.startswith("plain")}
        return False


def check_flat_search(cfg, device, label: str, tag: str):
    """The CLI's ctxs equal a fresh search of its Flat index, and its top-k
    ids a float64 scan of the written embeddings apart from ties; returns
    the written passage and query embeddings."""
    from retrieval_scaling_tpu_torch.index.base import get_index_dir_and_embedding_paths
    from retrieval_scaling_tpu_torch.index.flat import FlatIndex
    from retrieval_scaling_tpu_torch.search.driver import get_search_output_path, read_jsonl

    with open(os.path.join(cfg.datastore.embedding.embedding_dir, "passages_00.pkl"), "rb") as f:
        _, emb = pickle.load(f)
    index_dir, _ = get_index_dir_and_embedding_paths(cfg, [0])
    index = FlatIndex(device, index_path=os.path.join(index_dir, "index_Flat.tpu.npz"),
                      meta_file=os.path.join(index_dir, "index_Flat.tpu.ids.npy"))
    db64 = np.load(os.path.join(index_dir, "index_Flat.tpu.npz"))["embeddings"].astype(np.float64)
    with open(cfg.evaluation.search.query_embedding_save_path, "rb") as f:
        queries = pickle.load(f)
    queried = [ex for ex in read_jsonl(get_search_output_path(cfg, [0])) if ex.get("raw_query")]
    k = cfg.evaluation.search.n_docs
    _, ids = index.search_ids(queries, k)
    ctx_ids = np.asarray([[c["id"][1] for c in ex["ctxs"]] for ex in queried])
    bad = ids_agree(ids, queries.astype(np.float64), db64, k)
    finite = np.isfinite(emb.astype(np.float32)).all() and np.isfinite(queries.astype(np.float32)).all()
    if not queried or not np.array_equal(ctx_ids, ids[: len(queried)]) or bad or not finite:
        fail_later(f"{label}: {len(queried)} queries, ctxs equal a fresh search "
                   f"{np.array_equal(ctx_ids, ids[: len(queried)])}, {bad} differ from the float64 scan beyond ties, "
                   f"finite {finite}")
    log(f"{label}: {emb.shape[0]} passages, {len(queried)} queries; ctxs equal a fresh search, top-{k} ids equal "
        f"a float64 scan of the written embeddings apart from ties {tag}")
    return emb, queries


def encoding_argv(root: str, corpus: str, enc_dir: str, device, packed: bool, int8: bool) -> list:
    """The CLI on short passages (48 words, passage_maxlength 256) and
    96-token queries (question_maxlength 512): both under 0.3 x their
    maxlength, so that packing takes the packed route."""
    argv = pipeline_argv(root, corpus, enc_dir, enc_dir, device) + [
        "tasks.eval.inference=false", "datastore.chunk_size=48", "datastore.embedding.passage_maxlength=256",
        "evaluation.data.max_eval_data_seq_length=160", "evaluation.data.eval_stride=64",
        "evaluation.search.question_maxlength=512",
    ]
    if packed:
        argv += ["datastore.embedding.packing=true", "evaluation.search.packing=true"]
    if int8:
        argv += ["datastore.embedding.quantization=int8"]
    return argv


def _rows_cos(a, b) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float((np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())


def texts_of_length(n: int, mean_words: int, seed: int) -> list:
    rng = np.random.RandomState(seed)
    terms = np.asarray([f"{t}_term_{i}" for t in TOPICS for i in range(401)])  # one array, not one per text
    return [" ".join(rng.choice(terms, rng.randint(mean_words // 2, 3 * mean_words // 2 + 1))) for _ in range(n)]


def timed_encode(fn, texts: list, reps: int = 1) -> float:
    """Seconds of ``fn(texts)``, after a warm-up on the first 16,384 texts."""
    fn(texts[:16384])  # warm-up (and the kernels' first launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(texts)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def device_seconds(fn) -> tuple:
    """(device seconds, of them in flash_fwd_kernel: K1 / K2s) of one call
    of ``fn``, summed over torch.profiler's CUDA kernel events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e6,
            sum(e.self_device_time_total for e in events if "flash_fwd_kernel" in e.key) / 1e6)


def bucketed_slots(lengths: list, batch: int, maxlength: int) -> int:
    """Token positions the bucketed route computes for these lengths: sorted,
    in batches of ``batch`` rows, each padded to its power-of-two bucket."""
    from retrieval_scaling_tpu_torch.search.encoder import _length_buckets

    buckets, srt = _length_buckets(maxlength), np.sort(lengths)
    return sum(batch * next(b for b in buckets if b >= min(int(srt[i: i + batch].max()), maxlength))
               for i in range(0, len(srt), batch))


@torch.inference_mode()
def ffn_ms(layer, x, int8: bool) -> float:
    """Device ms of one BERT FFN tail (mlp_in, gelu, mlp_out, residual,
    LayerNorm) on x, float or int8 (K9 then K10)."""
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    if int8:
        def fn():
            h = qm.int8_matmul(x, layer.mlp_in.weight, layer.mlp_in.bias, activation="gelu_tanh", out_dtype=x.dtype)
            return qm.int8_matmul_residual_ln(h, x, layer.mlp_out.weight, layer.mlp_out.bias, layer.mlp_ln.weight,
                                              layer.mlp_ln.bias, eps=layer.cfg.layer_norm_eps)
    else:
        def fn():
            h = torch.nn.functional.gelu(layer.mlp_in(x), approximate="tanh")
            return layer.mlp_ln(x + layer.mlp_out(h))
    return cuda_ms(fn, iters=10)


def run_encoding(run: dict, device, seed: int, tag: str) -> dict:
    """Phase 16: the CLI's embed -> Flat index -> search at BERT-base width,
    bucketed, packed, int8 and packed + int8; then the encoder's passages/s
    bucketed against packed and with the bf16 against the int8 FFN."""
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.pipeline import main as pipeline_main
    from retrieval_scaling_tpu_torch.search.encoder import EncodeOptions, load_encoder, pack_token_rows

    root = os.path.join(os.path.dirname(run["corpus"]), "encoding")
    os.makedirs(root, exist_ok=True)
    corpus = os.path.join(root, "corpus.jsonl")
    write_corpus(corpus, ENC_DOCS, 240, seed + 16)
    with open(os.path.join(run["enc_dir"], "config.json")) as f:
        layers = json.load(f)["num_hidden_layers"]
    out, launches = {}, {}
    for name, packed, int8 in (("bucketed", False, False), ("packed", True, False), ("int8", False, True),
                               ("packed + int8", True, True)):
        argv = encoding_argv(os.path.join(root, name.replace(" + ", "_")), corpus, run["enc_dir"], device, packed,
                             int8)
        with count_encoder_path() as counts:
            result = pipeline_main.main(argv)
            sync(device)
        fw, n = counts.forwards, counts.launches
        want = {"K1": layers * fw["bert"], "K2s": layers * fw["packed"], "K9": layers * fw["int8"],
                "K10": layers * fw["int8"]}
        ok = n == want and not any(counts.plain.values()) and (fw["packed"] > 1) == packed and (fw["int8"] > 0) == int8
        if not ok:
            fail_later(f"encoding {name}: launches {n} (want {want} from {fw} forwards), plain on CUDA {counts.plain}")
        cfg = load_config("example_config", overrides=argv[4:])
        out[name] = check_flat_search(cfg, device, f"encoding {name}", tag)
        launches[name] = n
        log(f"encoding {name}: {fw['bert']} encoder forwards ({fw['packed']} packed, {fw['int8']} int8); launches "
            f"{n}; plain versions on CUDA {counts.plain}; " + ", ".join(
                f"{k} {v:.3f} s" for k, v in result["stage_seconds"].items()) + f" {tag}")
    cos = {}
    for name, ref, limit in (("packed", "bucketed", ENC_COS_PACKED), ("int8", "bucketed", ENC_COS_INT8),
                             ("packed + int8", "int8", ENC_COS_PACKED)):
        cos[name] = (_rows_cos(out[name][0], out[ref][0]), _rows_cos(out[name][1], out[ref][1]))
        log(f"encoding {name} against {ref}: min row cosine passages {cos[name][0]:.6f}, queries "
            f"{cos[name][1]:.6f} (limit {limit}; int8 queries are float, as in the JAX CLI) {tag}")
    if min(cos["packed"]) <= ENC_COS_PACKED or min(cos["packed + int8"]) <= ENC_COS_PACKED:
        fail_later(f"packed against bucketed: {cos['packed']}, {cos['packed + int8']} (limit {ENC_COS_PACKED})")

    encoder = load_encoder(run["enc_dir"], device)
    if cos["int8"][0] <= ENC_COS_INT8:
        # random weights at 12 layers may amplify the rounding: hold the first 2
        from retrieval_scaling_tpu_torch.search.encoder import TorchEncoder

        texts = texts_of_length(2048, 48, seed + 17)
        cut = dataclasses.replace(encoder.cfg, num_layers=2)
        two = type(encoder.model)(cut, device=device, dtype=torch.bfloat16)
        two.load_state_dict(encoder.model.state_dict(), strict=False)
        pair = [TorchEncoder(two, encoder.tokenizer, device, quantize=q).encode(texts, EncodeOptions(256, 256))
                for q in ("none", "int8")]
        first2 = _rows_cos(pair[1], pair[0])
        log(f"int8 against float at 12 layers {cos['int8'][0]:.6f} <= {ENC_COS_INT8}: the first 2 layers "
            f"{first2:.6f} {tag}")
        if first2 <= ENC_COS_INT8:
            fail_later(f"int8 against float: first 2 layers {first2} <= {ENC_COS_INT8}")

    # passages/s, bucketed against packed, at two mean lengths out of 256
    rates = {}
    for mean_words in (40, 96):
        texts = texts_of_length(RATE_PASSAGES, mean_words, seed + mean_words)
        opts = EncodeOptions(batch_size=2048, maxlength=256)
        popts = EncodeOptions(batch_size=2048, maxlength=256, packed=True)

        def packed_route(some):  # the packed route whatever the mean length (the 0.3 rule is not applied)
            enc = encoder.tokenizer(some, max_length=256, truncation=True, padding=False)["input_ids"]
            return encoder._encode_packed(enc, popts, encoder.cfg.hidden_size, False)

        t0 = time.perf_counter()
        enc = encoder.tokenizer(texts, max_length=256, truncation=True, padding=False)["input_ids"]
        t1 = time.perf_counter()
        rows = pack_token_rows(enc, 256, 0)[0].shape[0]  # the packed route's rows, the last batch unpadded
        host = {"tokenize": t1 - t0, "pack": time.perf_counter() - t1}  # host parts of the two routes
        lengths = [len(t) for t in enc]
        slots = {"bucketed": bucketed_slots(lengths, 2048, 256), "packed": rows * 256, "packed rows": rows}
        bucket_s = timed_encode(lambda some: encoder.encode(some, opts), texts)
        packed_s = timed_encode(packed_route, texts)
        dev = {"bucketed": device_seconds(lambda: encoder.encode(texts, opts)),
               "packed": device_seconds(lambda: packed_route(texts))}
        rates[mean_words] = {"bucketed": len(texts) / bucket_s, "packed": len(texts) / packed_s,
                             "mean_tokens": float(np.mean(lengths)), "slots": slots, "host": host, "device": dev}
        log(f"encoder at mean {np.mean(lengths):.1f} tokens of 256 ({len(texts)} passages, batch 2048, host "
            f"tokenization included): bucketed {len(texts) / bucket_s:.1f} passages/s, packed "
            f"{len(texts) / packed_s:.1f} passages/s ({bucket_s / packed_s:.3f}x); device time (torch.profiler): "
            f"bucketed {dev['bucketed'][0]:.4f} s (K1 {dev['bucketed'][1]:.4f} s; busy "
            f"{100 * dev['bucketed'][0] / bucket_s:.1f} %), packed {dev['packed'][0]:.4f} s (K2s "
            f"{dev['packed'][1]:.4f} s; busy {100 * dev['packed'][0] / packed_s:.1f} %), "
            f"{dev['bucketed'][0] / dev['packed'][0]:.3f}x on the device; token slots computed: bucketed "
            f"{slots['bucketed']}, packed {slots['packed']} ({slots['packed rows']} rows), real tokens "
            f"{sum(lengths)}; host: tokenization {host['tokenize']:.3f} s, pack_token_rows {host['pack']:.3f} s "
            f"{tag}")

    # passages/s with the bf16 against the int8 FFN at 2048 x 256 (full-length passages)
    texts = texts_of_length(8192, 300, seed + 300)
    opts = EncodeOptions(batch_size=2048, maxlength=256)
    qencoder = load_encoder(run["enc_dir"], device, quantize="int8")
    float_s = timed_encode(lambda some: encoder.encode(some, opts), texts, reps=2)
    int8_s = timed_encode(lambda some: qencoder.encode(some, opts), texts, reps=2)
    x = torch.randn(2048, 256, encoder.cfg.hidden_size, generator=torch.Generator(device=device).manual_seed(seed),
                    device=device).to(torch.bfloat16)
    ffn = (ffn_ms(encoder.model.layers[0], x, False), ffn_ms(qencoder.model.layers[0], x, True))
    log(f"encoder at 2048 x 256: bf16 FFN {len(texts) / float_s:.1f} passages/s, int8 FFN "
        f"{len(texts) / int8_s:.1f} passages/s ({float_s / int8_s:.3f}x); one layer's FFN tail on [2048, 256, d] "
        f"bf16: bf16 (cuBLAS + torch) {ffn[0]:.4f} ms, int8 (K9 + K10) {ffn[1]:.4f} ms ({ffn[0] / ffn[1]:.3f}x) {tag}")
    del encoder, qencoder, x
    torch.cuda.empty_cache()
    return {"launches": launches, "cos": cos, "rates": rates, "int8_rate": (len(texts) / float_s, len(texts) / int8_s),
            "ffn_ms": ffn, "corpus": corpus}


def run_other_encoders(run: dict, device, seed: int, tag: str) -> dict:
    """Phase 17: GTR-T5-base and Qwen3-Embedding-0.6B (published widths,
    random bf16 weights) from local checkpoint directories through the CLI's
    embed -> Flat index -> search, which dispatches on their config.json."""
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.models.hf_convert import save_hf_checkpoint
    from retrieval_scaling_tpu_torch.models.llama import init_llama_params
    from retrieval_scaling_tpu_torch.models.t5 import init_t5_encoder_params
    from retrieval_scaling_tpu_torch.pipeline import main as pipeline_main
    from retrieval_scaling_tpu_torch.search.encoder import EncodeOptions, load_encoder

    root = os.path.join(os.path.dirname(run["corpus"]), "other_encoders")
    os.makedirs(root, exist_ok=True)
    corpus = os.path.join(root, "corpus.jsonl")
    write_corpus(corpus, 1024, 240, seed + 17)
    tok = make_tokenizer([f"{t}_term_{i}" for t in TOPICS for i in range(401)] + ["."])
    gen = torch.Generator(device=device).manual_seed(seed + 17)
    found = {}
    for name, cfg, make in (("gtr-t5-base", gtr_t5_base(), init_t5_encoder_params),
                            ("qwen3-embedding-0.6b", qwen3_embedding_06b(), init_llama_params)):
        path = os.path.join(root, f"{name}-random")
        t0 = time.perf_counter()
        model = make(cfg, gen, device=device, dtype=torch.bfloat16)
        if cfg.vocab_size < tok.vocab_size:
            raise AssertionError(f"tokenizer vocab {tok.vocab_size} > {name} vocab {cfg.vocab_size}")
        save_hf_checkpoint(model, path)
        tok.save_pretrained(path)
        del model
        torch.cuda.empty_cache()
        log(f"{name}: random checkpoint written in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(os.path.join(path, 'pytorch_model.bin')) / 1e9:.2f} GB, bf16)")
        argv = encoding_argv(os.path.join(root, name), corpus, path, device, False, False)
        argv += ["datastore.embedding.per_device_batch_size=512"]
        with count_encoder_path() as counts:
            result = pipeline_main.main(argv)
            sync(device)
        layers = cfg.num_layers
        want_k1 = layers * counts.forwards["llama"]
        if counts.launches["K1"] != want_k1 or any(counts.plain.values()):
            fail_later(f"{name}: K1 launches {counts.launches['K1']} (want {want_k1}), plain on CUDA {counts.plain}")
        emb, _ = check_flat_search(load_config("example_config", overrides=argv[4:]), device, name, tag)
        norms = np.linalg.norm(emb.astype(np.float32), axis=1)
        encoder = load_encoder(path, device)
        direct = encoder.encode(texts_of_length(64, 40, seed), EncodeOptions(batch_size=64, maxlength=256,
                                                                              normalize_emb=True))
        unit = np.linalg.norm(direct.astype(np.float32), axis=1)
        if np.abs(unit - 1).max() > 1e-2 or (name.startswith("gtr") and np.abs(norms - 1).max() > 1e-2):
            fail_later(f"{name}: norms of the CLI's rows {norms.min()}..{norms.max()}, normalized encode "
                       f"{unit.min()}..{unit.max()}")
        log(f"{name}: {counts.forwards['llama']} llama forwards, K1 launches {counts.launches['K1']} "
            f"(= {layers} x forwards), plain on CUDA {counts.plain}; row norms of the CLI's embeddings "
            f"{norms.min():.4f}..{norms.max():.4f} (GTR normalizes; the llama family only when asked), "
            f"normalize_emb encode {unit.min():.4f}..{unit.max():.4f}; query prefix {encoder.query_prefix!r}; "
            + ", ".join(f"{k} {v:.3f} s" for k, v in result["stage_seconds"].items()) + f" {tag}")
        found[name] = {"K1": counts.launches["K1"], "passages": emb.shape[0]}
        del encoder
        torch.cuda.empty_cache()
    return found


def _packed_segments_cuda(b: int, s_len: int, mean_len: int, gen) -> torch.Tensor:
    """Rows packed like pack_token_rows leaves them: segments of lengths
    around ``mean_len`` with no alignment, a pad tail, and an all-pad row."""
    seg = torch.zeros(b, s_len, dtype=torch.int32)
    lens = torch.randint(mean_len // 2, 3 * mean_len // 2 + 1, (b, s_len), generator=gen)
    for r in range(b - 1):
        pos, sid = 0, 1
        for ln in lens[r].tolist():
            if pos + ln > s_len:
                break
            seg[r, pos: pos + ln] = sid
            pos, sid = pos + ln, sid + 1
    return seg


def check_slice5_kernels(device, seed: int, tag: str) -> dict:
    """Phase 18: K2s and K10 against their plain versions at the path's
    shapes, timed against their bounds and yardsticks."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    cpu_gen = torch.Generator().manual_seed(seed + 18)
    gen = torch.Generator(device=device).manual_seed(seed + 18)
    for label, b, h, s_len, d, mean_len in K2S_CASES:
        seg = _packed_segments_cuda(b, s_len, mean_len, cpu_gen).to(device)
        q, k, v = (torch.randn(b, h, s_len, d, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
        mask = seg > 0
        with torch.inference_mode():
            out = fa.flash_attention(q, k, v, kv_mask=mask, segment_ids=seg)
            ref = fa.attention_reference(q.float(), k.float(), v.float(), kv_mask=mask, segment_ids=seg)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        pad_zero = bool((out.transpose(1, 2)[~mask] == 0).all())
        if not math.isfinite(err) or err > TOL or not pad_zero:
            fail_later(f"K2s {label}: max abs error {err} > {TOL}, or pad rows not exactly 0 ({pad_zero})")
        ms = cuda_ms_cold(lambda: fa.flash_attention(q, k, v, kv_mask=mask, segment_ids=seg), 20, flush)
        plain_ms = cuda_ms_cold(lambda: fa.attention_reference(q, k, v, kv_mask=mask, segment_ids=seg), 3, flush)
        # SDPA's yardstick: a boolean block-diagonal mask over the non-pad rows
        # (pad rows see themselves, so that no row of SDPA is empty)
        same = (seg[:, :, None] == seg[:, None, :]) & mask[:, :, None]
        block = (same | torch.eye(s_len, dtype=torch.bool, device=device))[:, None]
        lib_ms = cuda_ms_cold(lambda: sdpa(q, k, v, attn_mask=block), 20, flush)
        # visible (query, key) pairs of this data, per head: the squared segment lengths
        pairs = float(sum((torch.unique_consecutive(row[row > 0], return_counts=True)[1].double() ** 2).sum()
                          for row in seg))
        n_bytes = 4 * b * h * s_len * d * 2 + 3 * b * s_len * 4
        bound_ms, bound_by = bound(n_bytes, 4 * h * pairs * d, "bf16")
        log(f"K2s {label}: max abs error {err:.3e} (tol {TOL}), pad rows exactly 0 {pad_zero}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, SDPA with a block-diagonal mask (not a repo kernel) {lib_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {pairs / b:.0f} visible pairs a row of the batch) {tag}")
        results[f"K2s {label}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                   "bound_ms": bound_ms, "bound_by": bound_by}
        del out, ref, same, block
        if label == K2S_BATCH:
            # K1 beside it: the same shape with the key mask alone, and the
            # bucketed batch of passages of the same lengths ([b, 64] columns)
            passages = int(seg.amax(dim=1).sum())
            bounds_ms = cuda_ms_cold(lambda: fa.segment_bounds(seg), 20, flush)  # the wrapper's plain-torch part
            k1_same = cuda_ms_cold(lambda: fa.flash_attention(q, k, v, kv_mask=mask), 20, flush)
            lens = torch.randint(mean_len // 2, 3 * mean_len // 2 + 1, (b, 1), generator=gen, device=device)
            bucket = 1 << (3 * mean_len // 2).bit_length()
            qb, kb, vb = (torch.randn(b, h, bucket, d, generator=gen, device=device).to(torch.bfloat16)
                          for _ in range(3))
            bmask = torch.arange(bucket, device=device)[None] < lens
            k1_bucket = cuda_ms_cold(lambda: fa.flash_attention(qb, kb, vb, kv_mask=bmask), 20, flush)
            results[f"K2s {label}"]["beside K1"] = {"passages": passages, "k1_same_ms": k1_same,
                                                    "k1_bucket_ms": k1_bucket, "bucket": bucket,
                                                    "segment_bounds_ms": bounds_ms}
            log(f"K2s beside K1 at b{b} h{h} d{d}: K2s S{s_len} {ms:.4f} ms for {passages} packed passages "
                f"({1e3 * ms / b:.3f} us a row, {1e3 * ms / passages:.4f} us a passage; of it segment_bounds "
                f"{bounds_ms:.4f} ms); K1 at the same shape with "
                f"the key mask alone {k1_same:.4f} ms ({1e3 * k1_same / b:.3f} us a row); K1 on the bucketed batch "
                f"S{bucket} of {b} passages of {mean_len // 2}-{3 * mean_len // 2} tokens {k1_bucket:.4f} ms "
                f"({1e3 * k1_bucket / b:.4f} us a passage) {tag}")
            del qb, kb, vb, bmask
        del q, k, v
    # K10: the int8 FFN tail at BERT-base, h [2048 x 256, 3072] -> [., 768]
    for label, m, k_in, n_out, dt in K10_CASES:
        qw = qm.res_ln_layout(qm.quantize_weight(0.02 * torch.randn(k_in, n_out, generator=gen, device=device)))
        vecs = [torch.randn(n_out, generator=gen, device=device) for _ in range(3)]
        hid = torch.randn(m, k_in, generator=gen, device=device).to(dt)
        x = torch.randn(m, n_out, generator=gen, device=device).to(dt)
        with torch.inference_mode():
            out = qm.int8_matmul_residual_ln(hid, x, qw, *vecs, eps=1e-12)
            ref = qm.int8_res_ln_reference(hid, x.float(), qw.wq, qw.scale, *vecs, 1e-12)
        torch.cuda.synchronize()
        top = ref.abs().max().item()
        err = (out.float() - ref).abs()
        if dt == torch.float32:
            worst = err.max().item() / top
            ok = worst <= K10_TOL
            err_txt = f"{worst:.3e} of max |y| (tol {K10_TOL})"
        else:
            # one ulp of the 16-bit type, or 1e-5 of max |y| where + beta cancels
            worst = (err / (torch.finfo(dt).eps * ref.abs() + 1e-5 * top)).max().item()
            ok = worst <= 1.0
            err_txt = f"{worst:.3f} of one {dt} ulp (tol 1)"
        if not ok:
            fail_later(f"K10 {label}: {err_txt}")
        ms = cuda_ms_cold(lambda: qm.int8_matmul_residual_ln(hid, x, qw, *vecs, eps=1e-12), 10, flush)
        plain_ms = cuda_ms_cold(lambda: qm.int8_res_ln_reference(hid, x, qw.wq, qw.scale, *vecs, 1e-12), 2, flush)
        esz = hid.element_size()
        n_bytes = m * k_in * esz + 2 * m * n_out * esz + k_in * n_out + 5 * n_out * 4
        bound_ms, bound_by = bound(n_bytes, 2 * m * k_in * n_out, "int8")
        log(f"K10 {label}: {err_txt}; kernel (row quantisation + K10) {ms:.4f} ms "
            f"({2 * m * k_in * n_out / ms / 1e9:.1f} TOP/s), plain {plain_ms:.4f} ms, no PyTorch call computes it, "
            f"bound {bound_ms:.4f} ms ({bound_by}) {tag}")
        results[f"K10 {label}"] = {"max_abs_err": float(err.max().item()), "ms": ms, "plain_ms": plain_ms,
                                   "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        del hid, x, out, ref, err
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 19 (slice 6: Flat scan, offline pipeline)
K11_TOL = 1e-5           # max |kernel - plain| / max |score|: f32 sums of exact bf16 products, another order
K11_CUT = 77             # n_valid = N - 77: the mask cuts the last segment
FUSED_K = 100            # the headline's top-100
SQ8_CLI_KEYS = ["datastore.index.quantization=int8", "datastore.index.approx_recall=0.95"]
SQ8_FAULT_FLOOR = 0.5    # recall@10 of SQ8 against bf16 below this is a fault, not quantization


def scan64_top(q64: torch.Tensor, db: torch.Tensor, n_valid: int, k: int, chunk: int = 1 << 17):
    """(scores, ids) [B, k] of a float64 scan of the first n_valid rows."""
    scores = torch.cat([q64 @ db[base : min(base + chunk, n_valid)].double().t()
                        for base in range(0, n_valid, chunk)], dim=1)
    s, i = torch.topk(scores, k, dim=-1)
    return s.cpu().numpy(), i.cpu().numpy()


def build_flat_datastore(ds: dict, device, tag: str, quantization=None):
    """Phase 7's shards as a Flat index through Indexer (index_Flat.tpu.npz
    written by the first call, read by the next)."""
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.index.base import Indexer

    ds_root = ds["ds_root"]
    overrides = [
        f"datastore.datastore_root_dir={ds_root}", "datastore.domain=synthetic", "evaluation.domain=none",
        "evaluation.data.eval_data=none.jsonl", f"evaluation.results_only_log_file={ds_root}/results.log",
        f"datastore.embedding.embedding_dir={ds_root}/embeddings",
        f"datastore.embedding.passages_dir={ds_root}/passages", "datastore.index.index_type=Flat",
        "datastore.index.index_shard_ids=[" + ",".join(str(i) for i in range(ds["shards"])) + "]",
    ]
    if quantization:
        overrides += [f"datastore.index.quantization={quantization}", "datastore.index.approx_recall=0.95"]
    t0 = time.perf_counter()
    index = Indexer(load_config("default", overrides=overrides), device,
                    index_shard_ids=list(range(ds["shards"]))).datastore
    sync(device)
    held = index.embeddings.nbytes + (0 if index.row_scales is None else index.row_scales.nbytes)
    log(f"build Flat {quantization or 'bf16'}: {time.perf_counter() - t0:.2f} s through Indexer, "
        f"{index.n_valid} rows, {held / 1e9:.3f} GB on the device {tag}")
    return index


def check_fused_scan(flat, queries: np.ndarray, device, tag: str) -> dict:
    """Phase 19, K11: the fused scan on the 1M x 768 bf16 Flat tensor, the
    path (flat_topk_fused at b1 and b64) counted, then held and timed."""
    from retrieval_scaling_tpu_torch.ops import fused_scan as fs
    from retrieval_scaling_tpu_torch.ops import ivf_gather as g
    from retrieval_scaling_tpu_torch.ops.matmul import matmul_f32
    from retrieval_scaling_tpu_torch.ops.topk import chunked_topk_scores, pick_chunk_size

    db = flat.embeddings
    n_pad, d = db.shape
    n_valid = n_pad - K11_CUT
    qs = {b: torch.from_numpy(queries[:b]).to(device) for b in (1, 64)}
    kernels, plain = {"K11": fs.segmax_scan, "K4": g.gather_score_tiles}, [fs.segmax_scan_reference,
                                                                          g.gather_score_tiles_reference]
    out = {}
    with torch.inference_mode():
        for fn in kernels.values():
            fn.launches = 0
        for fn in plain:
            fn.cuda_calls = 0
        fused = {b: fs.flat_topk_fused(q, db, n_valid, FUSED_K + 1) for b, q in qs.items()}
        sync(device)
        launches, plain_calls = {k: fn.launches for k, fn in kernels.items()}, sum(fn.cuda_calls for fn in plain)
        if plain_calls or min(launches.values()) == 0:
            fail_later(f"fused scan path: launches {launches}, plain calls on CUDA {plain_calls}")
        log(f"fused scan path (flat_topk_fused b1 + b64): launches {launches}, plain calls on CUDA {plain_calls}")
        out["launches"] = launches

        worst = 0.0
        for b, q in qs.items():
            got = fs.segmax_scan(q, db, n_valid)
            ref = fs.segmax_scan_reference(q.to(db.dtype), db, n_valid)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            worst = max(worst, err)
            if not math.isfinite(rel) or rel > K11_TOL:
                fail_later(f"K11 b{b}: max abs error {err} = {rel:.3e} of max |score| > {K11_TOL}")
            cut = n_valid - 5 * fs.SEG  # five whole segments masked, the sixth cut
            masked = fs.segmax_scan(q, db, cut)
            dead = masked[:, -(-cut // fs.SEG):]
            if dead.shape[1] != 5 or not bool((dead == fs.NEG_INF).all()) or not bool((masked[:, -6] > -1e29).all()):
                fail_later(f"K11 b{b}: masked segments are not exactly NEG_INF")
            log(f"K11 b{b}: max abs error {err:.3e} ({rel:.2e} of max |score|, tol {K11_TOL}); masked segments "
                f"exactly NEG_INF")

            s_f, i_f = (t.cpu().numpy() for t in fused[b])
            q64 = q.to(db.dtype).double()
            s_64, i_64 = scan64_top(q64, db, n_valid, FUSED_K + 1)
            tol = K11_TOL * np.abs(s_64).max()
            bad = top_ids_apart_from_ties(s_f, i_f, s_64, i_64, FUSED_K, tol)
            s_all, i_all = fs.flat_topk_fused(q, db, flat.n_valid, FUSED_K + 1)
            s_idx, i_idx = flat.search_ids(queries[:b], FUSED_K + 1)
            bad_idx = top_ids_apart_from_ties(s_all.cpu().numpy(), i_all.cpu().numpy(), s_idx, i_idx, FUSED_K, tol)
            if bad or bad_idx:
                fail_later(f"flat_topk_fused b{b}: top-{FUSED_K} differs beyond ties in {bad} rows from the float64 "
                           f"scan and in {bad_idx} from FlatIndex.search_ids")
            log(f"flat_topk_fused b{b}: top-{FUSED_K} ids equal the float64 scan of the bf16 rows (n_valid N - "
                f"{K11_CUT}) and FlatIndex.search_ids (all rows) apart from ties")
        out["max_abs_err"] = worst

        flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
        col = torch.arange(n_pad, device=device)
        for b, q in qs.items():
            qb = q.to(db.dtype)
            chunk = min(flat.search_chunk_size, pick_chunk_size(n_pad, b))

            def library():  # cuBLAS with f32 scores, the mask, reshape-amax
                s = matmul_f32(qb, db.t())
                return s.masked_fill_((col >= n_valid)[None, :], fs.NEG_INF).view(b, -1, fs.SEG).amax(-1)

            t = {
                "ms": cuda_ms_cold(lambda: fs.segmax_scan(q, db, n_valid), 20, flush),
                "fused_ms": cuda_ms_cold(lambda: fs.flat_topk_fused(q, db, n_valid, FUSED_K), 20, flush),
                "library_ms": cuda_ms_cold(library, 20, flush),
                "flat_route_ms": cuda_ms_cold(lambda: chunked_topk_scores(qb, db, n_valid, FUSED_K, chunk), 20,
                                              flush),
                "plain_ms": cuda_ms_cold(lambda: fs.segmax_scan_reference(qb, db, n_valid), 3, flush),
            }
            n_bytes = n_pad * d * 2 + b * d * 2 + b * (n_pad // fs.SEG) * 4
            t["bound_ms"], t["bound_by"] = bound(n_bytes, 2 * b * n_pad * d, "bf16")
            out[b] = t
            log(f"K11 b{b} {n_pad} x {d} bf16: kernel {t['ms']:.4f} ms ({n_pad * d * 2 / t['ms'] / 1e6:.1f} GB/s "
                f"of rows), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain {t['plain_ms']:.4f} ms, cuBLAS + "
                f"amax {t['library_ms']:.4f} ms; top-{FUSED_K}: flat_topk_fused (K11 + K4) {t['fused_ms']:.4f} ms, "
                f"chunked_topk_scores (cuBLAS + torch.topk, chunk {chunk}) {t['flat_route_ms']:.4f} ms {tag}")
    return out


def check_flat_sq8(flat, ds: dict, device, tag: str) -> dict:
    """Phase 19, SQ8 on the 1M rows: QPS at b64 and latency at b1 beside
    bf16 Flat, recall@10 against the exact bf16 scan."""
    sq8 = build_flat_datastore(ds, device, tag, quantization="int8")
    queries = ds["queries"]
    truth = flat.search_ids(queries, 10)[1]
    recall = recall_at_10(sq8.search_ids(queries, 10)[1], truth)
    out = {"recall": recall}
    for name, index in (("bf16", flat), ("SQ8", sq8)):
        b64 = timed_search(index, queries, 10)
        b1 = timed_search(index, queries[:1], 20)
        out[name] = (64 / b64, b1 * 1e3)
        log(f"search Flat {name} {index.n_valid} x 768: {64 / b64:.1f} QPS at b64 ({b64 * 1e3:.3f} ms/batch), "
            f"{b1 * 1e3:.3f} ms at b1 (host clock, query upload and result download included) {tag}")
    # a quality number of this synthetic spectrum, held only against a gross
    # fault (a wrong scale gives about 0); the exact check is the CLI run's
    log(f"recall@10 of Flat SQ8 (approx_recall 0.95, exact top-k) against the exact bf16 scan: {recall:.4f} {tag}")
    if recall < SQ8_FAULT_FLOOR:
        fail_later(f"Flat SQ8 recall@10 {recall} < {SQ8_FAULT_FLOOR}")
    del sq8
    torch.cuda.empty_cache()
    return out


def offline_argv(run: dict, device, name: str, *extra) -> list:
    root = os.path.dirname(run["corpus"])
    return pipeline_argv(root, run["corpus"], run["enc_dir"], run["reader_dir"], device) + [
        "evaluation.search.overwrite=true", "tasks.datastore.embedding=false",
        f"evaluation.eval_output_dir={root}/offline/{name}",
        f"evaluation.results_only_log_file={root}/offline/results_{name}.log", *extra,
    ]


def read_results(argv) -> tuple:
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.search.driver import get_search_output_path, read_jsonl

    cfg = load_config("example_config", overrides=argv[4:])
    path = get_search_output_path(cfg, [0])
    return cfg, path, read_jsonl(path)


def run_offline(run: dict, device, reader_vocab: int, tag: str) -> dict:
    """Phase 19, the CLI: SQ8 Flat + approx_recall on phase 4's embeddings,
    BM25, merge_search over both result files, then perplexity with
    decontamination, with continuation and as calibration."""
    from retrieval_scaling_tpu_torch.data.sharding import load_jsonl_shard
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops.topk import _sq8_queries
    from retrieval_scaling_tpu_torch.index.flat import quantize_rows_sq8
    from retrieval_scaling_tpu_torch.index.base import get_index_dir_and_embedding_paths
    from retrieval_scaling_tpu_torch.pipeline import main as pipeline_main
    from retrieval_scaling_tpu_torch.search.driver import read_jsonl

    root = os.path.dirname(run["corpus"])
    os.makedirs(os.path.join(root, "offline"), exist_ok=True)
    out = {}

    argv = offline_argv(run, device, "sq8", "tasks.eval.inference=false", *SQ8_CLI_KEYS)
    result = pipeline_main.main(argv)
    cfg, sq8_path, rows = read_results(argv)
    queried = [ex for ex in rows if ex.get("raw_query")]
    index_dir, _ = get_index_dir_and_embedding_paths(cfg, [0])
    emb = np.load(os.path.join(index_dir, "index_Flat.tpu.npz"))["embeddings"]
    rows_q, scales = quantize_rows_sq8(emb)
    db64 = rows_q.astype(np.float64) * scales.astype(np.float64)[:, None]
    with open(cfg.evaluation.search.query_embedding_save_path, "rb") as f:
        q_pipeline = pickle.load(f)
    qq, q_scale = _sq8_queries(torch.from_numpy(np.asarray(q_pipeline, np.float32)))
    q64 = qq.double().numpy() * q_scale.double().numpy()
    ids = np.asarray([[c["id"][1] for c in ex["ctxs"]] for ex in queried])
    bad = ids_agree(ids, q64[: len(queried)], db64, 3)
    if not queried or any(len(ex["ctxs"]) != 3 for ex in queried) or bad:
        fail_later(f"CLI Flat SQ8: {len(queried)} queries, ctxs of 3 each, {bad} differ from the float64 scan of "
                   "the dequantized rows beyond ties")
    log(f"CLI Flat SQ8 + approx_recall 0.95: {len(queried)} queries with 3 ctxs each, ids equal a float64 scan of "
        f"the dequantized rows and queries (ties aside); " + ", ".join(
            f"{k} {v:.3f} s" for k, v in result["stage_seconds"].items()) + f" {tag}")

    argv = offline_argv(run, device, "bm25", "tasks.eval.inference=false", "model.sparse_retriever=bm25")
    result = pipeline_main.main(argv)
    _, bm25_path, rows = read_results(argv)
    queried = [ex for ex in rows if ex.get("raw_query")]
    unsorted = [ex for ex in queried if [c["retrieval score"] for c in ex["ctxs"]] !=
                sorted((c["retrieval score"] for c in ex["ctxs"]), reverse=True)]
    if not queried or unsorted or not any(ex["ctxs"] for ex in queried):
        fail_later(f"CLI BM25: {len(queried)} queries, {len(unsorted)} with ctxs out of score order")
    out["bm25_seconds"] = result["stage_seconds"]
    log(f"CLI BM25: {len(queried)} queries, ctxs sorted by score, "
        f"{sum(len(ex['ctxs']) for ex in queried)} ctxs in all; index build {result['stage_seconds']['index']:.3f} s, "
        f"search {result['stage_seconds']['search']:.3f} s (host) {tag}")

    paths_txt = os.path.join(root, "offline", "paths_to_merge.txt")
    with open(paths_txt, "w") as f:
        f.write(sq8_path + "\n" + bm25_path + "\n")
    merged = os.path.join(root, "offline", "merged", "dedup_merged.jsonl")
    argv = offline_argv(run, device, "merge", "tasks.datastore.index=false", "tasks.eval.search=false",
                        "tasks.eval.inference=false", "tasks.eval.merge_search=true",
                        f"evaluation.search.paths_to_merge={paths_txt}", f"evaluation.search.merged_path={merged}",
                        "evaluation.search.topk_subsample_p=0.5", "evaluation.search.rerank_method=lexical")
    result = pipeline_main.main(argv)
    final = os.path.join(root, "offline", "merged", "full_subsampled_0.5_1000_dedup_merged_rerank_lexical.jsonl")
    n_docs = cfg.evaluation.search.n_docs
    ok = os.path.exists(final)
    merged_rows = read_jsonl(final) if ok else []
    long = sum(len(ex["ctxs"]) > n_docs for ex in merged_rows)
    dup = sum(len({c["retrieval text"] for c in ex["ctxs"]}) != len(ex["ctxs"]) for ex in merged_rows)
    if not ok or not merged_rows or long or dup:
        fail_later(f"merge_search: output {ok}, {len(merged_rows)} rows, {long} longer than {n_docs}, {dup} with "
                   "duplicate texts")
    log(f"merge_search (SQ8 + BM25, p 0.5, rerank lexical): {len(merged_rows)} rows, "
        f"{sum(len(ex['ctxs']) for ex in merged_rows)} ctxs kept, none over {n_docs}, no duplicate text; "
        f"{result['stage_seconds']['merge_search']:.3f} s {tag}")

    # continuation needs each ctx's next passage: the reference's "retrieval next text"
    passages = load_jsonl_shard(cfg.datastore.embedding, 0)
    cont_path = os.path.join(root, "offline", "with_next_text.jsonl")
    with open(sq8_path) as f_in, open(cont_path, "w") as f_out:
        for line in f_in:
            ex = json.loads(line)
            for c in ex["ctxs"]:
                if c is not None:
                    c["retrieval next text"] = passages[min(c["id"][1] + 1, len(passages) - 1)]["text"]
            f_out.write(json.dumps(ex) + "\n")
    ln_v = math.log(reader_vocab)
    inference = ["tasks.datastore.index=false", "tasks.eval.search=false", "tasks.eval.inference=true"]
    cal_dir = os.path.join(root, "offline", "calibration")
    out["ppl"] = {}
    for name, extra in (
        ("decontamination", [f"evaluation.search.merged_path={sq8_path}", "evaluation.decontamination=true"]),
        ("continuation", [f"evaluation.search.merged_path={cont_path}", "evaluation.use_continuation=true"]),
        ("calibration", [f"evaluation.search.merged_path={sq8_path}", "tasks.eval.task_name=perplexity_calibration",
                         f"evaluation.calibration_out_dir={cal_dir}"]),
    ):
        fa.flash_attention.launches = 0
        fa.attention_reference.cuda_calls = 0
        result = pipeline_main.main(offline_argv(run, device, name, *inference, *extra))
        sync(device)
        launches, plain = fa.flash_attention.launches, fa.attention_reference.cuda_calls
        ppl = result["ppl"]
        out["ppl"][name] = ppl.average_loss
        if not math.isfinite(ppl.perplexity) or abs(ppl.average_loss - ln_v) > 0.5 or not launches or plain:
            fail_later(f"perplexity {name}: avg loss {ppl.average_loss} (ln V {ln_v:.4f}), K1 {launches}, "
                       f"plain attention on CUDA {plain}")
        note = ""
        if name == "calibration":
            with open(os.path.join(cal_dir, "calibration_losses.pkl"), "rb") as f:
                by_example = pickle.load(f)
            n_rows = len(read_jsonl(sq8_path)) - 1  # the first window is not scored
            if len(by_example) != n_rows:
                fail_later(f"calibration_losses.pkl: {len(by_example)} rows for {n_rows} examples")
            note = f", calibration_losses.pkl {len(by_example)} rows (one per example)"
        log(f"perplexity {name}: avg loss {ppl.average_loss:.4f} (ln V = {ln_v:.4f}), K1 launches {launches}, "
            f"plain attention on CUDA {plain}{note}; inference {result['stage_seconds']['inference']:.3f} s {tag}")
    return out


def run_slice6(run: dict, ds: dict, device, reader_vocab: int, tag: str) -> dict:
    """Phase 19: the Flat scan slice on phase 7's shards, then the rest of
    the offline pipeline through the CLI on phase 4's run."""
    t0 = time.perf_counter()
    flat = build_flat_datastore(ds, device, tag)
    fused = check_fused_scan(flat, ds["queries"], device, tag)
    sq8 = check_flat_sq8(flat, ds, device, tag)
    del flat
    torch.cuda.empty_cache()
    offline = run_offline(run, device, reader_vocab, tag)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s {tag}")
    return {"fused": fused, "sq8": sq8, "offline": offline}


# ---------------------------------------------------------------- phase 20 (slice 7: speculative decoding, probes)
SPEC_DRAFT = 7           # the JAX default draft_len: verify segments of 8 tokens
SPEC_NEW = 64            # new tokens a row, as phase 10
COPY_RATES = (0.0, 0.5, 0.9)
K3_VERIFY_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# K3 at the verify shapes: (label, B, H, Hkv, D, M, dtype, window, cap)
K3_VERIFY_CASES = [
    ("pythia b8 h8 d256 Sq8 M1024 f32", 8, 8, 8, 256, 1024, torch.float32, None, None),
    ("llama b8 h32/kv8 d128 Sq8 M1024 bf16", 8, 32, 8, 128, 1024, torch.bfloat16, None, None),
    ("gemma2 b8 h16/kv8 d256 Sq8 M4608 w4096 cap50 bf16", 8, 16, 8, 256, 4608, torch.bfloat16, 4096, 50.0),
]


def row_exact(scheme, kv_cache) -> bool:
    """Whether a scheme's decode kernels keep a row's arithmetic independent
    of the row count and of the cache's capacity (K3's fixed key splits; K6,
    K7 and K8 split K by the weight's shape only), so that its speculative
    streams must equal static greedy token for token. f32 weights run
    cuBLAS, and the int8 cache's attention is plain torch."""
    return scheme is not None and kv_cache is None


def spec_prompts(tok, device, n: int = 8):
    """``n`` right-padded ~256-token c4_sample prompts (phase 10's contexts) and their lengths."""
    stream = [p for t in c4_texts(128) for p in PIECE_RE.findall(t)]
    contexts = [" ".join(stream[300 * i: 300 * i + 256]) for i in range(n)]
    ids = [tok(c)["input_ids"] for c in contexts]
    prompt = torch.zeros((n, max(len(i) for i in ids)), dtype=torch.long, device=device)
    for r, i in enumerate(ids):
        prompt[r, : len(i)] = torch.tensor(i)
    return contexts, prompt, torch.tensor([len(i) for i in ids], device=device)


@torch.inference_mode()
def verify_vs_step(model, cfg, prompt, lens, toks, g: int, kv_cache, device):
    """(step logits [B, T - 1, V], max |logit| difference): after a prefill of
    ``prompt``, ``toks[:, :T - 1]`` go through one-token forwards and, over a
    second cache, through verify forwards of g + 1 tokens (contiguous writes)
    on the same prefix; the difference is taken over every position."""
    from retrieval_scaling_tpu_torch.models.generate import embedding, forward_with_cache, init_cache

    b, s_pad = prompt.shape
    t = toks.shape[1] - 1
    m = s_pad + t + g + 2
    slots = torch.arange(m, device=device)
    dtype = torch.int8 if kv_cache == "int8" else embedding(model).weight.dtype

    def prefilled():
        cache = init_cache(cfg, b, m, dtype, device)
        forward_with_cache(model, cfg, prompt, slots[:s_pad].expand(b, s_pad), cache, slots[None, :] < lens[:, None],
                           slots[None, :s_pad] < lens[:, None], logits_rows=lens - 1)
        return cache

    cache = prefilled()
    step = []
    for j in range(t):
        pos = lens + j
        logits, _ = forward_with_cache(model, cfg, toks[:, j: j + 1], pos[:, None], cache,
                                       slots[None, :] <= pos[:, None])
        step.append(logits[:, 0].float())
    step = torch.stack(step, dim=1)
    cache, diff = prefilled(), 0.0
    for j0 in range(0, t, g + 1):
        seg = toks[:, j0: min(j0 + g + 1, t)]
        pos = lens[:, None] + j0 + torch.arange(seg.shape[1], device=device)[None, :]
        logits, _ = forward_with_cache(model, cfg, seg, pos, cache, slots[None, :] < (pos[:, -1:] + 1),
                                       contiguous_writes=True)
        diff = max(diff, (logits.float() - step[:, j0: j0 + seg.shape[1]]).abs().max().item())
    return step, diff


def divergence_verdict(label: str, row: int, t: int, step_logits, diff: float, exact: bool, tag: str) -> int:
    """Phase 20's rule for a row whose speculative stream leaves static
    greedy's at token ``t``: excused (1) only where the scheme is not
    row-exact and static greedy's top-2 logit gap there (the step that
    predicts token t) is below ``diff``, the verify-vs-step max |logit|
    difference of the same run; otherwise a failure is noted (0)."""
    gap = math.inf
    if 1 <= t <= step_logits.shape[0]:
        top = step_logits[t - 1].topk(2).values
        gap = float(top[0] - top[1])
    ok = not exact and gap < diff
    log(f"{label} row {row}: first divergence at token {t}, static greedy's top-2 logit gap {gap:.4e}, verify-vs-step "
        f"max |logit| difference {diff:.4e}: {'excused (a near tie)' if ok else 'NOT excused'} {tag}")
    if not ok:
        fail_later(f"{label} row {row}: speculative tokens leave static greedy at {t} (gap {gap}, diff {diff}, "
                   f"row-exact scheme {exact})")
    return int(ok)


def compare_streams(label: str, static, spec, step_logits, diff: float, exact: bool, tag: str):
    """(divergent rows, excused rows) of two [B, T] token tensors."""
    rows = excused = 0
    for r in range(static.shape[0]):
        ne = (static[r] != spec[r]).nonzero()
        if len(ne):
            rows += 1
            excused += divergence_verdict(label, r, int(ne[0]), step_logits[r], diff, exact, tag)
    return rows, excused


def run_speculative(run: dict, device, seed: int, tag: str) -> dict:
    """Phase 20, the static engine: make_speculative_generate_fn on phase 4's
    Pythia-1B at b8, draft_len 7, 64 new tokens, per weight scheme, with the
    float and the int8 cache; each stream against make_generate_fn's; then
    scripted emission at three prompt-copy rates (int8 weights)."""
    from retrieval_scaling_tpu_torch.models.generate import make_generate_fn, quantize_decode_params
    from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_reader, load_tokenizer
    from retrieval_scaling_tpu_torch.models.speculative import make_speculative_generate_fn

    model, tok = load_hf_reader(run["reader_dir"], device=device), load_tokenizer(run["reader_dir"])
    cfg = model.cfg
    eos = tok.eos_token_id if tok.eos_token_id is not None else 0
    _, prompt, lens = spec_prompts(tok, device)
    out = {"K3 verify": 0, "runs": {}}
    int8_model = None
    for scheme in (None, "bf16", "int8", "int4"):
        lm = model if scheme is None else quantize_decode_params(model, cfg, scheme=scheme)
        for kv in (None, "int8"):
            label = f"speculative {scheme or 'float'} weights, {kv or 'float'} cache"
            static = make_generate_fn(cfg, SPEC_NEW, eos, kv_cache=kv)(lm, prompt, lens)
            fn = make_speculative_generate_fn(cfg, SPEC_NEW, eos, draft_len=SPEC_DRAFT, kv_cache=kv, with_stats=True)
            sync(device)
            reset_decode_counts()
            t0 = time.perf_counter()
            spec, rounds, emitted = fn(lm, prompt, lens)
            sync(device)
            sec = time.perf_counter() - t0
            launches, plain_calls = read_decode_counts()
            # the int8 cache's attention is plain torch (XLA code in JAX): no K3 there
            want_verify = cfg.num_layers * fn.rounds_run if kv is None else 0
            kernels_ok = (scheme == "int4") == (launches["K8"] > 0) and (
                scheme not in ("bf16", "int8") or min(launches["K6"], launches["K7"]) > 0)
            if launches["K3 verify"] != want_verify or not kernels_ok or plain_calls:
                fail_later(f"{label}: K3 verify launches {launches['K3 verify']} (want {want_verify}), launches "
                           f"{launches}, plain calls on CUDA {plain_calls}")
            step_logits, diff = verify_vs_step(lm, cfg, prompt, lens, static, SPEC_DRAFT, kv, device)
            rows, excused = compare_streams(label, static, spec, step_logits, diff, row_exact(scheme, kv), tag)
            out["K3 verify"] += launches["K3 verify"]
            out["runs"][label] = {"rounds": int(rounds), "emitted": int(emitted), "diff": diff, "divergent": rows,
                                  "excused": excused, "seconds": sec}
            log(f"{label}: {int(emitted)} tokens in {int(rounds)} rounds ({fn.rounds_run} verify forwards run), "
                f"{int(emitted) / (prompt.shape[0] * max(int(rounds), 1)):.3f} tokens a round a row, {sec:.3f} s; "
                f"streams equal static greedy in {prompt.shape[0] - rows}/{prompt.shape[0]} rows ({excused} near ties "
                f"excused); verify-vs-step max |logit| difference {diff:.4e}; K3 verify {launches['K3 verify']} "
                f"(= {cfg.num_layers} layers x {fn.rounds_run} rounds"
                f"{' x 0: plain int8-cache attention' if kv else ''}),"
                f" K6 {launches['K6']}, K7 {launches['K7']}, K8 {launches['K8']}, K9 {launches['K9']}, plain versions "
                f"on CUDA {plain_calls} {tag}")
        if scheme == "int8":
            int8_model = lm
        elif scheme is not None:
            del lm
    out["acceptance"] = scripted_acceptance(int8_model, cfg, prompt, lens, seed, tag)
    del model, int8_model
    torch.cuda.empty_cache()
    return out


def scripted_acceptance(lm, cfg, prompt, lens, seed: int, tag: str) -> dict:
    """Tokens a round, ms a round and tokens/s of scripted emission whose
    continuations copy prompt spans at COPY_RATES (int8 weights), against
    static greedy's tokens/s at the same batch (the port's counterpart of
    bench.py:961-985); the full model runs in every verify forward."""
    from retrieval_scaling_tpu_torch.models.generate import make_generate_fn
    from retrieval_scaling_tpu_torch.models.speculative import make_speculative_generate_fn

    rng = np.random.RandomState(seed)
    b = prompt.shape[0]

    def timed(fn, *args):
        fn(*args)
        sync(prompt.device)
        t0 = time.perf_counter()
        res = fn(*args)
        sync(prompt.device)
        return res, time.perf_counter() - t0

    static_fn = make_generate_fn(cfg, SPEC_NEW, -1)
    _, static_sec = timed(static_fn, lm, prompt, lens)
    static_tps = b * SPEC_NEW / static_sec
    out = {"static_tokens_per_s": static_tps}
    fn = make_speculative_generate_fn(cfg, SPEC_NEW, -1, draft_len=SPEC_DRAFT, with_stats=True, scripted=True)
    scripts = {}
    for rate in COPY_RATES:
        script = np.zeros((b, SPEC_NEW), np.int64)
        for r in range(b):
            row, n = prompt[r].tolist(), int(lens[r])
            for p in range(0, SPEC_NEW, 8):  # spans of 8: a copy of the prompt with probability `rate`
                if rng.rand() < rate:
                    start = rng.randint(0, n - 8)
                    script[r, p: p + 8] = row[start: start + 8]
                else:
                    script[r, p: p + 8] = rng.randint(3, cfg.vocab_size, 8)
        scripts[rate] = torch.from_numpy(script).to(prompt.device)
        (toks, rounds, emitted), sec = timed(fn, lm, prompt, lens, 0, scripts[rate])
        if not torch.equal(toks.cpu(), torch.from_numpy(script)):
            fail_later(f"scripted emission at copy rate {rate}: the tokens are not the script")
        tpr = int(emitted) / (b * max(int(rounds), 1))
        tps = b * SPEC_NEW / sec
        out[rate] = {"tokens_per_round": tpr, "ms_per_round": sec * 1e3 / fn.rounds_run, "tokens_per_s": tps,
                     "vs_static": tps / static_tps}
        log(f"speculative acceptance, int8 Pythia-1B b{b}, copy rate {rate:.0%}: {tpr:.3f} tokens a round a row, "
            f"{sec * 1e3 / fn.rounds_run:.3f} ms a round ({fn.rounds_run} rounds), {tps:.1f} tokens/s against static "
            f"greedy's {static_tps:.1f} ({tps / static_tps:.3f}x) {tag}")
    # a round against a step under torch.profiler: device ms and kernel launches each (calls of 64 tokens,
    # the prefill included); the host ms are the unprofiled calls' above
    step = profiled(lambda: static_fn(lm, prompt, lens), SPEC_NEW - 1)
    rnd = profiled(lambda: fn(lm, prompt, lens, 0, scripts[0.5]), None, fn)
    out["profile"] = {"step": {**step, "host_ms": static_sec * 1e3 / (SPEC_NEW - 1)},
                      "round": {**rnd, "host_ms": out[0.5]["ms_per_round"]}}
    log(f"a speculative round (copy rate 50%, {rnd['units']} rounds) against a one-token step, int8 Pythia-1B b{b}: "
        f"host {out[0.5]['ms_per_round']:.3f} / {static_sec * 1e3 / (SPEC_NEW - 1):.3f} ms, device "
        f"{rnd['device_ms']:.3f} / {step['device_ms']:.3f} ms, {rnd['launches']:.1f} / {step['launches']:.1f} kernel "
        f"launches (torch.profiler; calls with their prefill) {tag}")
    return out


def profiled(call, units, fn=None) -> dict:
    """Device ms and CUDA kernel launches per unit of one call under
    torch.profiler; ``units`` None takes ``fn.rounds_run`` after the call."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    units = units if units is not None else fn.rounds_run
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"units": units, "device_ms": sum(e.self_device_time_total for e in events) / 1e3 / units,
            "launches": sum(e.count for e in events) / units}


def recorded(lm, max_new: int) -> list:
    """Wraps the reader backend's greedy generation function for ``max_new``
    tokens; returns the list that collects each call's (ids, lens, tokens)."""
    calls, fn = [], lm._gen_fn(max_new, 0.0)

    def wrapper(model, ids, lens, seed=0):
        toks = fn(model, ids, lens, seed)
        calls.append((ids, lens, toks))
        return toks

    lm._gen_fns[(max_new, 0.0)] = wrapper
    return calls


def run_spec_entry_points(run: dict, device, llama_dir: str, tag: str) -> dict:
    """Phase 20, the other entry points: TorchReaderLM with gen_engine
    "speculative" and "continuous_spec" on Pythia-1B (int8 weights), and
    gen_engine "speculative" on phase 13's 4-layer Llama-3.1-8B-width reader
    (GQA: 32 query heads over 8 KV heads) in bf16 and int8; every text against
    the same reader's static engine, token for token where the rule needs it."""
    from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_reader, load_tokenizer
    from retrieval_scaling_tpu_torch.rag_eval.models import TorchReaderLM

    out = {"K3 verify": 0}
    readers = (("pythia-1b", run["reader_dir"], ("int8",), ("speculative", "continuous_spec")),
               ("llama-3.1-8b-width 4 layers", llama_dir, ("bf16", "int8"), ("speculative",)))
    for name, path, schemes, engines in readers:
        model, tok = load_hf_reader(path, device=device), load_tokenizer(path)
        cfg = model.cfg
        contexts, _, _ = spec_prompts(tok, device)
        reqs = [{"context": c, "gen_kwargs": {"max_gen_toks": SPEC_NEW, "until": []}} for c in contexts]
        for scheme in schemes:
            static_lm = TorchReaderLM(model, cfg, tok, batch_size=8, quantization=scheme)
            static_calls = recorded(static_lm, SPEC_NEW)
            static_texts = static_lm.generate_until(reqs)
            for engine in engines:
                lm = TorchReaderLM(static_lm.model, cfg, tok, batch_size=8, gen_engine=engine, draft_len=SPEC_DRAFT)
                calls = recorded(lm, SPEC_NEW) if engine == "speculative" else []
                reset_decode_counts()
                t0 = time.perf_counter()
                texts = lm.generate_until(reqs)
                sync(device)
                sec = time.perf_counter() - t0
                launches, plain_calls = read_decode_counts()
                label = f"TorchReaderLM {name} {scheme} gen_engine={engine}"
                rows = excused = 0
                exact = name == "pythia-1b"  # its int8 scheme keeps every row's arithmetic: no exception
                for (ids, lens, want), (_, _, got) in zip(static_calls, calls):
                    step_logits, diff = verify_vs_step(static_lm.model, cfg, ids, lens, want, SPEC_DRAFT, None, device)
                    r, e = compare_streams(label, want, got, step_logits, diff, exact, tag)
                    rows, excused = rows + r, excused + e
                differ = sum(a != b for a, b in zip(texts, static_texts))
                if engine == "continuous_spec" and differ:
                    fail_later(f"{label}: {differ}/8 texts differ from the static engine's")
                stats = lm._cb_engine.stats if engine == "continuous_spec" else {}
                k7 = launches["K7"] if name == "pythia-1b" else 1  # the llama family has no K7 stream
                if launches["K3 verify"] == 0 or min(launches["K6"], k7) == 0 or plain_calls:
                    fail_later(f"{label}: launches {launches}, plain calls on CUDA {plain_calls}")
                out["K3 verify"] += launches["K3 verify"]
                spec_txt = (f", spec_rounds {stats['spec_rounds']}, spec_emitted {stats['spec_emitted']}"
                            if stats else "")
                log(f"{label}: 8 generate_until in {sec:.3f} s, {8 - differ}/8 texts equal the static engine's "
                    f"({rows} divergent streams, {excused} near ties excused){spec_txt}; K3 verify "
                    f"{launches['K3 verify']}, K6 {launches['K6']}, K7 {launches['K7']}, plain versions on CUDA "
                    f"{plain_calls} {tag}")
                del lm
            del static_lm
        del model
        torch.cuda.empty_cache()
    return out


@torch.inference_mode()
def localise_row_dependence(device, seed: int, tag: str) -> dict:
    """Which pieces of a verify forward keep a row's arithmetic independent
    of the row count or of the key axis's length: each op on 64 rows (or 344
    keys) against the same op on the first 8 rows (336 keys), bit for bit.
    Where a scheme's streams may leave static greedy's, this says which op
    lets them."""
    import torch.nn.functional as F

    from retrieval_scaling_tpu_torch.models import llama as lm
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(64, 4096, generator=gen, device=device)
    w = 1 + 0.1 * torch.randn(4096, generator=gen, device=device)
    bias = 0.1 * torch.randn(2048, generator=gen, device=device)
    wt = 0.02 * torch.randn(4096, 1024, generator=gen, device=device)
    qw = qm.quantize_weight(wt)
    q = torch.randn(8, 8, 8, 128, generator=gen, device=device).to(torch.bfloat16).float()
    k = torch.randn(8, 8, 344, 128, generator=gen, device=device).to(torch.bfloat16).float()
    scores = q @ k.transpose(-1, -2)
    masked = scores.clone()
    masked[..., 336:] = -1e30
    cfg = llama31_8b(4)
    pairs = {  # op: (the op on more rows or keys, cut to the part; the op on the part alone)
        "RMSNorm (llama_norm), 64 against 8 rows of 4096": (lm.llama_norm(cfg, x, w)[:8], lm.llama_norm(cfg, x[:8], w)),
        "LayerNorm, 64 against 8 rows of 2048": (F.layer_norm(x[:, :2048], (2048,), w[:2048], bias)[:8],
                                                 F.layer_norm(x[:8, :2048], (2048,), w[:2048], bias)),
        "f32 matmul (cuBLAS), 64 against 8 rows": ((x @ wt)[:8], x[:8] @ wt),
        "K6 int8 stream, 64 against 8 rows": (qm.w8_stream(x, qw.wq, qw.scale, torch.float32)[:8],
                                             qm.w8_stream(x[:8], qw.wq, qw.scale, torch.float32)),
        "int8-cache scores (batched matmul), 8 query rows against 1": (scores[:, :, :1],
                                                                       q[:, :, :1] @ k.transpose(-1, -2)),
        "int8-cache scores, 344 against 336 keys": (scores[..., :336], q @ k[:, :, :336].transpose(-1, -2)),
        "softmax, 344 keys with 8 masked against 336": (torch.softmax(masked, dim=-1)[..., :336],
                                                       torch.softmax(scores[..., :336], dim=-1)),
    }
    out = {}
    for name, (full, part) in pairs.items():
        out[name] = (full.float() - part.float()).abs().max().item()
    sync(device)
    log("row dependence on the card (0 = a row's arithmetic does not depend on the others): " + "; ".join(
        f"{name}: {'exact' if d == 0 else f'max |diff| {d:.3e}'}" for name, d in out.items()) + f" {tag}")
    return out


def k3_verify_inputs(case, gen, device):
    """Inputs of a K3 verify launch: a segment of 8 queries at n .. n + 7 per
    row (the window's edge inside it where there is a window) and, in the
    last row, a key mask with no slot, whose queries must give exactly 0."""
    label, b, h, hkv, d, m, dt, window, cap = case
    sq = SPEC_DRAFT + 1
    q = (torch.randn(b, h, sq, d, generator=gen, device=device) * (3.0 if cap else 1.0)).to(dt)
    k, v = (torch.randn(b, hkv, m, d, generator=gen, device=device).to(dt) for _ in range(2))
    lo = window + 8 if window else m // 2
    n = torch.randint(lo, m - sq, (b,), generator=gen, device=device)
    q_pos = n[:, None] + torch.arange(sq, device=device)[None, :]
    mask = torch.arange(m, device=device)[None, :] < (n + sq)[:, None]
    mask[-1] = False
    return q, k, v, mask, q_pos


def check_k3_verify(device, seed: int, tag: str) -> dict:
    """Phase 20: K3 with per-query positions against its plain version at the
    verify shapes, timed (L2 flushed) against its bound and SDPA with the
    same per-query mask (no cap); a query with no visible key gives exactly 0."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for case in K3_VERIFY_CASES:
        label, b, h, hkv, d, m, dt, window, cap = case
        q, k, v, mask, q_pos = k3_verify_inputs(case, gen, device)
        with torch.inference_mode():
            out = fa.flash_decode(q, k, v, kv_mask=mask, logit_cap=cap, q_pos=q_pos, window=window)
            ref = fa.flash_decode_reference(q.float(), k.float(), v.float(), kv_mask=mask, logit_cap=cap, q_pos=q_pos,
                                            window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        tol = K3_VERIFY_TOL[dt] * ref.abs().max().item()
        zero = bool((out[-1] == 0).all())
        if not math.isfinite(err) or err > tol or not zero:
            fail_later(f"K3 verify {label}: max abs error {err} (tol {tol}), masked row exactly 0: {zero}")
        ms = cuda_ms_cold(lambda: fa.flash_decode(q, k, v, kv_mask=mask, logit_cap=cap, q_pos=q_pos, window=window),
                          20, flush)
        plain_ms = cuda_ms_cold(lambda: fa.flash_decode_reference(q, k, v, kv_mask=mask, logit_cap=cap, q_pos=q_pos,
                                                                  window=window), 5, flush)
        vis = fa._decode_mask(q, k, mask, q_pos, window)  # [B, Sq, M]
        lib_ms = None
        if not cap:
            lib_ms = cuda_ms_cold(lambda: sdpa(q, k, v, attn_mask=vis[:, None], enable_gqa=hkv != h), 20, flush)
        elt = torch.finfo(dt).bits // 8
        keys = int(vis.any(dim=1).sum().item())  # slots some query of the row sees: read once a KV head
        n_bytes = 2 * keys * hkv * d * elt + 2 * b * h * (SPEC_DRAFT + 1) * d * elt + b * m + b * (SPEC_DRAFT + 1) * 4
        n_ops = 4 * int(vis.sum().item()) * h * d
        bound_ms, bound_by = bound(n_bytes, n_ops, "f32" if dt == torch.float32 else "bf16")
        lib_txt = "n/a (no library call applies the cap)" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"K3 verify {label}: max abs error {err:.3e} (tol {tol:.1e}), the row with no visible key exactly 0; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA with the per-query mask (not a repo kernel) {lib_txt}, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop) {tag}")
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
    return results


def probe_counters():
    from retrieval_scaling_tpu_torch.ops import decode_probes as dp
    from retrieval_scaling_tpu_torch.ops import stream_probe as sp

    return ([dp.weight_stream, dp.dual_stream, dp.tiny_copy, sp.stream_probe],
            [dp.weight_stream_reference, dp.dual_stream_reference, dp.tiny_copy_reference,
             sp.stream_probe_reference])


def count_probe_path(fn) -> dict:
    """{wrapper name: launches} of one call of ``fn``, counts zeroed before it,
    and the plain versions' calls on CUDA ("plain")."""
    kernels, plain = probe_counters()
    for k in kernels:
        k.launches = 0
    for p in plain:
        p.cuda_calls = 0
    fn()
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in kernels}
    counts["plain"] = sum(p.cuda_calls for p in plain)
    return counts


def check_decode_probes(device, seed: int, tag: str) -> dict:
    """Phase 20: the decode probes at Pythia-1B's shapes. The probe path (one
    decode step's chain of each S1 variant, S2's 16 launches and its one
    launch, S5's 33 launches) is driven with the counts zeroed before each;
    each probe is then held against its plain version and timed (L2
    flushed) against its byte bound and, where one PyTorch call computes
    the same function, that call (torch.matmul for S1-bf16, a copy for S5;
    K6 beside S1-w8bf16, the function it shares)."""
    import importlib

    from retrieval_scaling_tpu_torch.ops import decode_probes as dp
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    ablate = importlib.import_module("torch_ablate_decode")
    d, n_qkv, ff = ablate.D, ablate.NQKV, ablate.FF
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    layers, head, head_bf16 = ablate.build(gen, device)
    steps = ablate.make_steps(layers, head, head_bf16)
    step_bytes = ablate.weight_bytes(layers, head)
    x = torch.randn(8, d, generator=gen, device=device).to(torch.bfloat16)
    wl = torch.stack([ly["qkv"][0] for ly in layers])  # S2: 16 qkv-sized int8 weights, stacked
    sl = torch.stack([ly["qkv"][1] for ly in layers])
    src = torch.randn(8, 128, generator=gen, device=device)
    dst = torch.empty_like(src)
    paths = {  # probe: (what the path drives, launches it should count: (wrapper, number))
        "S1-cur": (lambda: steps["mm_cur"](x), ("weight_stream", 65)),
        "S1-preq": (lambda: steps["mm_preq"](x), ("weight_stream", 65)),
        "S1-dual": (lambda: steps["mm_fused"](x), ("dual_stream", 16)),
        "S1-w8bf16": (lambda: steps["mm_w8bf16"](x), ("weight_stream", 65)),
        "S1-touch": (lambda: steps["mm_touch"](x), ("stream_probe", 65)),
        "S1-bf16": (lambda: steps["mm_bf16k"](x), ("weight_stream", 17)),
        "S1-dual-bf16": (lambda: steps["mm_bf16k"](x), ("dual_stream", 16)),
        "S2-many1": (lambda: [dp.weight_stream(x, wl[i], sl[i], "w8bf16") for i in range(16)], ("weight_stream", 16)),
        "S2-one16": (lambda: dp.weight_stream(x, wl, sl, "w8bf16"), ("weight_stream", 1)),
        "S5": (lambda: [dp.tiny_copy(src, dst) for _ in range(33)], ("tiny_copy", 33)),
    }
    results = {}
    with torch.inference_mode():
        steps["mm_touch"](x)  # prepares K13's chunk tables
        for probe, (drive, (wrapper, want)) in paths.items():
            counts = count_probe_path(drive)
            if counts[wrapper] != want or counts["plain"]:
                fail_later(f"{probe} path: launches {counts} (want {wrapper} {want}, plain 0)")
            results[probe] = {"launches": counts[wrapper]}

        # each probe against its plain version, at one stream of the step
        ly = layers[0]
        wq, s = ly["qkv"]
        xq, xs = dp.rowquant_xla(x)
        (aq, asc), (hq, hsc) = dp.rowquant_xla(x), dp.rowquant_xla(torch.randn(8, ff, generator=gen, device=device))
        h_bf = torch.randn(8, ff, generator=gen, device=device).to(torch.bfloat16)
        f32 = torch.float32
        cases = {  # probe: (kernel, plain, exact s8?, weight bytes, activation bytes, outputs, library call, K)
            "S1-cur": (lambda o=torch.bfloat16: dp.weight_stream(x, wq, s, "cur", out_dtype=o),
                       lambda: dp.weight_stream_reference(x, wq, s, "cur", out_dtype=f32), True, wq.numel() + 4 * n_qkv,
                       2 * 8 * d, 8 * n_qkv, None, d),
            "S1-preq": (lambda o=torch.bfloat16: dp.weight_stream(xq, wq, s, "preq", xs=xs, out_dtype=o),
                        lambda: dp.weight_stream_reference(xq, wq, s, "preq", xs=xs, out_dtype=f32), True,
                        wq.numel() + 4 * n_qkv, 8 * d + 32, 8 * n_qkv, None, d),
            "S1-dual": (lambda o=torch.bfloat16: dp.dual_stream(aq, hq, x, ly["ao"][0], ly["mo"][0], ly["ao"][1],
                                                                ly["mo"][1], asc, hsc, out_dtype=o),
                        lambda: dp.dual_stream_reference(aq, hq, x, ly["ao"][0], ly["mo"][0], ly["ao"][1], ly["mo"][1],
                                                         asc, hsc, out_dtype=f32), True,
                        (d + ff) * d + 8 * d, 8 * (d + ff) + 64 + 2 * 8 * d, 8 * d, None, d + ff),
            "S1-w8bf16": (lambda o=f32: dp.weight_stream(x, wq, s, "w8bf16", out_dtype=o),
                          lambda: dp.weight_stream_reference(x, wq, s, "w8bf16", out_dtype=f32), False,
                          wq.numel() + 4 * n_qkv, 2 * 8 * d, 8 * n_qkv, None, d),
            "S1-bf16": (lambda o=f32: dp.weight_stream(x, ly["qkv_bf16"], None, "bf16", out_dtype=o),
                        lambda: dp.weight_stream_reference(x, ly["qkv_bf16"], None, "bf16", out_dtype=f32), False,
                        2 * wq.numel(), 2 * 8 * d, 8 * n_qkv, lambda: torch.matmul(x, ly["qkv_bf16"]), d),
            "S1-dual-bf16": (lambda o=f32: dp.dual_stream(x, h_bf, x, ly["ao_bf16"], ly["mo_bf16"], out_dtype=o),
                             lambda: dp.dual_stream_reference(x, h_bf, x, ly["ao_bf16"], ly["mo_bf16"], out_dtype=f32),
                             False, 2 * (d + ff) * d, 2 * 8 * (d + ff) + 2 * 8 * d, 8 * d, None, d + ff),
            "S2-one16": (lambda o=f32: dp.weight_stream(x, wl, sl, "w8bf16", out_dtype=o),
                         lambda: dp.weight_stream_reference(x, wl, sl, "w8bf16", out_dtype=f32), False,
                         wl.numel() + 4 * sl.numel(), 2 * 8 * d, 16 * 8 * n_qkv, None, d),
        }
        for probe, (kernel, plain, s8, w_bytes, x_bytes, n_out, lib, k_dim) in cases.items():
            # the check in f32 where the product is bf16 (1e-4 of max |y|), the timing in bf16, as the scripts
            y, ref = kernel(torch.bfloat16 if s8 else f32), plain()
            torch.cuda.synchronize()
            err = (y.float() - ref).abs().max().item()
            if s8:  # exact int32 sums: within one bf16 ulp of the plain f32 result
                ok = bool(((y.float() - ref).abs() <= torch.finfo(torch.bfloat16).eps * ref.abs()).all())
                limit = "one bf16 ulp of the plain f32 result"
            else:
                ok = err <= 1e-4 * ref.abs().max().item()
                limit = f"1e-4 of max |y| = {1e-4 * ref.abs().max().item():.3e}"
            if not ok or not math.isfinite(err):
                fail_later(f"{probe}: max abs error {err} beyond {limit}")
            ms = cuda_ms_cold(lambda: kernel(torch.bfloat16), 20, flush)
            plain_ms = cuda_ms_cold(plain, 3, flush)
            lib_ms = cuda_ms_cold(lib, 20, flush) if lib is not None else None
            n_bytes = w_bytes + x_bytes + 2 * n_out
            bound_ms, bound_by = bound(n_bytes, 2 * n_out * k_dim, "int8" if s8 else "bf16")
            results[probe].update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                   "bound_ms": bound_ms, "bound_by": bound_by})
        # S2's 16 launches of one weight each (the same work as one16)
        many1 = lambda: [dp.weight_stream(x, wl[i], sl[i], "w8bf16") for i in range(16)]  # noqa: E731
        y = torch.stack([dp.weight_stream(x, wl[i], sl[i], "w8bf16", out_dtype=f32) for i in range(16)])
        ref = dp.weight_stream_reference(x, wl, sl, "w8bf16", out_dtype=f32)
        err = (y - ref).abs().max().item()
        if err > 1e-4 * ref.abs().max().item():
            fail_later(f"S2-many1: max abs error {err}")
        results["S2-many1"].update({"max_abs_err": err, "ms": cuda_ms_cold(many1, 20, flush),
                                    "plain_ms": results["S2-one16"]["plain_ms"], "library_ms": None,
                                    "bound_ms": results["S2-one16"]["bound_ms"], "bound_by": "bytes"})
        results["S1-w8bf16"]["k6_ms"] = cuda_ms_cold(lambda: qm.w8_stream(x, wq, s, torch.bfloat16), 20, flush)
        # S5: one near-empty launch
        y = dp.tiny_copy(src)
        ok = torch.equal(y, src)
        if not ok:
            fail_later("S5: the copy differs")
        results["S5"].update({"max_abs_err": (y - src).abs().max().item(),
                              "ms": cuda_ms_cold(lambda: dp.tiny_copy(src, dst), 50, flush),
                              "plain_ms": cuda_ms_cold(lambda: dp.tiny_copy_reference(src), 50, flush),
                              "library_ms": cuda_ms_cold(lambda: dst.copy_(src), 50, flush),
                              "bound_ms": 2 * src.numel() * 4 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"})
        # S1-touch: K13 over one step's 65 buffers (65 launches)
        buffers = [t[0] for ly_ in layers for t in (ly_["qkv"], ly_["ao"], ly_["mi"], ly_["mo"])] + [head[0]]
        from retrieval_scaling_tpu_torch.ops import stream_probe as sp

        total = sum(sp.stream_probe([b]) for b in buffers)
        want = sum(sp.stream_probe_reference([b]) for b in buffers)
        if total != want:
            fail_later(f"S1-touch: byte sums {total} != {want}")
        results["S1-touch"].update({"max_abs_err": float(abs(total - want)),
                                    "ms": cuda_ms_cold(lambda: steps["mm_touch"](x), 10, flush),
                                    "plain_ms": cuda_ms_cold(lambda: sp.stream_probe_reference(buffers), 3, flush),
                                    "library_ms": None, "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
                                    "bound_by": "bytes"})
        # the whole step of each S1 variant (the script's numbers), for PERF.md
        step_ms = {k: cuda_ms_cold(lambda k=k: steps[k](x), 5, flush) for k in ablate.VARIANTS}
    for probe, r in results.items():
        lib_txt = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        k6_txt = f", K6 (the same function) {r['k6_ms']:.4f} ms" if "k6_ms" in r else ""
        log(f"{probe}: {r['launches']} launches on its path, max abs error {r['max_abs_err']:.3e}; kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib_txt}{k6_txt}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) {tag}")
    log("S1 decode-step chains at Pythia-1B's shapes (ms a step, L2 flushed; int8 bytes "
        f"{step_bytes / 1e9:.4f} GB, bound {step_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; bf16 twice): " + ", ".join(
            f"{k} {v:.4f}" for k, v in step_ms.items()) + f" {tag}")
    results["step_ms"] = step_ms
    del layers, head, head_bf16, steps
    torch.cuda.empty_cache()
    return results


def run_slice7(run: dict, device, seed: int, llama_dir: str, tag: str) -> dict:
    """Phase 20: speculative decoding through every entry point, K3's verify
    bounds and the decode probes."""
    t0 = time.perf_counter()
    spec = run_speculative(run, device, seed, tag)
    entry = run_spec_entry_points(run, device, llama_dir, tag)
    rows = localise_row_dependence(device, seed, tag)
    serving = run_serving(run, device, seed, tag, extra=("serve.generation_speculative=true",
                                                         f"serve.generation_draft_len={SPEC_DRAFT}"))
    if serving["K3 verify"] == 0 or serving["spec"]["spec_rounds"] == 0:
        fail_later(f"speculative serving: K3 verify launches {serving['K3 verify']}, stats {serving['spec']}")
    stats = serving["spec"]
    log(f"speculative serving: spec_rounds {stats['spec_rounds']}, spec_emitted {stats['spec_emitted']} "
        f"({stats['spec_emitted'] / max(stats['spec_rounds'], 1):.3f} tokens a round a live slot), K3 verify "
        f"{serving['K3 verify']}, {serving['excused']} near ties excused, {serving['tokens_per_s']:.1f} tokens/s at "
        f"{GEN_SLOTS} slots {tag}")
    k3v = check_k3_verify(device, seed, tag)
    probes = check_decode_probes(device, seed, tag)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s {tag}")
    return {"spec": spec, "entry": entry, "serving": serving, "k3_verify": k3v, "probes": probes, "rows": rows}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--passages", type=int, default=32768)
    parser.add_argument("--datastore-rows", type=int, default=1 << 20)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU")
    from retrieval_scaling_tpu_torch.models.bert import BertConfig
    from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig
    from retrieval_scaling_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    log(card)
    tag = f"[{card}]"

    libs = _build.build_all(["flash_attn_fwd", "ivf_gather", "flash_decode", "quant_matmul", "stream_probe",
                             "fused_scan", "decode_probes"], force=True)
    for name, lib in libs.items():
        built = _build.BUILD_LOG[name]
        log(f"built {os.path.relpath(lib, REPO)} in {built['seconds']:.1f} s (nvcc runs started together)")
        for line in built["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"ptxas {name}: {line.strip()}")

    kernel = check_kernel(device, args.seed, tag)

    root = os.path.join(_build.BUILD_DIR, "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # Contriever = BERT-base (12 x 768, 12 heads, FFN 3072, vocab 30522);
    # Pythia-1B (16 x 2048, 8 heads of 256, FFN 8192, vocab 50304, rotary
    # 0.25, parallel residual): the dataclasses' defaults
    reader_cfg = GPTNeoXConfig()
    run = run_pipeline(root, device, args.seed, args.passages, BertConfig(), reader_cfg, tag)
    measure_rates(run, device, tag)

    # slice 2's path: the IVF CLI runs and the datastore's build and search
    reset_ivf_counts()
    run_ivf_cli(run, device, reader_cfg.vocab_size, tag)
    ds = build_datastore(root, device, args.seed, tag, args.datastore_rows, 4096, 4096, NPROBE)
    launches, plain_calls = ivf_counts()
    if plain_calls or min(launches.values()) == 0:
        raise AssertionError(f"IVF path: launches {launches}, plain IVF calls on CUDA {plain_calls}")
    log(f"IVF path launches: {launches}, plain IVF calls on CUDA {plain_calls}")
    check_datastore(ds, device, tag)
    ivf = check_ivf_kernels(ds, device, tag)

    flat_ds = {key: ds[key] for key in ("ds_root", "shards", "queries")}  # phase 19 reads the shards again
    del ds
    torch.cuda.empty_cache()

    # slice 3's paths: the serving worker, then the reader backend
    serving = run_serving(run, device, args.seed, tag)
    reader = run_reader_backend(run, device, tag)
    decode = check_decode_kernels(device, args.seed, tag)
    torch.cuda.empty_cache()

    # slice 4's paths: the llama-family reader
    from retrieval_scaling_tpu_torch.models.hf_convert import load_tokenizer

    tok = load_tokenizer(run["reader_dir"])
    llama = run_llama_backend(device, args.seed, tok, tag)
    llama_cli = run_llama_cli(run, device, args.seed, tok, tag)
    gemma = run_gemma_backend(device, args.seed, tok, tag)
    slice4 = check_slice4_kernels(device, args.seed, tag)

    # slice 5's paths: packed and int8-FFN encoding, the GTR-T5 and llama-family encoders
    enc = run_encoding(run, device, args.seed, tag)
    others = run_other_encoders(run, device, args.seed, tag)
    slice5 = check_slice5_kernels(device, args.seed, tag)
    torch.cuda.empty_cache()

    # slice 6's paths: the Flat scan slice (K11, SQ8) and the rest of the offline pipeline
    slice6 = run_slice6(run, flat_ds, device, reader_cfg.vocab_size, tag)
    torch.cuda.empty_cache()

    # slice 7's paths: speculative decoding through every entry point, K3's verify bounds, the decode probes
    slice7 = run_slice7(run, device, args.seed, llama_cli["dir"], tag)

    b, h, s_len, d = 2, 8, 2048, 256  # TIMED_CASE
    k1_bound, k1_by = bound(4 * b * h * s_len * d * 2, 4 * b * h * s_len * s_len * d / 2, "bf16")
    entries = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "retrieval_scaling_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "retrieval_scaling_tpu/ops/flash_attention.py:612",
        "launches": run["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": kernel["library_ms"],
        "timed_shape": TIMED_CASE,
    }]
    for kid, name, line in (("K4", "gather_score_tiles", 77), ("K12", "gather_score_tiles_grouped", 406),
                            ("K5a", "gather_adc_tiles", 235), ("K5b", "gather_adc_tiles_grouped", 293)):
        r = ivf[kid]
        entries.append({
            "name": f"{name} ({kid})",
            "route": "cuda",
            "source": "retrieval_scaling_tpu_torch/csrc/ivf_gather.cu",
            "replaces": f"retrieval_scaling_tpu/ops/ivf_gather.py:{line}",
            "launches": launches[kid],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "timed_shape": f"b64 nprobe {NPROBE} T {r['T']}, {args.datastore_rows} x 768",
        })
    for kid, name, source, line, launches, timed in (
        ("K3", "flash_decode", "flash_decode.cu", "flash_attention.py:612", serving["K3"],
         "K3 b8 h8 D256 M1024 f32"),
        ("K6", "w8_stream", "quant_matmul.cu", "quant_matmul.py:460", reader["launches"]["K6"],
         "K6 int8 qkv_mi 2048x14336 b8"),
        ("K7", "w8_splitk", "quant_matmul.cu", "quant_matmul.py:625", reader["launches"]["K7"],
         "K7 int8 ao_mo 10240x2048 b8"),
        ("K9", "int8_matmul", "quant_matmul.cu", "quant_matmul.py:189", reader["launches"]["K9"],
         "K9 qkv_mi[:, :6144] m2048"),
    ):
        r = decode[timed]
        entries.append({
            "name": f"{name} ({kid})",
            "route": "cuda",
            "source": f"retrieval_scaling_tpu_torch/csrc/{source}",
            "replaces": f"retrieval_scaling_tpu/ops/{line}",
            "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for key, v in decode.items() if key.startswith(kid + " ")),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "timed_shape": timed[3:],
            "path": "phase 9 (serving)" if kid == "K3" else "phase 10 (reader backend, bf16 + int8 runs)",
        })
    def slice4_entry(kid, name, source, line, launches, timed, path):
        r = slice4[timed]
        return {
            "name": f"{name} ({kid})", "route": "cuda", "source": f"retrieval_scaling_tpu_torch/csrc/{source}",
            "replaces": line, "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for key, v in slice4.items() if key.startswith(kid + " ")),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timed_shape": timed.split(" ", 1)[1], "path": path,
        }

    entries.insert(1, slice4_entry(
        "K2", "flash_attn_fwd window + soft-cap", "flash_attn_fwd.cu",
        # every attention launch of Gemma-2 carries the cap, so its cap count is its K2 count
        "retrieval_scaling_tpu/ops/flash_attention.py:612", gemma["launches"]["K2 cap"],
        "K2 gemma2 b1 h16/kv8 S8192 d256 w4096 cap50", "phase 14 (Gemma-2-9B backend, bf16 + int4)"))
    k3 = next(e for e in entries if e["name"].endswith("(K3)"))
    k3_cap = slice4["K3cap b8 h16/kv8 D256 M8192 cap50 bf16"]
    k3["soft_cap"] = {"launches": gemma["launches"]["K3 cap"], "path": "phase 14 (Gemma-2-9B generate_until)",
                      "timed_shape": "b8 h16/kv8 D256 M8192 cap50 bf16",
                      "max_abs_err": max(v["max_abs_err"] for key, v in slice4.items() if key.startswith("K3cap")),
                      **{key: k3_cap[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    entries.append(slice4_entry("K8", "int4_gemm", "quant_matmul.cu", "retrieval_scaling_tpu/ops/quant_matmul.py:891",
                                llama["launches"]["K8"], "K8 gate_w 4096x14336 m8",
                                "phase 12 (Llama-3.1-8B backend, int4)"))
    entries.append(slice4_entry("K13", "stream_probe", "stream_probe.cu", "bench.py:930",
                                sum(f["launches"] for f in llama["floor"].values()), "K13 int4 decode buffers",
                                "phase 12 (the decode floor of the bf16, int8 and int4 weight buffers)"))
    def slice5_entry(kid, name, line, launches, timed, path):
        r = slice5[timed]
        return {
            "name": f"{name} ({kid})", "route": "cuda", "source": f"retrieval_scaling_tpu_torch/csrc/"
            + ("flash_attn_fwd.cu" if kid == "K2s" else "quant_matmul.cu"),
            "replaces": line, "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for key, v in slice5.items() if key.startswith(kid + " ")),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "timed_shape": timed.split(" ", 1)[1], "path": path,
        }

    entries.insert(2, slice5_entry(
        "K2s", "flash_attn_fwd segments", "retrieval_scaling_tpu/ops/flash_attention.py:612",
        sum(v["K2s"] for v in enc["launches"].values()), f"K2s {K2S_BATCH}",
        "phase 16 (packed and packed + int8 CLI runs)"))
    entries.append(slice5_entry(
        "K10", "int8_res_ln", "retrieval_scaling_tpu/ops/quant_matmul.py:766",
        sum(v["K10"] for v in enc["launches"].values()), "K10 m524288 3072->768 bf16",
        "phase 16 (int8 and packed + int8 CLI runs)"))
    k11 = slice6["fused"]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries.append({
        "name": "segmax_scan (K11)", "route": "cuda", "source": "retrieval_scaling_tpu_torch/csrc/fused_scan.cu",
        "replaces": "retrieval_scaling_tpu/ops/fused_scan.py:73", "launches": k11["launches"]["K11"],
        "max_abs_err": k11["max_abs_err"], **{key: k11[1][key] for key in timed},
        "timed_shape": f"b1, {args.datastore_rows} x 768 bf16, n_valid N - {K11_CUT}",
        "path": "phase 19 (flat_topk_fused at b1 and b64; K4 re-scores the kept segments)",
        "b64": {key: k11[64][key] for key in timed},
        "top100_ms": {f"b{b}": {"flat_topk_fused": k11[b]["fused_ms"], "chunked_topk_scores": k11[b]["flat_route_ms"]}
                      for b in (1, 64)},
    })
    k3v = slice7["k3_verify"]
    timed_v = K3_VERIFY_CASES[0][0]
    entries.append({
        "name": "flash_decode verify (K3-verify)", "route": "cuda",
        "source": "retrieval_scaling_tpu_torch/csrc/flash_decode.cu",
        "replaces": "retrieval_scaling_tpu/ops/flash_attention.py:612",
        "launches": slice7["spec"]["K3 verify"] + slice7["entry"]["K3 verify"] + slice7["serving"]["K3 verify"],
        "max_abs_err": max(v["max_abs_err"] for v in k3v.values()), **{key: k3v[timed_v][key] for key in timed},
        "timed_shape": timed_v,
        "path": "phase 20 (make_speculative_generate_fn per scheme, TorchReaderLM speculative / continuous_spec, "
                "the speculative worker)",
        "cases": {label: {key: r[key] for key in ("max_abs_err",) + timed} for label, r in k3v.items()},
    })
    probe_sites = (("S1-cur", "weight_stream cur", "scripts/ablate_decode.py:147"),
                   ("S1-preq", "weight_stream preq", "scripts/ablate_decode.py:162"),
                   ("S1-dual", "dual_stream int8", "scripts/ablate_decode.py:178"),
                   ("S1-w8bf16", "weight_stream w8bf16", "scripts/ablate_decode.py:213"),
                   ("S1-touch", "stream_probe per buffer", "scripts/ablate_decode.py:233"),
                   ("S1-bf16", "weight_stream bf16", "scripts/ablate_decode.py:287"),
                   ("S1-dual-bf16", "dual_stream bf16", "scripts/ablate_decode.py:301"),
                   ("S2-many1", "weight_stream w8bf16 L=1 x16", "scripts/ablate_launch_overhead.py:57"),
                   ("S2-one16", "weight_stream w8bf16 L=16", "scripts/ablate_launch_overhead.py:84"),
                   ("S5", "tiny_copy", "scripts/profile_decode_gap.py:144"))
    for probe, name, line in probe_sites:
        r = slice7["probes"][probe]
        entries.append({
            "name": f"{name} ({probe})", "route": "cuda",
            "source": "retrieval_scaling_tpu_torch/csrc/" + ("stream_probe.cu" if probe == "S1-touch" else
                                                           "decode_probes.cu"),
            "replaces": line, "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            **{key: r[key] for key in timed}, "path": "phase 20 (the decode probe path at Pythia-1B's shapes)",
            **({"k6_ms": r["k6_ms"]} if "k6_ms" in r else {}),
        })
    acc = slice7["spec"]["acceptance"]
    log("slice 7: speculative int8 Pythia-1B b8 tokens a round / tokens/s (x static greedy) at copy rates " + ", ".join(
        f"{rate:.0%} {acc[rate]['tokens_per_round']:.3f} / {acc[rate]['tokens_per_s']:.1f} "
        f"({acc[rate]['vs_static']:.3f}x)" for rate in COPY_RATES) + f"; S2 launch cost "
        f"{(slice7['probes']['S2-many1']['ms'] - slice7['probes']['S2-one16']['ms']) / 15 * 1e3:.2f} us {tag}")
    log(f"slice 6: Flat {args.datastore_rows} x 768 QPS at b64 / ms at b1: " + ", ".join(
        f"{k} {v[0]:.1f} / {v[1]:.3f}" for k, v in slice6["sq8"].items() if k != "recall")
        + f"; SQ8 recall@10 {slice6['sq8']['recall']:.4f}; BM25 stages " + ", ".join(
        f"{k} {v:.3f} s" for k, v in slice6["offline"]["bm25_seconds"].items()) + f" {tag}")
    log(f"slice 3: /search p50 {serving['search_p50_ms']:.2f} ms, /generate {serving['tokens_per_s']:.1f} tokens/s "
        f"at {GEN_SLOTS} slots; decode ms/step at b8: " + ", ".join(
            f"{k} {reader[k]:.4f}" for k in ("float", "bf16", "int8", "int4")) + f" {tag}")
    log("slice 4: Llama-3.1-8B decode ms/step at b8: " + ", ".join(
        f"{k} {v:.4f}" + (f" (K13 floor {llama['floor'][k]['ms']:.4f})" if k in llama["floor"] else "")
        for k, v in llama["ms"].items()) + f"; Gemma-2-9B loglikelihood tokens/s at ~7k context, b2: " + ", ".join(
        f"{k} {v:.1f}" for k, v in gemma["tokens_per_s"].items()) + f"; llama CLI K1 {llama_cli['K1']}, /generate "
        f"{llama_cli['serving']['tokens_per_s']:.1f} tokens/s {tag}")
    log("slice 5: encoder passages/s bucketed / packed at mean " + ", ".join(
        f"{v['mean_tokens']:.1f} tokens {v['bucketed']:.1f} / {v['packed']:.1f}" for v in enc["rates"].values())
        + f"; bf16 / int8 FFN at "
        f"2048 x 256 {enc['int8_rate'][0]:.1f} / {enc['int8_rate'][1]:.1f}; GTR-T5-base and Qwen3-Embedding-0.6B "
        f"{others} {tag}")
    log(json.dumps({"kernels": entries}))
    if FAILURES:
        raise AssertionError(f"{len(FAILURES)} checks failed: " + "; ".join(FAILURES))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
