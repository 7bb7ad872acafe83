#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (retrieval_scaling_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--passages 32768] [--datastore-rows 1048576]

Phases, each of which must pass (any failure exits nonzero):
  1. print the card's name and power limit; no CUDA device -> exit 1;
  2. build the kernels from retrieval_scaling_tpu_torch/csrc with nvcc
     (sm_90a), one nvcc per source, all started together: K1
     (flash_attn_fwd.cu), K4/K12/K5a/K5b (ivf_gather.cu), K3
     (flash_decode.cu) and K6/K7/K9 (quant_matmul.cu);
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
     quantization None, bf16 and int8 (batch 8, 8 generate_until requests
     on ~256-token c4_sample contexts with 64 new tokens, 8 loglikelihood
     pairs): K6, K7 and K9 launched and their plain versions ran 0 times on
     CUDA; bf16 first-step logits within 2e-2 of max |logit| of the float
     model's, int8 per-row cosine > 0.99; ms per decode step per scheme;
 11. K3, K6, K7 and K9 against their plain versions at the path's shapes,
     timed against their bounds and, where one PyTorch call computes the
     same function, that call (SDPA for K3, torch.matmul for the bf16
     scheme's K6 / K7). Limits: K3 1e-4 (f32) or 1e-2 (bf16) of max |y|,
     K6 / K7 1e-4 of max |y|, K9 one f32 ulp; K9 also at the reader's
     m = 2048 on the strided column slices and row parts of qkv_mi / ao_mo
     and on the head, through the store helpers.
Numbers go to earlier lines, tagged with the card; the second-to-last line
is the kernels JSON and the last line the device JSON.
"""


from __future__ import annotations

import argparse
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

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
    out = {"queries": queries, "truth": truth, "emb": emb, "nprobe": nprobe, "ds_root": ds_root}
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
    """{name: wrapper or plain version} of slice 3's kernels and the plain
    attention versions whose CUDA calls must stay 0."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    kernels = {"K3": fa.flash_decode, "K6": qm.w8_stream, "K7": qm.w8_splitk, "K9": qm.int8_matmul}
    plain = [fa.flash_decode_reference, fa.attention_reference, qm.w8_stream_reference, qm.w8_splitk_reference,
             qm.int8_matmul_reference]
    return kernels, plain


def reset_decode_counts() -> None:
    kernels, plain = decode_counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plain:
        fn.cuda_calls = 0


def read_decode_counts():
    kernels, plain = decode_counters()
    return {k: fn.launches for k, fn in kernels.items()}, sum(fn.cuda_calls for fn in plain)


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


def run_serving(run: dict, device, seed: int, tag: str) -> dict:
    """Phase 9: the worker entry point on phase 4's index and reader."""
    import threading

    from retrieval_scaling_tpu_torch.models.generate import make_generate_fn
    from retrieval_scaling_tpu_torch.serve import __main__ as serve_main
    from retrieval_scaling_tpu_torch.serve.http_server import find_free_port

    root = os.path.dirname(run["corpus"])
    overrides = pipeline_argv(root, run["corpus"], run["enc_dir"], run["reader_dir"], device)[4:]
    argv = ["--mode", "worker", "--device", device.type, "--config-name", "example_config", "--registry", "",
            "--port", str(find_free_port(6000, 7000)), *overrides, f"serve.generation_model={run['reader_dir']}",
            f"serve.generation_slots={GEN_SLOTS}", f"serve.generation_max_len={GEN_MAX_LEN}", "serve.registry=null"]
    with open(run["corpus"]) as f:
        queries = [" ".join(json.loads(next(f))["text"].split()[:12]) for _ in range(16)]

    reset_decode_counts()
    t0 = time.perf_counter()
    server = serve_main.main(argv, block=False)
    try:
        started = time.perf_counter() - t0
        gen = server.generator
        prompts = gen_prompts(gen.tokenizer, seed)
        search_out, search_ms = [None] * 16, [0.0] * 16

        def search(i):
            t = time.perf_counter()
            search_out[i] = http(server.port, "/search", {"query": queries[i], "n_docs": 10})["results"]
            search_ms[i] = (time.perf_counter() - t) * 1e3

        def generate(i):
            gen_out[i] = http(server.port, "/generate", {"prompt": prompts[i][0], "max_tokens": prompts[i][1]})

        for i in range(16):  # one at a time: per-request latency through HTTP
            search(i)
        gen_out = [None] * 8
        steps0 = gen.engine.stats["slot_steps"]
        t1 = time.perf_counter()
        threads = [threading.Thread(target=generate, args=(i,)) for i in range(8)]
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
        n_tokens = 0
        for (prompt, max_new), out in zip(prompts, gen_out):
            ids = tok(prompt)["input_ids"]
            toks = make_generate_fn(model.cfg, max_new, eos)(
                model, torch.tensor([ids], device=device), torch.tensor([len(ids)], device=device))[0].tolist()
            toks = toks[: toks.index(eos)] if eos in toks else toks
            if out["text"] != tok.decode(toks, skip_special_tokens=True) or out["n_tokens"] != len(toks):
                raise AssertionError(f"/generate ({len(ids)}-token prompt) differs from the static greedy text")
            n_tokens += out["n_tokens"]
    finally:
        server.shutdown()
    need = model.cfg.num_layers * steps
    if launches["K3"] < need or plain_calls:
        raise AssertionError(f"serving: K3 launches {launches['K3']} (need >= {need}), plain calls on CUDA "
                             f"{plain_calls} (need 0)")
    p50 = float(np.percentile(search_ms, 50))
    log(f"serving: worker up in {started:.2f} s; 16 /search: p50 {p50:.2f} ms, max {max(search_ms):.2f} ms "
        f"(HTTP, host tokenizer, encoder, Flat scan, passage fetch); /search ids equal a direct search (ties aside) "
        f"{tag}")
    log(f"serving: 8 concurrent /generate ({', '.join(str(len(gen.tokenizer(p)['input_ids'])) for p, _ in prompts)}"
        f"-token prompts) in {gen_sec:.3f} s: {n_tokens} tokens, {n_tokens / gen_sec:.1f} tokens/s at "
        f"{GEN_SLOTS} slots, {steps} decode steps; every text equals the static greedy text; K3 launches "
        f"{launches['K3']} (>= {need}), plain attention / K3 on CUDA 0 {tag}")
    return {"K3": launches["K3"], "search_p50_ms": p50, "tokens_per_s": n_tokens / gen_sec}


def _row_cosine(a, b):
    a, b = a.double(), b.double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()


def run_reader_backend(run: dict, device, tag: str) -> dict:
    """Phase 10: TorchReaderLM with quantization None, bf16 and int8."""
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
    out, launches_total, logits = {}, {"K3": 0, "K6": 0, "K7": 0, "K9": 0}, {}
    for scheme in (None, "bf16", "int8"):
        lm = TorchReaderLM(model, cfg, tok, batch_size=8, quantization=scheme)
        reset_decode_counts()
        texts = lm.generate_until(reqs)
        scores = lm.loglikelihood(pairs)
        sync(device)
        launches, plain_calls = read_decode_counts()
        name = scheme or "float"
        if len(texts) != 8 or not all(math.isfinite(s) for s, _ in scores) or plain_calls:
            raise AssertionError(f"reader {name}: {len(texts)} texts, scores {scores}, plain calls on CUDA {plain_calls}")
        if scheme is not None and min(launches["K6"], launches["K7"]) == 0:
            raise AssertionError(f"reader {name}: launches {launches}")
        if scheme == "int8" and launches["K9"] == 0:
            raise AssertionError(f"reader int8: K9 launches {launches}")
        for k in launches:
            launches_total[k] += launches[k]
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
    log(f"reader logits, first decode step vs float: bf16 max |diff| {err_bf16:.3e} of max |logit| (tol 2e-2), "
        f"int8 min row cosine {cos_int8:.6f} (> 0.99) {tag}")
    if err_bf16 > 2e-2 or cos_int8 <= 0.99:
        raise AssertionError(f"quantized logits: bf16 {err_bf16}, int8 cosine {cos_int8}")
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

    libs = _build.build_all(["flash_attn_fwd", "ivf_gather", "flash_decode", "quant_matmul"], force=True)
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

    del ds
    torch.cuda.empty_cache()

    # slice 3's paths: the serving worker, then the reader backend
    serving = run_serving(run, device, args.seed, tag)
    reader = run_reader_backend(run, device, tag)
    decode = check_decode_kernels(device, args.seed, tag)

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
    log(f"slice 3: /search p50 {serving['search_p50_ms']:.2f} ms, /generate {serving['tokens_per_s']:.1f} tokens/s "
        f"at {GEN_SLOTS} slots; decode ms/step at b8: " + ", ".join(
            f"{k} {reader[k]:.4f}" for k in ("float", "bf16", "int8")) + f" {tag}")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
