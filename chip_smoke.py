#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (retrieval_scaling_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--passages 32768]

Phases, each of which must pass (any failure exits nonzero):
  1. print the card's name and power limit; no CUDA device -> exit 1;
  2. build kernel K1 from retrieval_scaling_tpu_torch/csrc with nvcc (sm_90a);
  3. hold K1 against its plain PyTorch version (f32 math on the same bf16
     inputs) at the main path's shapes: max abs error <= 2e-2, the bf16
     envelope of tests/test_ops.py, and a fully masked row exactly 0;
  4. drive the port's quick-start pipeline through its CLI entry point
     (example_config: Contriever embed -> Flat index -> exact search ->
     Pythia-1B perplexity) at full model width with random weights made
     from --seed, and check what comes out and that every attention call
     went through K1;
  5. time the encoder, the reader and K1 against the plain version.
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
            timing[label] = (ms, plain)
    torch.cuda.synchronize()
    ms, plain = timing[TIMED_CASE]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain}


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


def ids_agree(port_ids, q64, db64, k: int) -> int:
    """Rows where the card's top-k ids differ from the float64 scan by more
    than ties: a differing id must score within the bf16 error bound of the
    reference's k-th score (each product of bf16-rounded operands is off by
    at most 2^-8 relative, so a score by at most 2^-8 * sum|q_i x_i|)."""
    bad = 0
    for qi in range(q64.shape[0]):
        scores = db64 @ q64[qi]
        ref = np.argsort(-scores, kind="stable")[:k]
        if set(port_ids[qi].tolist()) == set(ref.tolist()):
            continue
        bound = 2.0 ** -8 * (np.abs(db64) @ np.abs(q64[qi])).max()
        kth = scores[ref[-1]]
        if any(scores[i] < kth - 2 * bound for i in port_ids[qi]):
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--passages", type=int, default=32768)
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

    lib = _build.build("flash_attn_fwd", force=True)
    built = _build.BUILD_LOG["flash_attn_fwd"]
    log(f"built {os.path.relpath(lib, REPO)} in {built['seconds']:.1f} s")
    for line in built["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    kernel = check_kernel(device, args.seed, tag)

    root = os.path.join(_build.BUILD_DIR, "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # Contriever = BERT-base (12 x 768, 12 heads, FFN 3072, vocab 30522);
    # Pythia-1B (16 x 2048, 8 heads of 256, FFN 8192, vocab 50304, rotary
    # 0.25, parallel residual): the dataclasses' defaults
    run = run_pipeline(root, device, args.seed, args.passages, BertConfig(), GPTNeoXConfig(), tag)
    measure_rates(run, device, tag)

    log(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "retrieval_scaling_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "retrieval_scaling_tpu/ops/flash_attention.py:612",
        "launches": run["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "timed_shape": TIMED_CASE,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
