#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (retrieval_scaling_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--passages 32768] [--datastore-rows 1048576]

Phases, each of which must pass (any failure exits nonzero):
  1. print the card's name and power limit; no CUDA device -> exit 1;
  2. build the kernels from retrieval_scaling_tpu_torch/csrc with nvcc
     (sm_90a), one nvcc per source, all started together: K1
     (flash_attn_fwd.cu) and K4/K12/K5a/K5b (ivf_gather.cu);
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
     bound and its plain version.
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
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
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

    libs = _build.build_all(["flash_attn_fwd", "ivf_gather"], force=True)
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
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
