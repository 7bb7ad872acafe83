"""Port parity: the serving tier (retrieval_scaling_tpu_torch.serve).

A tiny datastore (a random BERT encoder checkpoint, a word-level corpus, its
embeddings and Flat index) is built once by the port on the CPU. The JAX
``RetrievalEngine.search_batch`` over the same index files and checkpoint is
the reference for the port's ``POST /search`` (same ids and passages; both
encoders run in f32). The worker entry point (``python -m
retrieval_scaling_tpu_torch.serve --mode worker``) is driven in-process with
a generation model: ``POST /generate`` returns the port's static greedy text
for the same prompt (with the speculative slot pool too), and the registry line, the ``RST_OVERRIDE_*`` and
topology variables and the introspection routes keep the JAX contract.
"""

import json
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_word_tokenizer, write_corpus_jsonl
from retrieval_scaling_tpu import config as jconfig
from retrieval_scaling_tpu.index.base import Indexer as JaxIndexer
from retrieval_scaling_tpu.search.encoder import EncodeOptions as JaxEncodeOptions
from retrieval_scaling_tpu.search.encoder import load_encoder as jax_load_encoder
from retrieval_scaling_tpu.serve.engine import RetrievalEngine as JaxRetrievalEngine
from retrieval_scaling_tpu_torch import config as pconfig
from retrieval_scaling_tpu_torch.index.base import Indexer
from retrieval_scaling_tpu_torch.models.bert import BertConfig, init_bert_params
from retrieval_scaling_tpu_torch.models.generate import make_generate_fn
from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig, init_gpt_neox_params
from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_reader, load_tokenizer, save_hf_checkpoint
from retrieval_scaling_tpu_torch.pipeline.embed import generate_passage_embeddings
from retrieval_scaling_tpu_torch.pipeline.index_build import build_index
from retrieval_scaling_tpu_torch.search.encoder import EncodeOptions, load_encoder
from retrieval_scaling_tpu_torch.serve import __main__ as serve_main
from retrieval_scaling_tpu_torch.serve.engine import MicroBatcher, RetrievalEngine
from retrieval_scaling_tpu_torch.serve.http_server import SearchAPIServer, find_free_port, serve_worker_from_config

torch.set_num_threads(1)
CPU = torch.device("cpu")
QUERIES = ["word3 word17 word40", "word100 word5", "word7 word7 word8 word150 word2"]


def _overrides(root, corpus, enc_dir):
    return [
        "datastore.domain=servedomain",
        f"datastore.raw_data_path={corpus}",
        f"datastore.datastore_root_dir={root}/scaling_out",
        "datastore.chunk_size=16",
        f"model.datastore_encoder={enc_dir}", f"model.datastore_tokenizer={enc_dir}",
        f"model.query_encoder={enc_dir}", f"model.query_tokenizer={enc_dir}",
        "datastore.embedding.per_device_batch_size=64",
        "evaluation.search.n_docs=4",
    ]


@pytest.fixture(scope="module")
def datastore(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    corpus = write_corpus_jsonl(str(root / "corpus.jsonl"), num_docs=30, words_per_doc=48)
    with open(corpus) as f:
        tok = make_word_tokenizer([json.loads(line)["text"] for line in f] + QUERIES)
    gen = torch.Generator().manual_seed(0)
    enc_dir, reader_dir = str(root / "contriever-tiny"), str(root / "reader-tiny")
    for path, model in (
        (enc_dir, init_bert_params(BertConfig(vocab_size=tok.vocab_size + 8, hidden_size=32, num_layers=2,
                                              num_heads=4, intermediate_size=64, max_position_embeddings=64), gen)),
        (reader_dir, init_gpt_neox_params(GPTNeoXConfig(vocab_size=tok.vocab_size + 8, hidden_size=64, num_layers=2,
                                                        num_heads=2, intermediate_size=128,
                                                        max_position_embeddings=128), gen)),
    ):
        save_hf_checkpoint(model, path)
        tok.save_pretrained(path)
    overrides = _overrides(root, corpus, enc_dir)
    cfg = pconfig.load_config("default", overrides=overrides)
    generate_passage_embeddings(cfg, CPU)
    build_index(cfg, CPU)
    return root, overrides, enc_dir, reader_dir


def _post(port, route, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=60) as resp:
        return json.loads(resp.read())


def test_search_route_matches_jax_engine(datastore):
    _, overrides, enc_dir, _ = datastore
    jcfg = jconfig.load_config("default", overrides=overrides)
    jengine = JaxRetrievalEngine(jax_load_encoder(enc_dir, dtype=jnp.float32), JaxIndexer(jcfg).datastore,
                                 JaxEncodeOptions(batch_size=8, maxlength=64))
    want = jengine.search_batch(QUERIES, 4)
    jengine.batcher.shutdown()

    cfg = pconfig.load_config("default", overrides=overrides)
    engine = RetrievalEngine(load_encoder(enc_dir, CPU, dtype=torch.float32), Indexer(cfg, CPU).datastore,
                             EncodeOptions(batch_size=8, maxlength=64))
    server = SearchAPIServer({"servedomain": engine}, default_n_docs=4)
    port = server.serve(port=find_free_port(), block=False)
    try:
        got = _post(port, "/search", {"queries": QUERIES, "n_docs": 4})
        single = _post(port, "/search", {"query": QUERIES[0], "n_docs": 2})
    finally:
        server.shutdown()
    assert got["message"] == "Search completed successfully"
    for res, ref, q in zip(got["results"], want, QUERIES):
        assert res["query"] == q and res["n_docs"] == 4
        assert [list(i) for i in res["IDs"]] == [list(map(int, i)) for i in ref["IDs"]]
        assert res["passages"] == ref["passages"]
        np.testing.assert_allclose(res["scores"], np.asarray(ref["scores"], np.float64), rtol=1e-4, atol=1e-5)
    assert single["results"]["IDs"] == got["results"][0]["IDs"][:2]


def test_worker_entry_point_generates_the_static_greedy_text(datastore, monkeypatch):
    root, overrides, _, reader_dir = datastore
    registry = str(root / "registry.jsonl")
    monkeypatch.setenv("RST_OVERRIDE_EVALUATION__SEARCH__N_DOCS", "3")
    monkeypatch.setenv("DS_DOMAIN", "served")
    argv = ["--mode", "worker", "--device", "cpu", "--config-name", "default", "--registry", registry,
            "--port", str(find_free_port()), *overrides, f"serve.generation_model={reader_dir}",
            "serve.generation_slots=2", "serve.generation_max_len=96"]
    server = serve_main.main(argv, block=False)
    prompts = [("word3 word9 word27 word81 word4", 6), ("word11", 9), ("word50 word51 word52", 4)]
    outs = [None] * len(prompts)

    def ask(i):
        outs[i] = _post(server.port, "/generate", {"prompt": prompts[i][0], "max_tokens": prompts[i][1]})

    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        search = _post(server.port, "/search", {"query": "word3 word4"})
        assert _get(server.port, "/health") == {"status": "ok"}
        assert _get(server.port, "/queue_size") == {"queue_size": {"served": 0}}
        assert _get(server.port, "/current_search") == {"current_search": {"served": None}}
    finally:
        server.shutdown()
    assert len(search["results"]["IDs"]) == 3  # the RST_OVERRIDE_ default n_docs
    with open(registry) as f:
        line = json.loads(f.readline())
    assert line["domain_name"] == "served" and line["chunk_id"] == 0
    assert line["endpoint"].endswith(f":{server.port}/search")

    model, tok = load_hf_reader(reader_dir), load_tokenizer(reader_dir)
    eos = tok.eos_token_id
    for (prompt, max_new), out in zip(prompts, outs):
        ids = tok(prompt)["input_ids"]
        toks = make_generate_fn(model.cfg, max_new, eos)(model, torch.tensor([ids]), torch.tensor([len(ids)]))
        toks = toks[0].tolist()
        toks = toks[: toks.index(eos)] if eos in toks else toks
        assert out["text"] == tok.decode(toks, skip_special_tokens=True)
        assert out["n_tokens"] == len(toks) and out["message"] == "Generation completed successfully"


def test_worker_generates_with_a_llama_family_reader(datastore, tmp_path):
    """serve.generation_model may be a llama-family checkpoint (here a tiny
    Gemma-2: GQA, soft-caps, a window of 8 shorter than the prompts): each
    /generate text equals the static greedy text of the same reader."""
    from retrieval_scaling_tpu_torch.models.llama import LlamaConfig, init_llama_params

    root, overrides, _, reader_dir = datastore
    tok = load_tokenizer(reader_dir)
    cfg = LlamaConfig(vocab_size=tok.vocab_size + 8, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                      head_dim=16, intermediate_size=128, max_position_embeddings=128, tie_embeddings=True,
                      hidden_act="gelu_tanh", rms_norm_offset=True, embedding_multiplier=8.0,
                      norm_placement="pre_post", attn_logit_softcap=50.0, final_logit_softcap=30.0,
                      query_pre_attn_scalar=16, sliding_window=8, sliding_pattern=(True, False))
    llama_dir = str(tmp_path / "gemma2-tiny")
    save_hf_checkpoint(init_llama_params(cfg, torch.Generator().manual_seed(3)), llama_dir)
    tok.save_pretrained(llama_dir)
    argv = ["--mode", "worker", "--device", "cpu", "--config-name", "default", "--registry", "",
            "--port", str(find_free_port(5600, 5700)), *overrides, f"serve.generation_model={llama_dir}",
            "serve.generation_slots=2", "serve.generation_max_len=96", "serve.registry=null"]
    server = serve_main.main(argv, block=False)
    prompts = [("word3 word9 word27 word81 word4 word5 word6 word7 word8 word9 word10 word11", 7), ("word11", 5)]
    try:
        outs = [_post(server.port, "/generate", {"prompt": p, "max_tokens": n}) for p, n in prompts]
    finally:
        server.shutdown()
    model = load_hf_reader(llama_dir)
    assert model.cfg == cfg
    eos = tok.eos_token_id
    for (prompt, max_new), out in zip(prompts, outs):
        ids = tok(prompt)["input_ids"]
        toks = make_generate_fn(cfg, max_new, eos)(model, torch.tensor([ids]), torch.tensor([len(ids)]))[0].tolist()
        toks = toks[: toks.index(eos)] if eos in toks else toks
        assert out["text"] == tok.decode(toks, skip_special_tokens=True) and out["n_tokens"] == len(toks)


def test_worker_speculative_generation_equals_static_greedy(datastore):
    """``serve.generation_speculative=true`` with ``serve.generation_draft_len``:
    the worker's slot pool runs draft-and-verify rounds (counted in its
    stats), and each concurrent /generate text equals the static greedy text."""
    _, overrides, _, reader_dir = datastore
    argv = ["--mode", "worker", "--device", "cpu", "--config-name", "default", "--registry", "",
            "--port", str(find_free_port(5700, 5800)), *overrides, f"serve.generation_model={reader_dir}",
            "serve.generation_slots=2", "serve.generation_max_len=96", "serve.generation_speculative=true",
            "serve.generation_draft_len=3", "serve.registry=null"]
    server = serve_main.main(argv, block=False)
    prompts = [("word3 word9 word3 word9 word3 word9 word27", 12), ("word11 word12", 9), ("word50 word51", 7)]
    outs = [None] * len(prompts)

    def ask(i):
        outs[i] = _post(server.port, "/generate", {"prompt": prompts[i][0], "max_tokens": prompts[i][1]})

    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        engine = server.generator.engine
    finally:
        server.shutdown()
    assert engine.speculative and engine.draft_len == 3 and engine.stats["spec_rounds"] > 0
    assert engine.stats["spec_emitted"] >= engine.stats["spec_rounds"]
    model, tok = load_hf_reader(reader_dir), load_tokenizer(reader_dir)
    eos = tok.eos_token_id
    for (prompt, max_new), out in zip(prompts, outs):
        ids = tok(prompt)["input_ids"]
        toks = make_generate_fn(model.cfg, max_new, eos)(model, torch.tensor([ids]), torch.tensor([len(ids)]))
        toks = toks[0].tolist()
        toks = toks[: toks.index(eos)] if eos in toks else toks
        assert out["text"] == tok.decode(toks, skip_special_tokens=True) and out["n_tokens"] == len(toks)


def test_build_mode_embeds_indexes_and_serves(datastore, tmp_path):
    """Without --mode worker the entry point embeds the raw data and builds
    its index first (here into a fresh root), as JAX's serve/__main__ does."""
    root, overrides, _, _ = datastore
    fresh = [o for o in overrides if not o.startswith("datastore.datastore_root_dir=")]
    argv = ["--device", "cpu", "--config-name", "default", "--raw_data", str(root / "corpus.jsonl"),
            "--registry", "", "--port", str(find_free_port()), *fresh,
            f"datastore.datastore_root_dir={tmp_path}/scaling_out", "serve.registry=null"]
    server = serve_main.main(argv, block=False)
    try:
        out = _post(server.port, "/search", {"queries": QUERIES[:2], "n_docs": 2})
    finally:
        server.shutdown()
    assert [len(r["IDs"]) for r in out["results"]] == [2, 2]
    assert list((tmp_path / "scaling_out" / "embeddings").rglob("passages_00.pkl"))


def test_microbatcher_batches_and_propagates_errors():
    seen = []

    def process(queries, n_docs):
        seen.append(len(queries))
        time.sleep(0.01)
        return [{"scores": [1.0] * n_docs, "passages": [q] * n_docs, "IDs": [[0, 0]] * n_docs} for q in queries]

    mb = MicroBatcher(process, max_batch=8, max_wait_ms=30.0)
    results = [None] * 6
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(f"q{i}", 2 + i % 2)))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    mb.shutdown()
    assert all(r["passages"][0] == f"q{i}" and len(r["scores"]) == 2 + i % 2 for i, r in enumerate(results))
    assert max(seen) > 1

    def fail(queries, n_docs):
        raise ValueError("boom")

    mb = MicroBatcher(fail, max_batch=2, max_wait_ms=1.0)
    with pytest.raises(ValueError):
        mb.submit("q", 1)
    mb.shutdown()


def test_config_from_env_matches_jax(monkeypatch):
    monkeypatch.setenv("RST_OVERRIDE_SERVE__GENERATION_SLOTS", "6")
    monkeypatch.setenv("RST_OVERRIDE_DATASTORE__INDEX__PROBE", "[1, 2]")
    ours = pconfig.config_from_env(pconfig.load_config("serving")).to_dict()
    theirs = jconfig.config_from_env(jconfig.load_config("serving")).to_dict()
    assert ours == theirs and ours["serve"]["generation_slots"] == 6


def test_tensor_parallel_generation_raises():
    cfg = pconfig.load_config("serving", overrides=["serve.generation_model=reader",
                                                    "serve.generation_tensor_parallel=2"])
    with pytest.raises(NotImplementedError):
        serve_worker_from_config(cfg, CPU)
