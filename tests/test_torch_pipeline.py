"""Port parity: the slice end to end, the host-module copies, the CLI, imports.

The quick-start flow of tests/test_end_to_end.py runs twice on the same
corpus: once through the JAX package and once through the port, with the
same tiny f32 encoder and reader carried across by ``params_from_jax``.
Both must write the same passages, embeddings (fp16), retrieved ids and
perplexity.
"""

import json
import math
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from helpers import make_word_tokenizer, tiny_encoder, tiny_reader, write_corpus_jsonl
from retrieval_scaling_tpu import config as jconfig
from retrieval_scaling_tpu.data import chunking as jchunking
from retrieval_scaling_tpu.data.passages import PassageStore as JaxPassageStore
from retrieval_scaling_tpu.evals.perplexity import evaluate_perplexity as jax_evaluate_perplexity
from retrieval_scaling_tpu.pipeline.embed import generate_passage_embeddings as jax_embed
from retrieval_scaling_tpu.pipeline.index_build import build_dense_index as jax_build_index
from retrieval_scaling_tpu.search.driver import get_merged_search_output_path, search_dense_topk as jax_search
from retrieval_scaling_tpu_torch import config as pconfig
from retrieval_scaling_tpu_torch.data import chunking as pchunking
from retrieval_scaling_tpu_torch.data.passages import PassageStore
from retrieval_scaling_tpu_torch.device import resolve_device
from retrieval_scaling_tpu_torch.evals.perplexity import TorchReader, evaluate_perplexity
from retrieval_scaling_tpu_torch.models.bert import BertConfig
from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig
from retrieval_scaling_tpu_torch.models.hf_convert import params_from_jax, save_hf_checkpoint
from retrieval_scaling_tpu_torch.pipeline import main as pmain
from retrieval_scaling_tpu_torch.pipeline.embed import generate_passage_embeddings
from retrieval_scaling_tpu_torch.pipeline.index_build import build_dense_index
from retrieval_scaling_tpu_torch.search.driver import search_dense_topk
from retrieval_scaling_tpu_torch.search.encoder import TorchEncoder

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _overrides(root, corpus, eval_path):
    return [
        "datastore.domain=testdomain",
        "evaluation.domain=testeval",
        f"datastore.raw_data_path={corpus}",
        f"datastore.datastore_root_dir={root}/scaling_out",
        "datastore.chunk_size=16",
        "datastore.embedding.num_shards=2",
        "datastore.embedding.shard_ids=[0,1]",
        "datastore.index.index_shard_ids=[[0],[1]]",
        f"evaluation.data.eval_data={eval_path}",
        "evaluation.data.max_eval_data_seq_length=32",
        "evaluation.data.eval_stride=16",
        "evaluation.search.n_docs=4",
        "evaluation.concate_k=2",
        f"evaluation.results_only_log_file={root}/results.log",
        "tasks.eval.task_name=perplexity",
    ]


def _port_models(jenc, jreader, tokenizer):
    ec, rc = jenc.cfg, jreader.cfg
    bert = BertConfig(
        vocab_size=ec.vocab_size, hidden_size=ec.hidden_size, num_layers=ec.num_layers,
        num_heads=ec.num_heads, intermediate_size=ec.intermediate_size,
        max_position_embeddings=ec.max_position_embeddings, pooling=ec.pooling,
    )
    neox = GPTNeoXConfig(
        vocab_size=rc.vocab_size, hidden_size=rc.hidden_size, num_layers=rc.num_layers,
        num_heads=rc.num_heads, intermediate_size=rc.intermediate_size,
        max_position_embeddings=rc.max_position_embeddings,
    )
    enc = params_from_jax(jax.tree.map(np.asarray, jenc.params), bert)
    reader = params_from_jax(jax.tree.map(np.asarray, jreader.params), neox)
    return (
        TorchEncoder(enc, tokenizer, CPU, dtype=torch.float32),
        TorchReader(reader, tokenizer, CPU, batch_size=jreader.batch_size, dtype=torch.float32),
    )


@pytest.fixture(scope="module")
def tiny_models(tmp_path_factory):
    """Corpus, eval data, tokenizer and the tiny models of both packages."""
    root = tmp_path_factory.mktemp("torch_e2e")
    corpus = write_corpus_jsonl(str(root / "corpus.jsonl"), num_docs=40, words_per_doc=60)
    eval_path = str(root / "eval.jsonl")
    rng = np.random.RandomState(7)
    with open(eval_path, "w") as f:
        for _ in range(3):
            f.write(json.dumps({"text": " ".join(rng.choice([f"word{i}" for i in range(200)], size=120))}) + "\n")
    texts = []
    for p in (corpus, eval_path):
        with open(p) as f:
            texts.extend(json.loads(line)["text"] for line in f)
    tokenizer = make_word_tokenizer(texts)
    jenc, jreader = tiny_encoder(tokenizer), tiny_reader(tokenizer)
    penc, preader = _port_models(jenc, jreader, tokenizer)
    return root, corpus, eval_path, tokenizer, jenc, jreader, penc, preader


@pytest.fixture(scope="module")
def both_runs(tiny_models):
    root, corpus, eval_path, tokenizer, jenc, jreader, penc, preader = tiny_models
    jcfg = jconfig.load_config("default", overrides=_overrides(root / "jax", corpus, eval_path))
    jax_embed(jcfg, encoder=jenc)
    jax_build_index(jcfg)
    jax_search(jcfg, encoder=jenc, tokenizer=tokenizer)
    jax_ppl = jax_evaluate_perplexity(jcfg, reader=jreader)

    pcfg = pconfig.load_config("default", overrides=_overrides(root / "port", corpus, eval_path))
    generate_passage_embeddings(pcfg, CPU, encoder=penc)
    build_dense_index(pcfg, CPU)
    search_dense_topk(pcfg, CPU, encoder=penc, tokenizer=tokenizer)
    port_ppl = evaluate_perplexity(pcfg, CPU, reader=preader)
    return jcfg, pcfg, jax_ppl, port_ppl


def test_embedding_pickles_match(both_runs):
    jcfg, pcfg, _, _ = both_runs
    for shard in (0, 1):
        name = f"passages_{shard:02d}.pkl"
        with open(os.path.join(jcfg.datastore.embedding.embedding_dir, name), "rb") as f:
            jids, jemb = pickle.load(f)
        with open(os.path.join(pcfg.datastore.embedding.embedding_dir, name), "rb") as f:
            pids, pemb = pickle.load(f)
        assert list(pids) == list(jids)
        assert pemb.dtype == np.float16 and pemb.shape == jemb.shape
        np.testing.assert_allclose(pemb.astype(np.float32), jemb.astype(np.float32), atol=1e-3)


def test_passage_caches_and_retrieved_ids_match(both_runs):
    jcfg, pcfg, _, _ = both_runs
    for shard in (0, 1):  # data/sharding.py + data/chunking.py copies
        name = f"raw_passages-{shard}-of-2.jsonl"
        with open(os.path.join(jcfg.datastore.embedding.passages_dir, name)) as f:
            jax_text = f.read()
        with open(os.path.join(pcfg.datastore.embedding.passages_dir, name)) as f:
            assert f.read() == jax_text
    with open(get_merged_search_output_path(jcfg)) as f:
        jrows = [json.loads(line) for line in f]
    with open(get_merged_search_output_path(pcfg)) as f:
        prows = [json.loads(line) for line in f]
    assert len(prows) == len(jrows) and any(r["ctxs"] for r in prows)
    for p, j in zip(prows, jrows):  # data/eval_data.py copy: same windows
        assert (p["raw_inputs"], p["raw_query"]) == (j["raw_inputs"], j["raw_query"])
        assert [c["id"] for c in p["ctxs"]] == [c["id"] for c in j["ctxs"]]
        assert [c["retrieval text"] for c in p["ctxs"]] == [c["retrieval text"] for c in j["ctxs"]]
        np.testing.assert_allclose(
            [float(c["retrieval score"]) for c in p["ctxs"]],
            [float(c["retrieval score"]) for c in j["ctxs"]], rtol=1e-3, atol=1e-3,
        )


def test_perplexity_matches(both_runs):
    _, _, jax_ppl, port_ppl = both_runs
    assert math.isfinite(port_ppl.perplexity)
    np.testing.assert_allclose(port_ppl.perplexity, jax_ppl.perplexity, rtol=1e-4)
    np.testing.assert_allclose(port_ppl.average_loss, jax_ppl.average_loss, rtol=1e-4)
    assert port_ppl.no_enough_docs_count == jax_ppl.no_enough_docs_count


def test_passage_store_copy_matches(both_runs):
    _, pcfg, _, _ = both_runs
    psg_dir = pcfg.datastore.embedding.passages_dir
    pairs = [(1, 3), (0, 0), (1, 0), (0, 7), (0, 3)]
    ours = PassageStore.from_passages_dir(psg_dir)
    theirs = JaxPassageStore.from_passages_dir(psg_dir)
    assert ours.fetch_many(pairs) == theirs.fetch_many(pairs)


def test_config_copy_matches():
    overrides = [
        "datastore.raw_data_path=x.jsonl", "datastore.domain=d", "evaluation.domain=e",
        "evaluation.data.eval_data=e.jsonl", "evaluation.results_only_log_file=r.log",
        "evaluation.search.n_docs=5", "datastore.index.index_shard_ids=[[0],[1]]",
    ]
    for name in ("example_config", "ivf_pq"):
        ours = pconfig.load_config(name, overrides=overrides).to_dict(resolve=True)
        theirs = jconfig.load_config(name, overrides=overrides).to_dict(resolve=True)
        assert ours == theirs
        # the YAML-free path: the same tree given as a dict
        tree = jconfig.load_config(name).to_dict()
        assert pconfig.config_from_dict(tree, overrides=overrides).to_dict(resolve=True) == theirs


@pytest.mark.parametrize("strategy,chunk,min_chunk,keep_last", [
    ("fixed_size", 7, 0, True), ("fixed_size", 7, 4, True), ("fixed_size", 5, 0, False),
    ("semantic", 12, 0, True), (None, 7, 0, True),
])
def test_chunking_copy_matches(strategy, chunk, min_chunk, keep_last):
    rng = np.random.RandomState(4)
    words = [f"w{i}" for i in range(50)] + ["end.", "stop!", "\n\n"]
    for _ in range(5):
        text = " ".join(rng.choice(words, size=rng.randint(1, 60)))
        assert pchunking.split_text_into_chunks(text, chunk, min_chunk, keep_last, strategy) == \
            jchunking.split_text_into_chunks(text, chunk, min_chunk, keep_last, strategy)


def test_text_normalize_copy_matches():
    from retrieval_scaling_tpu.utils import text_normalize as jnorm
    from retrieval_scaling_tpu_torch.utils import text_normalize as pnorm

    for text in ["  Caf\u00e9 \u2014 \u201cquoted\u201d \u2018x\u2019\n\tna\u0308ive  ", "\u00ab\u00bb \u2010\u2015 `a\u00b4", ""]:
        assert pnorm.normalize(text) == jnorm.normalize(text)
        assert pnorm.strip_accents(text) == jnorm.strip_accents(text)


def test_ivfpq_cli_route_matches_the_jax_cli(both_runs, tiny_models, tmp_path):
    """One tiny IVF-PQ index + search run through each package's CLI on the
    same embedding shards and cached query embeddings. PQ training draws
    differ between the packages, so the refine tier re-ranks every probed row
    by its exact int8 score (probe = all lists, refine_factor * n_docs > rows):
    then both must retrieve the same ids."""
    from retrieval_scaling_tpu.pipeline.main import main as jax_main
    from retrieval_scaling_tpu_torch.data.eval_data import load_eval_data
    from retrieval_scaling_tpu_torch.search.driver import embed_eval_queries
    from retrieval_scaling_tpu_torch.search.driver import get_merged_search_output_path as port_merged_path

    _, pcfg, _, _ = both_runs
    _, corpus, eval_path, tokenizer, _, _, penc, _ = tiny_models
    tok_dir = str(tmp_path / "tokenizer")
    tokenizer.save_pretrained(tok_dir)
    q_cache = str(tmp_path / "query_embeddings.pkl")
    cache = ["evaluation.search.cache_query_embedding=true", f"evaluation.search.query_embedding_save_path={q_cache}"]
    queries = [ex["raw_query"] for ex in load_eval_data(pcfg, tokenizer=tokenizer) if ex.get("raw_query")]
    qcfg = pconfig.load_config("default", overrides=_overrides(tmp_path / "q", corpus, eval_path) + cache)
    embed_eval_queries(qcfg, queries, CPU, encoder=penc)

    results = {}
    for name, run in (("jax", jax_main), ("port", lambda argv: pmain.main(["--device", "cpu"] + argv))):
        root = tmp_path / name
        emb_dir = root / "emb"
        emb_dir.mkdir(parents=True)
        for shard in (0, 1):
            src = os.path.join(pcfg.datastore.embedding.embedding_dir, f"passages_{shard:02d}.pkl")
            with open(src, "rb") as f_in, open(emb_dir / f"passages_{shard:02d}.pkl", "wb") as f_out:
                f_out.write(f_in.read())
        overrides = _overrides(root, corpus, eval_path) + cache + [
            "tasks.datastore.index=true", "tasks.eval.search=true",
            f"datastore.embedding.embedding_dir={emb_dir}",
            f"datastore.embedding.passages_dir={pcfg.datastore.embedding.passages_dir}",
            f"model.lm_model={tok_dir}", f"model.query_tokenizer={tok_dir}",
            "datastore.index.index_type=IVFPQ", "datastore.index.ncentroids=4", "datastore.index.probe=4",
            "datastore.index.sample_train_size=200", "datastore.index.projection_size=32",
            "datastore.index.n_subquantizers=8", "datastore.index.n_bits=4", "datastore.index.pq_refine_factor=64",
        ]
        run(["--config-name", "default"] + overrides)
        cfg = pconfig.load_config("default", overrides=overrides)
        with open(port_merged_path(cfg)) as f:
            results[name] = [json.loads(line) for line in f]
        assert os.path.exists(os.path.join(emb_dir, "index_IVFPQ", "0", "index_IVFPQ.200.32.4.tpu.refine.bin"))
    assert len(results["port"]) == len(results["jax"]) and any(r["ctxs"] for r in results["port"])
    for p, j in zip(results["port"], results["jax"]):
        assert [c["id"] for c in p["ctxs"]] == [c["id"] for c in j["ctxs"]]
        assert [c["retrieval text"] for c in p["ctxs"]] == [c["retrieval text"] for c in j["ctxs"]]


def test_cli_runs_the_slice_from_checkpoints(tmp_path):
    """``python -m retrieval_scaling_tpu_torch.pipeline.main`` on HF-layout
    checkpoints written by the port, in the port's default bf16."""
    corpus = write_corpus_jsonl(str(tmp_path / "corpus.jsonl"), num_docs=12, words_per_doc=40)
    with open(corpus) as f:
        texts = [json.loads(line)["text"] for line in f]
    tokenizer = make_word_tokenizer(texts)
    jenc, jreader = tiny_encoder(tokenizer), tiny_reader(tokenizer)
    penc, preader = _port_models(jenc, jreader, tokenizer)
    enc_dir, reader_dir = str(tmp_path / "contriever-tiny"), str(tmp_path / "pythia-tiny")
    for path, model in ((enc_dir, penc.model), (reader_dir, preader.model)):
        save_hf_checkpoint(model, path)
        tokenizer.save_pretrained(path)
    argv = ["--config-name", "example_config", "--device", "cpu"] + [
        f"datastore.raw_data_path={corpus}",
        f"datastore.datastore_root_dir={tmp_path}/scaling_out",
        "datastore.chunk_size=16",
        f"model.datastore_encoder={enc_dir}", f"model.datastore_tokenizer={enc_dir}",
        f"model.query_encoder={enc_dir}", f"model.query_tokenizer={enc_dir}",
        f"model.lm_model={reader_dir}",
        f"evaluation.data.eval_data={corpus}",
        "evaluation.data.max_eval_data_seq_length=32",
        "evaluation.data.eval_stride=16",
        f"evaluation.results_only_log_file={tmp_path}/results.log",
    ]
    out = pmain.main(argv)
    assert set(out["stage_seconds"]) == {"embedding", "index", "search", "inference"}
    assert math.isfinite(out["ppl"].perplexity)
    with open(tmp_path / "results.log") as f:
        assert f.read() == out["ppl"].log_message() + "\n"


def test_cuda_is_never_chosen_implicitly():
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import retrieval_scaling_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import torch_ablate_decode, torch_ablate_launch_overhead, torch_profile_decode_gap\n"
        "for name in ('ops.ivf_gather', 'ops.kmeans', 'index.ivf_common', 'index.ivf_flat',\n"
        "             'index.ivf_pq', 'data.native_io', 'ops.quant_matmul', 'models.generate',\n"
        "             'models.continuous_batching', 'serve.engine', 'serve.generation',\n"
        "             'serve.http_server', 'serve.__main__', 'rag_eval.models', 'models.t5',\n"
        "             'utils.text_normalize', 'search.encoder', 'ops.fused_scan', 'search.bm25',\n"
        "             'search.postprocess', 'utils.porter', 'utils.deduplication',\n"
        "             'utils.decontamination', 'utils.retrieval_paths', 'models.speculative',\n"
        "             'ops.decode_probes'):\n"
        "    assert 'retrieval_scaling_tpu_torch.' + name in sys.modules, name\n"
        "bad = sorted(m for m, mod in sys.modules.items()\n"
        "             if mod is not None and m.split('.')[0] in ('jax', 'jaxlib', 'retrieval_scaling_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
