"""Port parity: the rest of the offline pipeline, all host code.

BM25 (search/bm25.py, utils/porter.py, the sparse branches of
pipeline/index_build.py and search/driver.py), the multi-source merge and
post-processing (search/postprocess.py, utils/deduplication.py,
utils/retrieval_paths.py, the multi-source branch of search/driver.py and
``tasks.eval.merge_search``) and the perplexity variants
(utils/decontamination.py, ``build_doc_prompts`` with decontamination and
continuation, ``evaluate_calibration``). The same inputs, made from a seed,
go through both packages. Host outputs are equal: strings, ids and files
byte for byte. The calibration losses of the tiny f32 reader agree to 1e-4
relative, the tolerance of ``test_perplexity_matches``.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from helpers import make_word_tokenizer, write_corpus_jsonl
from retrieval_scaling_tpu import config as jconfig
from retrieval_scaling_tpu.evals import perplexity as jppl
from retrieval_scaling_tpu.pipeline.main import main as jax_main
from retrieval_scaling_tpu.pipeline.main import run_tasks as jax_run_tasks
from retrieval_scaling_tpu.search import bm25 as jbm25
from retrieval_scaling_tpu.search import driver as jdriver
from retrieval_scaling_tpu.search import postprocess as jpost
from retrieval_scaling_tpu.utils import decontamination as jdecon
from retrieval_scaling_tpu.utils import deduplication as jdedup
from retrieval_scaling_tpu.utils import porter as jporter
from retrieval_scaling_tpu.utils import retrieval_paths as jpaths
from retrieval_scaling_tpu_torch import config as pconfig
from retrieval_scaling_tpu_torch.evals import perplexity as pppl
from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig
from retrieval_scaling_tpu_torch.models.hf_convert import params_from_jax
from retrieval_scaling_tpu_torch.pipeline import main as pmain
from retrieval_scaling_tpu_torch.search import bm25 as pbm25
from retrieval_scaling_tpu_torch.search import driver as pdriver
from retrieval_scaling_tpu_torch.search import postprocess as ppost
from retrieval_scaling_tpu_torch.utils import decontamination as pdecon
from retrieval_scaling_tpu_torch.utils import deduplication as pdedup
from retrieval_scaling_tpu_torch.utils import porter as pporter
from retrieval_scaling_tpu_torch.utils import retrieval_paths as ppaths

torch.set_num_threads(1)
CPU = torch.device("cpu")
WORDS = [f"{stem}{suffix}" for stem in ("relat", "hop", "conflat", "digit", "form", "sens", "agre", "caress")
         for suffix in ("", "s", "ed", "ing", "ional", "ization", "ness", "ive", "iti", "ies", "ful", "ement")]


def _read(path):
    with open(path) as f:
        return f.read()


# ---------------------------------------------------------------- BM25
def test_porter_and_analyzer_copies_match():
    rng = np.random.RandomState(0)
    letters = list("aeiouybcdlmnrstz")
    words = WORDS + ["".join(rng.choice(letters, rng.randint(1, 12))) for _ in range(300)]
    assert [pporter.porter_stem(w) for w in words] == [jporter.porter_stem(w) for w in words]
    text = " ".join(rng.choice(words, 200)) + " The Conflated, operators; are HOPPING 42x"
    assert pbm25.analyze(text) == jbm25.analyze(text)
    assert pbm25.ANALYZER_VERSION == jbm25.ANALYZER_VERSION


@pytest.fixture(scope="module")
def offline_env(tmp_path_factory):
    """A corpus, a perplexity eval set and a tokenizer directory shared by
    both packages' CLIs."""
    root = tmp_path_factory.mktemp("torch_offline")
    corpus = write_corpus_jsonl(str(root / "corpus.jsonl"), num_docs=24, words_per_doc=48)
    eval_path = str(root / "eval.jsonl")
    rng = np.random.RandomState(7)
    with open(eval_path, "w") as f:
        for _ in range(2):
            f.write(json.dumps({"text": " ".join(rng.choice([f"word{i}" for i in range(200)], size=80))}) + "\n")
    texts = []
    for p in (corpus, eval_path):
        with open(p) as f:
            texts.extend(json.loads(line)["text"] for line in f)
    tokenizer = make_word_tokenizer(texts)
    tok_dir = str(root / "tokenizer")
    tokenizer.save_pretrained(tok_dir)
    return root, corpus, eval_path, tok_dir, tokenizer


def _overrides(root, corpus, eval_path, tok_dir):
    return [
        "datastore.domain=testdomain", "evaluation.domain=testeval", f"datastore.raw_data_path={corpus}",
        f"datastore.datastore_root_dir={root}/scaling_out", "datastore.chunk_size=16",
        "datastore.embedding.num_shards=2", "datastore.embedding.shard_ids=[0,1]",
        "datastore.index.index_shard_ids=[0,1]", f"evaluation.data.eval_data={eval_path}",
        "evaluation.data.max_eval_data_seq_length=32", "evaluation.data.eval_stride=16",
        "evaluation.search.n_docs=5", f"evaluation.results_only_log_file={root}/results.log",
        "tasks.eval.task_name=perplexity", f"model.lm_model={tok_dir}", "model.sparse_retriever=bm25",
        "tasks.datastore.embedding=false", "tasks.datastore.index=true", "tasks.eval.search=true",
        "tasks.eval.inference=false",
    ]


def test_bm25_cli_route_matches_the_jax_cli(offline_env):
    """pipeline.main with model.sparse_retriever=bm25 in each package: the
    same index files and the same results file, and each package's index
    loaded by the other ranks alike."""
    root, corpus, eval_path, tok_dir, _ = offline_env
    outs = {}
    for name, run in (("jax", jax_main), ("port", lambda argv: pmain.main(["--device", "cpu"] + argv))):
        overrides = _overrides(root / name, corpus, eval_path, tok_dir)
        run(["--config-name", "default"] + overrides)
        cfg = pconfig.load_config("default", overrides=overrides)
        index_dir = pbm25.get_bm25_index_dir(cfg, [0, 1])
        outs[name] = (index_dir, pdriver.get_search_output_path(cfg, [0, 1]))
    (j_dir, j_out), (p_dir, p_out) = outs["jax"], outs["port"]
    assert _read(p_out) == _read(j_out)
    rows = [json.loads(line) for line in _read(p_out).splitlines()]
    assert any(r["ctxs"] and r["ctxs"][0] is not None for r in rows)
    assert _read(os.path.join(p_dir, "bm25_docs.jsonl")) == _read(os.path.join(j_dir, "bm25_docs.jsonl"))
    j_npz, p_npz = np.load(os.path.join(j_dir, "bm25_index.npz")), np.load(os.path.join(p_dir, "bm25_index.npz"))
    assert sorted(j_npz.files) == sorted(p_npz.files)
    for key in j_npz.files:
        np.testing.assert_array_equal(p_npz[key], j_npz[key], err_msg=key)
    query = rows[-1]["raw_query"]
    j_loads_p = jbm25.BM25Index.load(os.path.join(p_dir, "bm25_index.npz")).search(query, 7)
    p_loads_j = pbm25.BM25Index.load(os.path.join(j_dir, "bm25_index.npz")).search(query, 7)
    for s, i in (j_loads_p, p_loads_j):
        np.testing.assert_array_equal(i, p_loads_j[1])
        np.testing.assert_array_equal(s, p_loads_j[0])


def test_bm25_searcher_options_match():
    rng = np.random.RandomState(1)
    texts = [" ".join(rng.choice(WORDS, 12)) for _ in range(20)]
    raw = [json.dumps({"text": t, "input_ids": list(range(i, i + 3))}) for i, t in enumerate(texts)]
    searchers = [mod.BM25Searcher(mod.BM25Index.build(texts), raw) for mod in (jbm25, pbm25)]
    for kw in (dict(), dict(continuation=True), dict(shift=True), dict(shift=True, continuation=True),
               dict(raw_only=False, continuation=True)):
        for q in texts[:4]:
            assert searchers[1].search(q, 5, **kw) == searchers[0].search(q, 5, **kw)


# ---------------------------------------------------------------- post-processing
def test_dedup_and_decontamination_copies_match():
    rng = np.random.RandomState(2)
    base = [" ".join(rng.choice(WORDS, 30)) for _ in range(6)]
    docs = [{"retrieval text": t} for t in base + [base[1] + " extra", base[3], "too short to shingle"]]
    query = base[4]
    for kw in (dict(), dict(string_for_decontamination=query)):
        ours = pdedup.remove_duplicates_with_minhash([dict(d) for d in docs], **kw)
        theirs = jdedup.remove_duplicates_with_minhash([dict(d) for d in docs], **kw)
        assert ours == theirs and len(ours) < len(docs)
    data = [{"raw_query": query, "ctxs": [dict(d) for d in docs]} for _ in range(5)]
    assert pdedup.multiprocess_deduplication([dict(ex, ctxs=[dict(c) for c in ex["ctxs"]]) for ex in data],
                                             processes=2) == \
        jdedup.multiprocess_deduplication([dict(ex, ctxs=[dict(c) for c in ex["ctxs"]]) for ex in data], processes=2)
    gold = base[2][:80]
    for doc in (base[2], base[0], base[2][40:] + " " + base[5]):
        for threshold, mode in ((32, "longest"), (3, "longest"), (0.5, "longest"), (0.2, "jaccard"), (1, "longest")):
            assert pdecon.check_below_lexical_overlap_threshold(doc, gold, threshold, mode) == \
                jdecon.check_below_lexical_overlap_threshold(doc, gold, threshold, mode)


def test_retrieval_paths_copy_matches(tmp_path):
    domains = {"wiki": (2, 256), "books": (1, 512)}
    for mod, name in ((jpaths, "jax"), (ppaths, "port")):
        for domain, (shards, chunk) in domains.items():
            path = mod.merged_result_path(str(tmp_path), "enc", domain, chunk, shards, 10, "e.jsonl",
                                          [[i] for i in range(shards)])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write("{}\n")
        mod.write_retrieval_paths(str(tmp_path / f"{name}.txt"), str(tmp_path), "enc", "e.jsonl", domains, n_docs=10)
    assert _read(tmp_path / "port.txt") == _read(tmp_path / "jax.txt")


def _results(path, domain, queries, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for qi, query in enumerate(queries):
            ctxs = []
            for c in range(6):
                words = rng.choice(WORDS, 20 if c else 8)  # one chunk too short to keep
                text = " ".join(words) + (" answer%d" % qi if c % 2 else "")
                ctxs.append({"id": [0, c], "retrieval text": text, "retrieval score": str(float(rng.rand() * 10))})
            if qi == 1:  # a near duplicate of the first ctx
                ctxs[3]["retrieval text"] = ctxs[1]["retrieval text"] + " more"
            f.write(json.dumps({"raw_query": query, "ctxs": ctxs if qi != 2 else [None]}) + "\n")
    return path


@pytest.fixture(scope="module")
def merge_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_merge")
    rng = np.random.RandomState(3)
    queries = [" ".join(rng.choice(WORDS, 15)) for _ in range(3)]
    paths = [_results(str(root / f"{d}_datastore" / "r.jsonl"), d, queries, rng) for d in ("wiki", "books")]
    with open(root / "paths.txt", "w") as f:
        f.write("\n".join(paths) + "\n")
    answers = str(root / "answers.jsonl")
    with open(answers, "w") as f:
        for qi, query in enumerate(queries):
            f.write(json.dumps({"query": query, "answer": [f"answer{qi}"] if qi else f"answer{qi}"}) + "\n")
    return root, answers


def _merge_cfg(config_mod, root, out_dir, method, answers):
    search = {
        "paths_to_merge": str(root / "paths.txt"), "merged_path": str(out_dir / "dedup_merged.jsonl"),
        "n_docs": 8, "topk_subsample_p": 0.5, "subsample_seed": 11, "use_saved_dedup_data": False,
        "rerank_method": method, "answer_path": answers, "rerank_n_docs": 3,
    }
    return config_mod.config_from_dict({"tasks": {"eval": {"task_name": "lm-eval"}}, "evaluation": {"search": search}})


@pytest.mark.parametrize("method", [None, "inclusion", "unigram_f1", "lexical"])
def test_multi_domain_merge_matches_the_jax_files(merge_inputs, tmp_path, method):
    """post_hoc_merge_topk_multi_domain, seeded coin flips: every file it
    writes (merged, deduplicated, subsampled + reranked) is byte-equal."""
    root, answers = merge_inputs
    for name, mod, config_mod in (("jax", jpost, jconfig), ("port", ppost, pconfig)):
        mod.post_hoc_merge_topk_multi_domain(_merge_cfg(config_mod, root, tmp_path / name, method, answers))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for file in names:
        assert _read(tmp_path / "port" / file) == _read(tmp_path / "jax" / file), file
    final = [json.loads(line) for line in _read(tmp_path / "port" / [n for n in names if "full" in n][0]).splitlines()]
    assert all(len(ex["ctxs"]) <= 8 for ex in final) and any(ex["ctxs"] for ex in final)


def test_driver_runs_the_multi_source_merge_and_its_path(merge_inputs, tmp_path):
    """search_dense_topk's multi-source branch (result files present, so no
    search) and the subsampled output path, against the JAX driver."""
    root, answers = merge_inputs
    base = ["datastore.domain=d", "evaluation.domain=e", "evaluation.data.eval_data=e.jsonl",
            "evaluation.results_only_log_file=r.log", "datastore.index.index_shard_ids=[0]",
            "evaluation.search.merge_multi_source_results=true", "evaluation.search.topk_subsample_p=0.5",
            f"evaluation.search.paths_to_merge={root}/paths.txt", "evaluation.search.rerank_method=inclusion",
            f"evaluation.search.answer_path={answers}", "tasks.eval.task_name=lm-eval"]
    for name, config_mod, search in (("jax", jconfig, lambda c: jdriver.search_dense_topk(c)),
                                     ("port", pconfig, lambda c: pdriver.search_dense_topk(c, CPU))):
        cfg = config_mod.load_config("default", overrides=base + [
            f"datastore.datastore_root_dir={tmp_path / name}",
            f"evaluation.search.merged_path={tmp_path / name / 'm' / 'dedup_merged.jsonl'}"])
        group_file = jdriver.get_search_output_path(cfg, [0])
        os.makedirs(os.path.dirname(group_file))
        with open(group_file, "w") as f:
            f.write("{}\n")
        search(cfg)
    assert sorted(os.listdir(tmp_path / "port" / "m")) == sorted(os.listdir(tmp_path / "jax" / "m"))
    for file in os.listdir(tmp_path / "jax" / "m"):
        assert _read(tmp_path / "port" / "m" / file) == _read(tmp_path / "jax" / "m" / file)
    for p in (None, 0.5):
        cfg = pconfig.load_config("default", overrides=base[:5] + [f"evaluation.search.topk_subsample_p={p}"])
        jcfg = jconfig.load_config("default", overrides=base[:5] + [f"evaluation.search.topk_subsample_p={p}"])
        assert pdriver.get_merged_subsampled_search_output_path(cfg) == \
            jdriver.get_merged_subsampled_search_output_path(jcfg)


# ---------------------------------------------------------------- perplexity variants
def _eval_rows(rng, n=5, k=4):
    rows = []
    for i in range(n):
        answer = " ".join(rng.choice(WORDS, 16))  # long enough for 13-word shingles
        query = " ".join(rng.choice(WORDS, 12))
        ctxs = []
        for c in range(k):
            text = " ".join(rng.choice(WORDS, 14))
            if c == 1:  # contaminated: holds the answer
                text = text + " " + answer
            ctxs.append({"retrieval text": text, "retrieval next text": " ".join(rng.choice(WORDS, 9)),
                         "retrieval score": str(float(k - c))})
        rows.append({"raw_inputs": query + " " + answer, "raw_query": query, "ctxs": ctxs if i != 3 else [None]})
    return rows


@pytest.mark.parametrize("variant", [
    {"decontamination": True, "contamination_threshold": 4},
    {"decontamination": True, "contamination_threshold": 0.5, "decontamination_method": "longest"},
    {"decontamination": True, "contamination_threshold": 0.1, "decontamination_method": "jaccard"},
    {"use_continuation": True},
    {"use_both_doc_and_continuation": True, "decontamination": True, "contamination_threshold": 4},
])
def test_doc_prompts_variants_match(variant):
    rows = _eval_rows(np.random.RandomState(4))
    tree = {"concate_k": 2, **variant}
    ours = pppl.build_doc_prompts(rows, pconfig.config_from_dict(tree))
    theirs = jppl.build_doc_prompts(rows, jconfig.config_from_dict(tree))
    assert ours == theirs
    if variant.get("decontamination"):
        plain = pppl.build_doc_prompts(rows, pconfig.config_from_dict({"concate_k": 2}))
        assert ours[0] != plain[0]  # the contaminated ctx was dropped


def _tiny_reader(tokenizer):
    """The config and init scales of tests/helpers.py's tiny reader, its
    weights drawn by numpy (jax.random compiles one program per shape)."""
    from retrieval_scaling_tpu.evals.perplexity import JaxReader
    from retrieval_scaling_tpu.models.gpt_neox import GPTNeoXConfig as JaxNeoXConfig
    from retrieval_scaling_tpu.models.gpt_neox import init_gpt_neox_params

    cfg = JaxNeoXConfig(vocab_size=tokenizer.vocab_size + 10, hidden_size=32, num_layers=2, num_heads=4,
                        intermediate_size=64, max_position_embeddings=128, attention_impl="xla")
    rng = np.random.RandomState(6)
    shapes = jax.eval_shape(lambda: init_gpt_neox_params(cfg, jax.random.PRNGKey(1)))

    def draw(path, leaf):
        name = str(path[-1])
        if "scale" in name:
            return np.ones(leaf.shape, np.float32)
        if name.endswith(("_b']", "bias']")):
            return np.zeros(leaf.shape, np.float32)
        return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    return JaxReader(jax.tree_util.tree_map_with_path(draw, shapes), cfg, tokenizer, batch_size=4,
                     dtype=np.float32)


def test_calibration_matches_jax(tmp_path):
    """evaluate_calibration through each package's reader (the tiny f32
    reader, its weights carried across): the min-loss mixture and every
    per-doc loss of calibration_losses.pkl."""
    rows = _eval_rows(np.random.RandomState(5), n=5)
    results = tmp_path / "results.jsonl"
    results.write_text("".join(json.dumps(r) + "\n" for r in rows))
    jreader = _tiny_reader(make_word_tokenizer([r["raw_inputs"] + " " + " ".join(
        c["retrieval text"] for c in r["ctxs"] if c) for r in rows]))
    rc = jreader.cfg
    neox = GPTNeoXConfig(
        vocab_size=rc.vocab_size, hidden_size=rc.hidden_size, num_layers=rc.num_layers, num_heads=rc.num_heads,
        intermediate_size=rc.intermediate_size, max_position_embeddings=rc.max_position_embeddings,
    )
    model = params_from_jax(jax.tree.map(np.asarray, jreader.params), neox)
    preader = pppl.TorchReader(model, jreader.tokenizer, CPU, batch_size=jreader.batch_size, dtype=torch.float32)
    overrides = lambda out: [  # noqa: E731
        "datastore.domain=d", "evaluation.domain=e", "evaluation.data.eval_data=e.jsonl",
        "evaluation.results_only_log_file=r.log", "tasks.eval.task_name=perplexity_calibration",
        "evaluation.concate_k=3", f"evaluation.search.merged_path={results}", f"evaluation.calibration_out_dir={out}",
    ]
    theirs = jppl.evaluate_perplexity(jconfig.load_config("default", overrides=overrides(tmp_path / "jax")), reader=jreader)
    ours = pppl.evaluate_perplexity(pconfig.load_config("default", overrides=overrides(tmp_path / "port")), CPU, reader=preader)
    np.testing.assert_allclose(ours.average_loss, theirs.average_loss, rtol=1e-4)
    np.testing.assert_allclose(ours.perplexity, theirs.perplexity, rtol=1e-4)
    with open(tmp_path / "jax" / "calibration_losses.pkl", "rb") as f:
        j_by = pickle.load(f)
    with open(tmp_path / "port" / "calibration_losses.pkl", "rb") as f:
        p_by = pickle.load(f)
    assert sorted(p_by) == sorted(j_by) == list(range(len(rows) - 1))
    for key in j_by:
        assert [s for _, s in p_by[key]] == [s for _, s in j_by[key]]
        np.testing.assert_allclose([loss for loss, _ in p_by[key]], [loss for loss, _ in j_by[key]], rtol=1e-4)


def test_inference_task_names_match_jax(offline_env):
    """Only perplexity and perplexity_calibration run in the pipeline; other
    task names raise in both packages, before any stage runs."""
    root, corpus, eval_path, tok_dir, _ = offline_env
    overrides = _overrides(root / "tasks", corpus, eval_path, tok_dir) + [
        "tasks.eval.task_name=mmlu", "tasks.eval.inference=true", "tasks.datastore.index=false",
        "tasks.eval.search=false"]
    with pytest.raises(ValueError):
        jax_run_tasks(jconfig.load_config("default", overrides=overrides))
    with pytest.raises(ValueError):
        pmain.run_tasks(pconfig.load_config("default", overrides=overrides), CPU)
