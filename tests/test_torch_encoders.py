"""Port parity: the encoder extras (packed rows, the int8 FFN, the GTR-T5 and
llama-family encoders, the family dispatch of ``load_encoder``).

The same numpy inputs and weights go through the JAX package and the port,
in f32 on the CPU. Tolerances:
  * ``quantize_bert_params``: int8 bytes and f32 scales equal;
  * a whole int8 or packed encoder against the JAX one: 1e-5 (f32, sums in
    another order; embeddings rounded to fp16 at the end: one fp16 ulp);
  * packed against bucketed embeddings: row cosine > 0.999, int8 against
    float: > 0.995 (tests/test_models.py:283, tests/test_quant_matmul.py:143);
  * T5 against HF ``T5EncoderModel``: tests/test_t5.py's 3e-4 / 3e-3; against
    JAX ``t5_encode``: 2e-5.
The kernels themselves (K2s, K10) are checked on the card by the ``cuda``
tests of tests/test_torch_flash_attention.py and test_torch_quant_matmul.py.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from helpers import make_word_tokenizer, tiny_encoder, write_corpus_jsonl
from retrieval_scaling_tpu.models import bert as jbert
from retrieval_scaling_tpu.models import llama as jl
from retrieval_scaling_tpu.models import t5 as jt5
from retrieval_scaling_tpu.search import encoder as jenc_mod
from retrieval_scaling_tpu_torch.models import bert as pbert
from retrieval_scaling_tpu_torch.models import hf_convert as phc
from retrieval_scaling_tpu_torch.models import t5 as pt5
from retrieval_scaling_tpu_torch.models.llama import LlamaConfig
from retrieval_scaling_tpu_torch.search import encoder as penc_mod

torch.set_num_threads(1)
CPU = torch.device("cpu")
WORDS = [f"w{i}" for i in range(60)]


def _cos(a, b):
    a, b = a.astype(np.float32), b.astype(np.float32)
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-9)


def _texts(seed, n, lo=3, hi=20):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(lo, hi))) for _ in range(n)]


def _bert_cfg(jcfg):
    return pbert.BertConfig(
        vocab_size=jcfg.vocab_size, hidden_size=jcfg.hidden_size, num_layers=jcfg.num_layers,
        num_heads=jcfg.num_heads, intermediate_size=jcfg.intermediate_size,
        max_position_embeddings=jcfg.max_position_embeddings, pooling=jcfg.pooling,
    )


@pytest.fixture(scope="module")
def tiny_bert():
    """tests/helpers.py's tiny encoder (f32) and its float and int8 port twins."""
    tok = make_word_tokenizer([" ".join(WORDS)])
    jenc = tiny_encoder(tok)
    tree = jax.tree.map(np.asarray, jenc.params)
    model = phc.params_from_jax(tree, _bert_cfg(jenc.cfg))
    return tok, jenc, tree, model


# ---------------------------------------------------------------- int8 FFN
def test_quantize_bert_params_bytes_equal(tiny_bert):
    _, jenc, tree, model = tiny_bert
    jq = jax.tree.map(np.asarray, jbert.quantize_bert_params(jenc.params))
    pq = pbert.quantize_bert_params(model)
    # mlp_out is stored once in K10's [N, K] layout: its transpose is the JAX [K, N] tree
    carried = phc.params_from_jax(jq, _bert_cfg(jenc.cfg))
    for ours in (pq, carried):
        for jl_, layer in zip(jq["layers"], ours.layers):
            for name, kn in (("mlp_in", lambda w: w), ("mlp_out", lambda w: w.t().contiguous())):
                lin = getattr(layer, name)
                assert lin.wq.dtype == torch.int8 and lin.scale.dtype == torch.float32 and lin.wq.is_contiguous()
                assert kn(lin.wq).numpy().tobytes() == jl_[name + "_wq"].tobytes()
                assert lin.scale.numpy().tobytes() == jl_[name + "_ws"].tobytes()
    # the float model is left as it was
    assert isinstance(model.layers[0].mlp_in, torch.nn.Linear)


def test_int8_encoder_matches_jax_and_tracks_float(tiny_bert):
    tok, jenc, _, model = tiny_bert
    texts = _texts(1, 9)
    opts = penc_mod.EncodeOptions(batch_size=4, maxlength=32)
    jopts = jenc_mod.EncodeOptions(batch_size=4, maxlength=32)
    jq = jenc_mod.JaxEncoder(jenc.params, jenc.cfg, tok, dtype=jnp.float32, quantize="int8")
    pq = penc_mod.TorchEncoder(model, tok, CPU, dtype=torch.float32, quantize="int8")
    assert isinstance(pq.model.layers[0].mlp_out, pbert.Int8Linear)
    got = pq.encode(texts, opts)
    np.testing.assert_allclose(got.astype(np.float32), jq.encode(texts, jopts).astype(np.float32), atol=1e-3, rtol=1e-3)
    ref = penc_mod.TorchEncoder(model, tok, CPU, dtype=torch.float32).encode(texts, opts)
    assert _cos(got, ref).min() > 0.995


# ---------------------------------------------------------------- packed rows
def test_pack_token_rows_layout_matches_jax():
    rng = np.random.RandomState(2)
    seqs = [list(rng.randint(3, 50, rng.randint(1, 30))) for _ in range(41)]
    ours = penc_mod.pack_token_rows(seqs, capacity=48, pad_id=0)
    theirs = jenc_mod.pack_token_rows(seqs, capacity=48, pad_id=0)
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_array_equal(a, b)
    assert ours[4] == theirs[4]


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_packed_encode_matches_jax_and_bucketed(tiny_bert, quantize):
    """Packed TorchEncoder.encode against packed JaxEncoder.encode (one fp16
    ulp) and against its own bucketed encode (cosine > 0.999), with the
    out_dim truncation and the normalisation of the packed route."""
    tok, jenc, _, model = tiny_bert
    texts = _texts(3, 23)
    jq = jenc_mod.JaxEncoder(jenc.params, jenc.cfg, tok, dtype=jnp.float32, quantize=quantize)
    pq = penc_mod.TorchEncoder(model, tok, CPU, dtype=torch.float32, quantize=quantize)
    for kw in (dict(), dict(out_dim=16, normalize_emb=True)):
        packed = pq.encode(texts, penc_mod.EncodeOptions(batch_size=4, maxlength=64, packed=True, **kw))
        jpacked = jq.encode(texts, jenc_mod.EncodeOptions(batch_size=4, maxlength=64, packed=True, **kw))
        np.testing.assert_allclose(packed.astype(np.float32), jpacked.astype(np.float32), atol=1e-3, rtol=1e-3)
        bucketed = pq.encode(texts, penc_mod.EncodeOptions(batch_size=4, maxlength=64, **kw))
        assert packed.shape == bucketed.shape == (23, kw.get("out_dim", 32))
        assert _cos(packed, bucketed).min() > 0.999


def test_packing_skip_rule_and_normalize_text(tiny_bert, caplog):
    """Mean length above 0.3 x maxlength takes the bucketed route (the JAX
    rule); normalize_text is the JAX normalizer."""
    tok, jenc, _, model = tiny_bert
    pq = penc_mod.TorchEncoder(model, tok, CPU, dtype=torch.float32)
    long_texts = _texts(4, 6, lo=12, hi=16)
    with caplog.at_level("INFO"):
        packed = pq.encode(long_texts, penc_mod.EncodeOptions(batch_size=4, maxlength=32, packed=True))
    assert "packing skipped" in caplog.text
    np.testing.assert_array_equal(packed, pq.encode(long_texts, penc_mod.EncodeOptions(batch_size=4, maxlength=32)))
    odd = ["w1  — w2 “w3”", "w4é w5"]
    opts = dict(batch_size=2, maxlength=16, normalize_text=True)
    np.testing.assert_allclose(pq.encode(odd, penc_mod.EncodeOptions(**opts)).astype(np.float32),
                               jenc.encode(odd, jenc_mod.EncodeOptions(**opts)).astype(np.float32), atol=1e-3)


def test_embed_cli_packed_int8_writes_the_jax_pickles(tiny_bert, tmp_path):
    """The embed stage of both CLIs on one BERT checkpoint directory with
    datastore.embedding.packing=true and quantization=int8: the same ids;
    both CLIs run the encoder in bf16 (their default), where the packages
    round at other places, so the embeddings agree within the bf16 envelope
    (2e-2, tests/test_ops.py) and to a row cosine > 0.999."""
    from retrieval_scaling_tpu import config as jconfig
    from retrieval_scaling_tpu.pipeline.main import main as jax_main
    from retrieval_scaling_tpu_torch.pipeline import main as pmain

    _, jenc, _, model = tiny_bert
    corpus = write_corpus_jsonl(str(tmp_path / "corpus.jsonl"), num_docs=10, words_per_doc=30)
    with open(corpus) as f:
        tok = make_word_tokenizer([line for line in f])
    enc_dir = str(tmp_path / "contriever-tiny")
    cfg = pbert.BertConfig(**{**_bert_cfg(jenc.cfg).__dict__, "vocab_size": tok.vocab_size + 10})
    phc.save_hf_checkpoint(pbert.init_bert_params(cfg, torch.Generator().manual_seed(0)), enc_dir)
    tok.save_pretrained(enc_dir)
    paths = {}
    for name, run in (("jax", jax_main), ("port", lambda argv: pmain.main(["--device", "cpu"] + argv))):
        overrides = [
            "datastore.domain=d", "evaluation.domain=e", f"datastore.raw_data_path={corpus}",
            f"datastore.datastore_root_dir={tmp_path}/{name}", "datastore.chunk_size=8",
            f"model.datastore_encoder={enc_dir}", f"model.datastore_tokenizer={enc_dir}",
            "datastore.embedding.packing=true", "datastore.embedding.quantization=int8",
            "datastore.embedding.passage_maxlength=64", "datastore.embedding.per_device_batch_size=4",
            "tasks.datastore.embedding=true", "tasks.datastore.index=false", "tasks.eval.search=false",
            "tasks.eval.inference=false", "evaluation.data.eval_data=e.jsonl", f"evaluation.results_only_log_file={tmp_path}/r.log",
        ]
        run(["--config-name", "default"] + overrides)
        cfg_ = jconfig.load_config("default", overrides=overrides)
        paths[name] = os.path.join(cfg_.datastore.embedding.embedding_dir, "passages_00.pkl")
    with open(paths["jax"], "rb") as f:
        jids, jemb = pickle.load(f)
    with open(paths["port"], "rb") as f:
        pids, pemb = pickle.load(f)
    assert pids == jids and pemb.dtype == jemb.dtype == np.float16 and len(pids) > 10
    np.testing.assert_allclose(pemb.astype(np.float32), jemb.astype(np.float32), atol=2e-2, rtol=2e-2)
    assert _cos(pemb, jemb).min() > 0.999


# ---------------------------------------------------------------- T5 (GTR)
@pytest.fixture(scope="module", params=[False, True], ids=["relu", "gated"])
def tiny_t5(request):
    cfg = transformers.T5Config(vocab_size=120, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                                relative_attention_num_buckets=8, relative_attention_max_distance=20,
                                feed_forward_proj="gated-gelu" if request.param else "relu")
    torch.manual_seed(4 + int(request.param))
    return transformers.T5EncoderModel(cfg).eval()


def test_t5_matches_hf_and_jax(tiny_t5):
    hf_dict = tiny_t5.config.to_dict()
    cfg = phc.t5_config_from_hf(hf_dict)
    model = phc.t5_encoder_params_from_state_dict(tiny_t5.state_dict(), cfg)
    from retrieval_scaling_tpu.models.hf_convert import t5_encoder_from_hf_model

    jparams, jcfg = t5_encoder_from_hf_model(tiny_t5)
    assert cfg == pt5.T5EncoderConfig(**jcfg.__dict__)
    rng = np.random.RandomState(5)
    ids = rng.randint(3, 120, (2, 30))
    mask = np.ones((2, 30), np.int64)
    mask[1, 19:] = 0
    ids[1, 19:] = 0
    with torch.no_grad():
        ref = tiny_t5(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state.numpy()
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jt5.t5_encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got[0], ref[0], atol=3e-4, rtol=3e-3)
    np.testing.assert_allclose(got[1, :19], ref[1, :19], atol=3e-4, rtol=3e-3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    # buckets past max_distance and both signs
    np.testing.assert_array_equal(pt5.relative_position_buckets(70, 90, 32, 128).numpy(),
                                  np.asarray(jt5.relative_position_buckets(70, 90, 32, 128)))


def test_t5_embed_with_projection_matches_jax(tiny_t5):
    rng = np.random.RandomState(6)
    proj = rng.randn(32, 16).astype(np.float32)
    from retrieval_scaling_tpu.models.hf_convert import t5_encoder_from_hf_model

    jparams, jcfg = t5_encoder_from_hf_model(tiny_t5, projection=proj)
    cfg = pt5.T5EncoderConfig(**jcfg.__dict__)
    model = phc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    ids = rng.randint(3, 120, (3, 12))
    mask = (np.arange(12)[None, :] < np.asarray([[12], [7], [3]])).astype(np.int64)
    with torch.no_grad():
        got = pt5.t5_embed(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jt5.t5_embed(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


# ---------------------------------------------------------------- load_encoder dispatch
def test_load_encoder_dispatches_t5_with_dense(tiny_t5, tmp_path, caplog):
    """model_type t5 -> GTR: the local 2_Dense projection, normalised; a
    directory without one warns and keeps the T5 space."""
    from retrieval_scaling_tpu.models.hf_convert import t5_encoder_from_hf_model

    tok = make_word_tokenizer([" ".join(WORDS)])
    proj = np.random.RandomState(7).randn(32, 16).astype(np.float32)
    jparams, jcfg = t5_encoder_from_hf_model(tiny_t5, projection=proj)
    cfg = pt5.T5EncoderConfig(**{**jcfg.__dict__, "vocab_size": 120})
    path = str(tmp_path / "tiny-gtr-t5")
    phc.save_hf_checkpoint(phc.params_from_jax(jax.tree.map(np.asarray, jparams), cfg), path)
    tok.save_pretrained(path)
    enc = penc_mod.load_encoder(path, CPU, dtype=torch.float32)
    texts = _texts(8, 5, hi=9)
    got = enc.encode(texts, penc_mod.EncodeOptions(batch_size=2, maxlength=16))
    jax_enc = jenc_mod.JaxEncoder(jparams, jcfg, tok, dtype=jnp.float32, embed_fn=jt5.t5_embed, force_normalize=True)
    want = jax_enc.encode(texts, jenc_mod.EncodeOptions(batch_size=2, maxlength=16))
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-3)
    os.remove(os.path.join(path, "2_Dense", "pytorch_model.bin"))
    with caplog.at_level("WARNING"):
        raw = penc_mod.load_encoder(path, CPU, dtype=torch.float32)
    assert "No sentence-transformers Dense projection" in caplog.text and raw.model.projection is None


@pytest.mark.parametrize("name,pooling,bidirectional", [
    ("tiny-GRIT-embedder", "mean", True), ("tiny-qwen3-embedding", "last", False),
])
def test_load_encoder_dispatches_llama_family(tmp_path, name, pooling, bidirectional):
    """llama family -> llama_embed: GRIT / ReasonIR / DRAMA by name mean-pool
    bidirectionally, others (Qwen3-embedding) take the last token and the
    query instruction; against JAX llama_embed on the same weights."""
    from retrieval_scaling_tpu.models.hf_convert import llama_params_from_state_dict
    from retrieval_scaling_tpu_torch.models.llama import init_llama_params

    tok = make_word_tokenizer([" ".join(WORDS)])
    cfg = LlamaConfig(vocab_size=tok.vocab_size + 6, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                      intermediate_size=64, max_position_embeddings=64, head_dim=8, qk_norm=True,
                      tie_embeddings=True)
    jcfg = jl.LlamaConfig(**cfg.__dict__, attention_impl="xla")
    model = init_llama_params(cfg, torch.Generator().manual_seed(3))
    path = str(tmp_path / name)
    phc.save_hf_checkpoint(model, path)
    tok.save_pretrained(path)
    # the JAX side reads the same HF state dict
    tree = llama_params_from_state_dict({k: v.numpy() for k, v in phc.hf_state_dict_from_params(model).items()},
                                        jcfg)
    enc = penc_mod.load_encoder(path, CPU, dtype=torch.float32)
    assert enc.query_prefix == ("" if bidirectional else penc_mod._QWEN3_QUERY_PREFIX)
    texts = _texts(9, 5, hi=12)
    got = enc.encode(texts, penc_mod.EncodeOptions(batch_size=8, maxlength=16))
    enc_ids = tok(texts, max_length=16, truncation=True, padding=False)["input_ids"]
    width = max(32, max(len(t) for t in enc_ids))
    ids = np.zeros((len(texts), width), np.int32)
    mask = np.zeros((len(texts), width), np.int32)
    for r, t in enumerate(enc_ids):
        ids[r, : len(t)], mask[r, : len(t)] = t, 1
    # the encoders normalise only when asked (JaxEncoder passes normalize=False here)
    embed = jax.jit(lambda p, i, m: jl.llama_embed(p, jcfg, i, m, pooling=pooling, normalize=False,
                                                   bidirectional=bidirectional))
    want = np.asarray(embed(tree, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got.astype(np.float32), want, atol=1e-3)
