"""Port parity: the llama-family reader (retrieval_scaling_tpu_torch.models.llama).

Every case of tests/test_llama.py has a twin here: the same tiny HF model
(transformers, built in-process) is read by the JAX package
(``llama_from_hf_model``) and carried into the port by ``params_from_jax``;
the port is also loaded from the HF state dict and its ``config.json`` dict
(``llama_params_from_state_dict`` / ``llama_config_from_hf``). Tolerances:
  * port vs HF logits: the JAX test's own tolerance for that family;
  * port vs JAX logits on the same weights: 2e-5 (f32, sums in another order);
  * configs read from a plain dict equal the JAX reading of transformers'
    config class built from the same dict, field by field;
  * greedy generation: tokens equal to JAX ``make_generate_fn``'s in every
    weight scheme (float, bf16, int8, int4) and with the int8 KV cache, with
    a sliding window shorter than the prompt. For int8 weights the JAX tree
    holds the int8 values as bf16, which is what K6 and the JAX TPU
    kernel multiply (``bf16(x) @ bf16(wq) * scale``); JAX's CPU route would
    row-quantise x instead;
  * reader backend loglikelihoods: 1e-4 relative, as the GPT-NeoX twin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from helpers import make_word_tokenizer
from retrieval_scaling_tpu.models import generate as jgen
from retrieval_scaling_tpu.models import llama as jl
from retrieval_scaling_tpu.models.hf_convert import llama_config_from_hf as jax_config_from_hf
from retrieval_scaling_tpu.models.hf_convert import llama_from_hf_model
from retrieval_scaling_tpu.rag_eval.models import JaxReaderLM
from retrieval_scaling_tpu_torch.evals.perplexity import make_row_loss_fn
from retrieval_scaling_tpu_torch.models import generate as pgen
from retrieval_scaling_tpu_torch.models import hf_convert as phc
from retrieval_scaling_tpu_torch.models import llama as pl
from retrieval_scaling_tpu_torch.models.continuous_batching import ContinuousBatcher
from retrieval_scaling_tpu_torch.rag_eval.models import TorchReaderLM

torch.set_num_threads(1)
EOS = 0
PORT_FIELDS = [f.name for f in dataclasses.fields(pl.LlamaConfig)]


def port_cfg(jcfg) -> pl.LlamaConfig:
    return pl.LlamaConfig(**{f: getattr(jcfg, f) for f in PORT_FIELDS})


def jax_cfg(cfg: pl.LlamaConfig) -> jl.LlamaConfig:
    return jl.LlamaConfig(**dataclasses.asdict(cfg), attention_impl="xla")


def _ids(seed, b=2, s=12, v=128):
    return np.random.RandomState(seed).randint(3, v, (b, s)).astype(np.int64)


# ---------------------------------------------------------------- HF twins of tests/test_llama.py
_COMMON = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=48, max_position_embeddings=64)
_PHI3 = dict(tie_word_embeddings=False, pad_token_id=0, bos_token_id=1, eos_token_id=2, attention_dropout=0.0,
             resid_pdrop=0.0, embd_pdrop=0.0)
# name -> (seed, HF class, config class, config kwargs, sequence length, logits tolerance of the JAX test)
FAMILIES = {
    "llama": (0, "LlamaForCausalLM", "LlamaConfig",
              dict(_COMMON, vocab_size=128, intermediate_size=64, rms_norm_eps=1e-5, tie_word_embeddings=False), 12,
              (2e-4, 2e-3)),
    "qwen2_bias": (1, "Qwen2ForCausalLM", "Qwen2Config", dict(_COMMON, tie_word_embeddings=False), 12, (2e-4, 2e-3)),
    "qwen3_qknorm": (2, "Qwen3ForCausalLM", "Qwen3Config", dict(_COMMON, head_dim=16, tie_word_embeddings=True), 12,
                     (2e-4, 2e-3)),
    "llama3_rope_scaling": (7, "LlamaForCausalLM", "LlamaConfig", dict(
        _COMMON, max_position_embeddings=128, tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32}), 48, (3e-4, 3e-3)),
    "gemma": (3, "GemmaForCausalLM", "GemmaConfig", dict(_COMMON, head_dim=16, hidden_act="gelu_pytorch_tanh"), 12,
              (2e-4, 2e-4)),
    "olmo1": (4, "OlmoForCausalLM", "OlmoConfig", dict(_COMMON, num_key_value_heads=4, clip_qkv=8.0), 12,
              (2e-4, 2e-4)),
    "olmo2": (5, "Olmo2ForCausalLM", "Olmo2Config", dict(_COMMON), 12, (2e-4, 2e-4)),
    "gemma2": (6, "Gemma2ForCausalLM", "Gemma2Config", dict(
        _COMMON, head_dim=16, attn_logit_softcapping=50.0, final_logit_softcapping=30.0, query_pre_attn_scalar=16),
        12, (3e-4, 3e-4)),
    "gemma2_window": (7, "Gemma2ForCausalLM", "Gemma2Config", dict(_COMMON, head_dim=16, sliding_window=8), 24,
                      (3e-4, 3e-4)),
    "mistral_window": (8, "MistralForCausalLM", "MistralConfig", dict(_COMMON, sliding_window=8), 24, (3e-4, 3e-4)),
    "phi3": (4, "Phi3ForCausalLM", "Phi3Config", dict(
        _COMMON, vocab_size=128, intermediate_size=64, rope_theta=10000.0, rms_norm_eps=1e-5, **_PHI3), 12,
        (3e-4, 2e-3)),
    "phi3_window": (9, "Phi3ForCausalLM", "Phi3Config", dict(_COMMON, sliding_window=8, **_PHI3), 24, (3e-4, 3e-4)),
}


def _hf_model(name):
    seed, model_cls, cfg_cls, kw, _, _ = FAMILIES[name]
    torch.manual_seed(seed)
    return getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kw)).eval()


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_logits_match_hf_and_jax(name):
    """Logits of the port (weights from JAX, and weights + config read from
    the HF state dict and config dict) against HF and the JAX forward."""
    hf = _hf_model(name)
    _, _, _, _, s, (atol, rtol) = FAMILIES[name]
    params, jcfg = llama_from_hf_model(hf)
    cfg = port_cfg(jcfg)
    model = phc.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    cfg_dict = dict(hf.config.to_diff_dict(), model_type=hf.config.model_type)
    assert phc.llama_config_from_hf(cfg_dict) == cfg
    loaded = phc.llama_params_from_state_dict(hf.state_dict(), cfg)
    ids = _ids(s, s=s, v=hf.config.vocab_size)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()
        got = pl.llama_logits(model, cfg, pl.llama_forward(model, cfg, torch.from_numpy(ids))).numpy()
        got_sd = phc.reader_logits(loaded, cfg, torch.from_numpy(ids)).numpy()
    jax_logits = np.asarray(jl.llama_logits(params, jcfg, jl.llama_forward(params, jcfg, jnp.asarray(ids))))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got_sd, ref, atol=atol, rtol=rtol)
    np.testing.assert_allclose(got, jax_logits, atol=2e-5, rtol=2e-5)


def test_window_really_masks():
    """With the pattern off, the long-range logits move (the JAX check)."""
    hf = _hf_model("gemma2_window")
    params, jcfg = llama_from_hf_model(hf)
    cfg = port_cfg(jcfg)
    assert cfg.sliding_window == 8 and cfg.sliding_pattern == (True, False)
    model = phc.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    ids = torch.from_numpy(_ids(1, s=24, v=96))
    nowin = dataclasses.replace(cfg, sliding_pattern=None)
    with torch.no_grad():
        ref = hf(ids).logits.numpy()
        got = pl.llama_logits(model, nowin, pl.llama_forward(model, nowin, ids)).numpy()
    assert np.abs(got - ref).max() > 1e-3


def test_loss_and_reader_dispatch_match_hf():
    hf = _hf_model("llama")
    params, jcfg = llama_from_hf_model(hf)
    cfg = port_cfg(jcfg)
    model = phc.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    ids = _ids(2)
    labels = ids.copy()
    labels[:, :5] = -100
    with torch.no_grad():
        out = hf(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        loss_sum, n_tok = pl.llama_lm(model, cfg, torch.from_numpy(ids), torch.from_numpy(labels))
        rows, counts = make_row_loss_fn(cfg)(model, torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss_sum) / float(n_tok), float(out.loss), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(rows.sum()), float(loss_sum), rtol=1e-6)
    assert int(counts.sum()) == int(n_tok)
    jsum, _ = jl.llama_lm(params, jcfg, jnp.asarray(ids), jnp.asarray(labels))
    np.testing.assert_allclose(float(loss_sum), float(jsum), rtol=1e-5)


def test_embed_pooling_matches_jax():
    jcfg = jl.LlamaConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2, num_kv_heads=1,
                          intermediate_size=32, max_position_embeddings=32, attention_impl="xla")
    params = jl.init_llama_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = phc.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    ids = np.random.RandomState(0).randint(3, 64, (2, 8))
    mask = np.asarray([[1] * 8, [1] * 5 + [0] * 3])
    for kw in (dict(pooling="last", normalize=True), dict(pooling="mean", normalize=False, bidirectional=True)):
        want = np.asarray(jl.llama_embed(params, jcfg, jnp.asarray(ids), jnp.asarray(mask), **kw))
        got = pl.llama_embed(model, cfg, torch.from_numpy(ids), torch.from_numpy(mask), **kw).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_greedy_generation_matches_hf():
    hf = _hf_model("llama")
    params, jcfg = llama_from_hf_model(hf)
    cfg = port_cfg(jcfg)
    model = phc.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    prompts, lens = _ids(3, b=2, s=6), np.asarray([6, 4])
    got = pgen.make_generate_fn(cfg, 5, EOS)(model, torch.from_numpy(prompts), torch.from_numpy(lens)).numpy()
    want = np.asarray(jgen.make_generate_fn(jcfg, 5, EOS)(params, jnp.asarray(prompts), jnp.asarray(lens), 0))
    np.testing.assert_array_equal(got, want)
    for row in range(2):
        with torch.no_grad():
            ref = hf.generate(torch.from_numpy(prompts[row, : lens[row]])[None], max_new_tokens=5, do_sample=False,
                              eos_token_id=EOS, pad_token_id=EOS)[0, lens[row]:].numpy()
        upto = int(np.argmax(ref == EOS)) if (ref == EOS).any() else len(ref)
        np.testing.assert_array_equal(got[row, :upto], ref[:upto])


def test_unsupported_rope_scaling_raises():
    cfg = pl.LlamaConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4, num_kv_heads=2,
                         intermediate_size=64, max_position_embeddings=64, rope_scaling_type="longrope")
    with pytest.raises(NotImplementedError):
        pl.rope_inv_freq(cfg)


# ---------------------------------------------------------------- config.json read as a plain dict
_SHAPE = dict(vocab_size=96, hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=96,
              max_position_embeddings=128)


@pytest.mark.parametrize("model_type,extra", [
    ("llama", {"num_key_value_heads": 2}),
    ("llama", {"rope_scaling": {"type": "linear", "factor": 2.0}}),
    ("mistral", {"num_key_value_heads": 2}),                # the class's 4096-token window
    ("mistral", {"sliding_window": None}),
    ("qwen2", {}),                                           # QKV bias without the field
    ("qwen3", {"head_dim": 32}),
    ("gemma", {}),
    ("gemma2", {"num_key_value_heads": 2}),                  # layer_types, caps and scalar from the class
    ("gemma2", {"layer_types": ["full_attention", "sliding_attention"] * 2, "sliding_window": 16}),
    ("olmo", {"clip_qkv": 4.0}),
    ("olmo2", {}),
    ("phi3", {"sliding_window": 32}),
])
def test_config_dict_reads_like_the_transformers_class(model_type, extra):
    """A config.json that leaves keys out reads as the JAX package reads
    transformers' class built from it (which fills the class defaults in)."""
    raw = dict(_SHAPE, model_type=model_type, **extra)
    want = port_cfg(jax_config_from_hf(transformers.AutoConfig.for_model(**raw)))
    assert phc.llama_config_from_hf(raw) == want


@pytest.mark.parametrize("name", ["llama3_rope_scaling", "gemma2_window", "qwen3_qknorm", "olmo1", "qwen2_bias"])
def test_hf_config_round_trip(name):
    """hf_config_from_cfg writes a config.json that both the port and the
    transformers class read back as the same config."""
    _, jcfg = llama_from_hf_model(_hf_model(name))
    cfg = port_cfg(jcfg)
    raw = phc.hf_config_from_cfg(cfg)
    assert phc.llama_config_from_hf(raw) == cfg
    assert port_cfg(jax_config_from_hf(transformers.AutoConfig.for_model(**raw))) == cfg


def test_checkpoint_round_trip(tmp_path):
    """save_hf_checkpoint -> load_hf_reader, and transformers reads the
    written checkpoint to the same logits."""
    hf = _hf_model("gemma2_window")
    params, jcfg = llama_from_hf_model(hf)
    cfg = port_cfg(jcfg)
    model = phc.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    phc.save_hf_checkpoint(model, str(tmp_path))
    back = phc.load_hf_reader(str(tmp_path))
    assert back.cfg == cfg
    ids = torch.from_numpy(_ids(4, s=20, v=96))
    hf2 = transformers.AutoModelForCausalLM.from_pretrained(str(tmp_path)).eval()
    with torch.no_grad():
        np.testing.assert_array_equal(phc.reader_logits(back, cfg, ids).numpy(),
                                      phc.reader_logits(model, cfg, ids).numpy())
        np.testing.assert_allclose(phc.reader_logits(back, cfg, ids).numpy(), hf2(ids).logits.numpy(),
                                   atol=3e-4, rtol=3e-4)


# ---------------------------------------------------------------- generation in every scheme
# a Gemma-2-shaped tiny reader (GQA, pre+post norms, both soft-caps, gelu-tanh,
# a window of 8 on layer 0) and a Llama-3-shaped one; prompts up to 20 tokens
GEMMA2 = pl.LlamaConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                        intermediate_size=256, max_position_embeddings=128, tie_embeddings=True,
                        hidden_act="gelu_tanh", rms_norm_offset=True, embedding_multiplier=128 ** 0.5,
                        norm_placement="pre_post", attn_logit_softcap=50.0, final_logit_softcap=30.0,
                        query_pre_attn_scalar=32, sliding_window=8, sliding_pattern=(True, False))
LLAMA3 = pl.LlamaConfig(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4, num_kv_heads=1,
                        intermediate_size=256, max_position_embeddings=128, rope_base=500000.0,
                        rope_scaling_type="llama3", rope_factor=8.0, rope_original_max_pos=32)
CONFIGS = {"gemma2": GEMMA2, "llama3": LLAMA3}


def _random_tree(cfg, seed):
    jcfg = jax_cfg(cfg)
    tree = jax.tree.map(np.asarray, jl.init_llama_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for layer in tree["layers"]:  # norms away from their init
        for key in [k for k in layer if "norm" in k]:
            layer[key] = (layer[key] * (1 + 0.2 * rng.randn(*layer[key].shape))).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=list(CONFIGS))
def reader(request):
    cfg = CONFIGS[request.param]
    tree = _random_tree(cfg, 1)
    return cfg, tree, phc.params_from_jax(tree, cfg)


def _prompts(seed, lens, width=None):
    rng = np.random.RandomState(seed)
    ids = np.zeros((len(lens), width or max(lens)), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 256, n)
    return ids, np.asarray(lens)


def _jax_tokens(cfg, tree, ids, lens, max_new, **kw):
    fn = jgen.make_generate_fn(jax_cfg(cfg), max_new, EOS, **kw)
    return np.asarray(fn(tree, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32), 0))


def _port_tokens(cfg, model, ids, lens, max_new, **kw):
    return pgen.make_generate_fn(cfg, max_new, EOS, **kw)(model, torch.from_numpy(ids), torch.from_numpy(lens)).numpy()


def _k6_tree(qtree):
    """The JAX int8 tree with its int8 values held as bf16 (exact): K6's
    and the JAX TPU kernel's bf16(x) @ bf16(wq) * scale."""
    cast = lambda d: {k: (v.astype(jnp.bfloat16) if k.endswith("@q8") else v) for k, v in d.items()}  # noqa: E731
    out = cast({k: v for k, v in qtree.items() if k != "layers"})
    out["layers"] = [cast(layer) for layer in qtree["layers"]]
    return out


@pytest.mark.parametrize("scheme,kv_cache", [(None, None), (None, "int8"), ("bf16", None), ("int8", None),
                                             ("int4", None), ("int4", "int8")])
def test_greedy_tokens_match_jax_in_every_scheme(reader, scheme, kv_cache):
    cfg, tree, model = reader
    ids, lens = _prompts(3, [20, 13, 7])  # longer than the window of 8
    jtree, pmodel = tree, model
    if scheme is not None:
        qtree = jax.tree.map(np.asarray, jgen.quantize_decode_params(tree, jax_cfg(cfg), scheme=scheme))
        jtree = _k6_tree(qtree) if scheme == "int8" else qtree
        pmodel = pgen.quantize_decode_params(model, cfg, scheme=scheme)
        # the port's own quantization and the JAX tree carried across agree
        np.testing.assert_array_equal(_port_tokens(cfg, pmodel, ids, lens, 10, kv_cache=kv_cache),
                                      _port_tokens(cfg, phc.params_from_jax(qtree, cfg), ids, lens, 10,
                                                   kv_cache=kv_cache))
    np.testing.assert_array_equal(_port_tokens(cfg, pmodel, ids, lens, 10, kv_cache=kv_cache),
                                  _jax_tokens(cfg, jtree, ids, lens, 10, kv_cache=kv_cache))


@pytest.mark.parametrize("scheme", ["int8", "int4", "bf16"])
def test_quantize_decode_params_matches_jax(reader, scheme):
    """Same layout and keys; int8 / int4 weights bit for bit, scales within
    one f32 ulp (int8) or equal (int4); a tied head stays the embedding."""
    cfg, tree, model = reader
    ours = pgen.quantize_decode_params(model, cfg, scheme=scheme)
    theirs = phc.params_from_jax(jax.tree.map(np.asarray, jgen.quantize_decode_params(tree, jax_cfg(cfg),
                                                                                       scheme=scheme)), cfg)
    pairs = [(ours.q8, theirs.q8)] + [(a.q8, b.q8) for a, b in zip(ours.layers, theirs.layers)]
    for a, b in pairs:
        assert a.keys() == b.keys()
        for key in a:
            if a[key].dtype in (torch.int8, torch.uint8, torch.bfloat16):
                assert torch.equal(a[key], b[key]), key
            else:
                np.testing.assert_array_max_ulp(a[key].numpy(), b[key].numpy(), maxulp=1)
    layer_keys = set(ours.layers[0].q8)
    if scheme == "int4":
        assert layer_keys == {f"{n}@{s}" for n in pgen._LLAMA_PROJECTIONS for s in ("q4", "s4g")}
    else:
        assert layer_keys == {f"{n}@{s}" for n in ("qkv3", "gateup", "o_w", "down_w") for s in ("q8", "s")}
    assert ("lm_head@q8" in ours.q8 or "lm_head@q4" in ours.q8) != cfg.tie_embeddings


def test_decode_int4_logits_track_float():
    """The twin of tests/test_quant_matmul.py's int4 logits check, on its
    config and its weights: int4 row cosine > 0.95 (its limit: group-128
    int4 carries ~13 % weight noise), int8 > 0.99."""
    jcfg = jl.LlamaConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                          intermediate_size=512, max_position_embeddings=64, tie_embeddings=False)
    cfg = port_cfg(jcfg)
    model = phc.params_from_jax(jax.tree.map(np.asarray, jl.init_llama_params(jcfg, jax.random.PRNGKey(4))), cfg)
    ids = torch.from_numpy(np.random.RandomState(12).randint(0, 256, (2, 8)))
    pos = torch.arange(8).expand(2, 8)
    valid = torch.arange(16)[None, :] < 8
    with torch.no_grad():
        ref, _ = pgen.forward_with_cache(model, cfg, ids, pos, pgen.init_cache(cfg, 2, 16, torch.float32), valid)
        for scheme, floor in (("int8", 0.99), ("int4", 0.95)):
            qmodel = pgen.quantize_decode_params(model, cfg, scheme=scheme)
            got, _ = pgen.forward_with_cache(qmodel, cfg, ids, pos, pgen.init_cache(cfg, 2, 16, torch.float32), valid)
            a, b = got.reshape(-1, 256), ref.reshape(-1, 256)
            cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
            assert cos.min() > floor, (scheme, cos.min())


def test_continuous_batcher_matches_jax_static(reader):
    """Mixed lengths, fewer slots than requests, prompts beyond the window."""
    cfg, tree, model = reader
    rng = np.random.RandomState(6)
    requests = [(rng.randint(1, 256, int(rng.randint(3, 20))).tolist(), int(rng.choice([4, 8, 12])))
                for _ in range(5)]
    outs = ContinuousBatcher(model, cfg, EOS, slots=2, max_len=64, chunk=4).generate(requests)
    ids, lens = _prompts(0, [len(p) for p, _ in requests])
    for r, (prompt, _) in enumerate(requests):
        ids[r, : len(prompt)] = prompt
    toks = _jax_tokens(cfg, tree, ids, lens, 12)
    for out, row, (_, max_new) in zip(outs, toks.tolist(), requests):
        row = row[:max_new]
        assert out == (row[: row.index(EOS)] if EOS in row else row)


# ---------------------------------------------------------------- reader backend
def _requests(seed):
    rng = np.random.RandomState(seed)
    ctx = [" ".join(f"w{i}" for i in rng.randint(3, 250, int(rng.randint(5, 40)))) for _ in range(5)]
    gen = [{"context": c, "gen_kwargs": {"max_gen_toks": int(rng.choice([3, 6])), "until": ["w7"]}} for c in ctx]
    pairs = [(c, " w5 w9") for c in ctx] + [("", "w3 w4")]
    return gen, pairs, ctx


@pytest.mark.parametrize("gen_engine", ["static", "continuous"])
def test_reader_backend_matches_jax_reader(reader, gen_engine):
    cfg, tree, model = reader
    tok = make_word_tokenizer([" ".join(f"w{i}" for i in range(250))])
    jlm = JaxReaderLM(tree, jax_cfg(cfg), tok, batch_size=4, gen_engine=gen_engine)
    plm = TorchReaderLM(model, cfg, tok, batch_size=4, gen_engine=gen_engine)
    gen, pairs, ctx = _requests(8)
    assert plm.generate_until(gen) == jlm.generate_until(gen)
    for (a, ga), (b, gb) in zip(plm.loglikelihood(pairs), jlm.loglikelihood(pairs)):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)) and ga == gb
    np.testing.assert_allclose(plm.loglikelihood_rolling(ctx[:2]), jlm.loglikelihood_rolling(ctx[:2]), rtol=1e-5)


def test_reader_backend_int4_matches_jax_int4_reader(reader):
    """quantization="int4": the port's scores and greedy texts against the
    JAX backend's int4 reader on the same weights. Scores within 2e-3
    relative: the row quantisation of W4A8 rounds x to int8 steps, and a
    last-bit difference in x can move a value across a step."""
    cfg, tree, model = reader
    tok = make_word_tokenizer([" ".join(f"w{i}" for i in range(250))])
    jlm = JaxReaderLM(tree, jax_cfg(cfg), tok, batch_size=4, quantization="int4")
    plm = TorchReaderLM(model, cfg, tok, batch_size=4, quantization="int4")
    gen, pairs, _ = _requests(9)
    for (a, _), (b, _) in zip(plm.loglikelihood(pairs), jlm.loglikelihood(pairs)):
        assert abs(a - b) <= 2e-3 * max(1.0, abs(b))
    assert plm.generate_until(gen) == jlm.generate_until(gen)


def test_reader_from_pretrained_dispatches_on_model_type(tmp_path):
    tok = make_word_tokenizer([" ".join(f"w{i}" for i in range(250))])
    model = pl.init_llama_params(GEMMA2, torch.Generator().manual_seed(0))
    phc.save_hf_checkpoint(model, str(tmp_path))
    tok.save_pretrained(str(tmp_path))
    lm = TorchReaderLM.from_pretrained(str(tmp_path), torch.device("cpu"), batch_size=2)
    assert isinstance(lm.model, pl.Llama) and lm.cfg == GEMMA2
    assert len(lm.generate_until(_requests(1)[0][:2])) == 2


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1/K2/K3/K6/K8 have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", [None, "bf16", "int8", "int4"])
def test_gemma2_reader_on_cuda_launches_k2_k3(cuda_device, scheme):
    """A tiny Gemma-2 reader on the card: scoring launches K2 with the
    window on layer 0 and the cap on both layers, decoding launches K3
    with the cap, and the logits follow the CPU forward's (2e-2 of max
    |logit|; int4: the same card path with K8's plain version, since W4A8
    rounds activations to int8 steps and the bf16 attention on the card
    moves some of them across a step)."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    cfg = dataclasses.replace(GEMMA2, head_dim=64, hidden_size=256, intermediate_size=512)
    cpu = pl.init_llama_params(cfg, torch.Generator().manual_seed(0))
    model = pl.init_llama_params(cfg, torch.Generator().manual_seed(0)).to(cuda_device)
    if scheme is not None:
        cpu, model = (pgen.quantize_decode_params(m, cfg, scheme=scheme) for m in (cpu, model))
    ids = torch.from_numpy(_prompts(5, [40, 40])[0])
    before = (fa.flash_attention.window_launches, fa.flash_attention.cap_launches, fa.flash_decode.cap_launches,
              qm.int4_decode_matmul.launches)
    with torch.no_grad():
        got = phc.reader_logits(model, cfg, ids.to(cuda_device)).cpu()
        want = phc.reader_logits(cpu, cfg, ids)
        toks = pgen.make_generate_fn(cfg, 4, EOS)(model, ids.to(cuda_device), torch.tensor([40, 30]))
    torch.cuda.synchronize()
    if scheme == "int4":
        kernel = qm.int4_decode_matmul
        qm.int4_decode_matmul = lambda x, qw, out_dtype=torch.bfloat16: qm.int4_matmul_reference(
            x.reshape(-1, x.shape[-1]), qw.packed, qw.scale, out_dtype).reshape(*x.shape[:-1], qw.packed.shape[1])
        try:
            with torch.no_grad():
                want = phc.reader_logits(model, cfg, ids.to(cuda_device)).cpu()
        finally:
            qm.int4_decode_matmul = kernel
    after = (fa.flash_attention.window_launches, fa.flash_attention.cap_launches, fa.flash_decode.cap_launches,
             qm.int4_decode_matmul.launches)
    assert after[0] - before[0] >= 1 and after[1] - before[1] >= 2 and after[2] - before[2] >= 2 * 3
    assert (after[3] > before[3]) == (scheme == "int4")
    assert toks.shape == (2, 4)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
