"""Port parity: prompt-lookup speculative decoding
(retrieval_scaling_tpu_torch.models.speculative) through every entry point.

The JAX tests' tiny configs (tests/test_speculative.py: GPT-NeoX, and a
llama with GQA) get their JAX weights carried into the port by
``params_from_jax``; the same numpy prompts go to both packages, in f32.
Held to the JAX package exactly: the drafter and the acceptance core, the
greedy speculative tokens (which also equal the static engine's), the
``with_stats`` rounds and tokens, eos cuts, int8 weights (the JAX tree holds
the int8 values as bf16: K6's and the JAX TPU kernel's arithmetic), the int8
KV cache, scripted emission, the verify forward's logits over a filled cache
(1e-4: f32 sums in another order; a sliding window and a soft-cap included),
the slot pool's streams and the reader backend's texts. Sampled decoding is
held to the port's own sequential sampler by total variation (the JAX
test's setup and 0.06 limit): torch.Generator is not jax.random.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_word_tokenizer
from retrieval_scaling_tpu.models import continuous_batching as jcb
from retrieval_scaling_tpu.models import generate as jgen
from retrieval_scaling_tpu.models import gpt_neox as jneox
from retrieval_scaling_tpu.models import llama as jl
from retrieval_scaling_tpu.models import speculative as jspec
from retrieval_scaling_tpu.rag_eval.models import JaxReaderLM
from retrieval_scaling_tpu_torch.models import generate as pgen
from retrieval_scaling_tpu_torch.models import speculative as pspec
from retrieval_scaling_tpu_torch.models.continuous_batching import ContinuousBatcher
from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig
from retrieval_scaling_tpu_torch.models.hf_convert import params_from_jax
from retrieval_scaling_tpu_torch.models.llama import LlamaConfig
from retrieval_scaling_tpu_torch.rag_eval.models import TorchReaderLM

torch.set_num_threads(1)
EOS = 0
_SMALL = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64, max_position_embeddings=128)
NEOX = GPTNeoXConfig(vocab_size=61, **_SMALL)
LLAMA = LlamaConfig(vocab_size=61, num_kv_heads=2, **_SMALL)
# the verify forward's window and cap: a Gemma-2-shaped llama, window 5
GEMMA2 = LlamaConfig(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                     intermediate_size=64, max_position_embeddings=128, tie_embeddings=True, hidden_act="gelu_tanh",
                     rms_norm_offset=True, embedding_multiplier=32 ** 0.5, norm_placement="pre_post",
                     attn_logit_softcap=50.0, final_logit_softcap=30.0, query_pre_attn_scalar=16, sliding_window=5,
                     sliding_pattern=(True, False))


def jax_cfg(cfg):
    fields = dataclasses.asdict(cfg)
    if isinstance(cfg, LlamaConfig):
        return jl.LlamaConfig(**fields, attention_impl="xla")
    return jneox.GPTNeoXConfig(**{f.name: fields[f.name] for f in dataclasses.fields(jneox.GPTNeoXConfig)
                                  if f.name in fields}, attention_impl="xla")


def _tree(cfg, seed=0):
    """The JAX test's weights (``_params``: PRNGKey(0), f32) as numpy."""
    jcfg = jax_cfg(cfg)
    key = jax.random.PRNGKey(seed)
    if isinstance(cfg, LlamaConfig):
        return jax.tree.map(np.asarray, jl.init_llama_params(jcfg, key, dtype=jnp.float32))
    return jax.tree.map(np.asarray, jneox.init_gpt_neox_params(jcfg, key))


class _Readers(dict):
    """name -> (cfg, JAX tree, port model), each built at its first use."""

    def __missing__(self, name):
        cfg = {"neox": NEOX, "llama-gqa": LLAMA, "gemma2": GEMMA2}[name]
        tree = _tree(cfg)
        self[name] = (cfg, tree, params_from_jax(tree, cfg))
        return self[name]


@pytest.fixture(scope="module")
def readers():
    return _Readers()


def _prompts(kind, vocab, rows=3):
    """tests/test_speculative.py's ``_prompts``."""
    rng = np.random.RandomState(7)
    lens = np.array([16, 9, 13][:rows])
    ids = rng.randint(1, vocab, (rows, 16)).astype(np.int64)
    if kind == "repetitive":
        phrase = rng.randint(1, vocab, 4)
        for r in range(rows):
            ids[r, : lens[r]] = np.tile(phrase, 5)[: lens[r]]
    for r in range(rows):
        ids[r, lens[r]:] = 0
    return ids, lens.astype(np.int64)


def _jax_spec(cfg, tree, ids, lens, max_new, seed=0, script=None, **kw):
    fn = jspec.make_speculative_generate_fn(jax_cfg(cfg), max_new, kw.pop("eos_id", EOS), **kw)
    args = (tree, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32), seed)
    out = fn(*args) if script is None else fn(*args, jnp.asarray(script, jnp.int32))
    return jax.tree.map(np.asarray, out)


def _port_spec(cfg, model, ids, lens, max_new, seed=0, script=None, **kw):
    fn = pspec.make_speculative_generate_fn(cfg, max_new, kw.pop("eos_id", EOS), **kw)
    args = (model, torch.from_numpy(ids), torch.from_numpy(lens), seed)
    out = fn(*args) if script is None else fn(*args, torch.from_numpy(script))
    return tuple(t.numpy() for t in out) if isinstance(out, tuple) else out.numpy()


def _port_static(cfg, model, ids, lens, max_new, **kw):
    fn = pgen.make_generate_fn(cfg, max_new, kw.pop("eos_id", EOS), **kw)
    return fn(model, torch.from_numpy(ids), torch.from_numpy(lens)).numpy()


# ---------------------------------------------------------------- drafter and acceptance
@pytest.mark.parametrize("kind", ["repetitive", "random"])
def test_draft_ngram_and_greedy_emission_match_jax(kind):
    rng = np.random.RandomState(11 if kind == "random" else 12)
    b, t = 5, 40
    if kind == "random":
        hist = rng.randint(1, 9, (b, t))
    else:
        hist = np.tile(rng.randint(1, 9, (b, 6)), (1, 7))[:, :t]
    cur = rng.randint(3, 30, b)
    hist[np.arange(t)[None, :] > cur[:, None]] = -1
    last = hist[np.arange(b), cur]
    for ngram, g in ((3, 7), (2, 3), (1, 4)):
        want = np.array(jspec._draft_ngram(jnp.asarray(hist, jnp.int32), jnp.asarray(last, jnp.int32),
                                             jnp.asarray(cur, jnp.int32), ngram, g))
        got = pspec._draft_ngram(torch.from_numpy(hist), torch.from_numpy(last), torch.from_numpy(cur), ngram, g)
        np.testing.assert_array_equal(got.numpy(), want)
        y = np.where(rng.rand(b, g + 1) < 0.6, np.pad(want, ((0, 0), (0, 1))), rng.randint(1, 9, (b, g + 1)))
        ja, js = jspec.greedy_emission(jnp.asarray(want, jnp.int32), jnp.asarray(y, jnp.int32))
        pa, ps = pspec.greedy_emission(torch.from_numpy(want).long(), torch.from_numpy(y).long())
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    # the JAX test's pinned cases: the latest non-self match wins
    h = torch.tensor([[5, 6, 7, 9, 5, 6, -1, -1]])
    assert pspec._draft_ngram(h, torch.tensor([6]), torch.tensor([5]), 2, 3)[0].tolist() == [7, 9, 5]


# ---------------------------------------------------------------- the static engine
@pytest.mark.parametrize("name", ["neox", "llama-gqa"])
@pytest.mark.parametrize("kind", ["repetitive", "random"])
@pytest.mark.parametrize("draft_len", [3, 7])
def test_speculative_tokens_match_jax_and_static_greedy(readers, name, kind, draft_len):
    cfg, tree, model = readers[name]
    ids, lens = _prompts(kind, cfg.vocab_size)
    got, rounds, emitted = _port_spec(cfg, model, ids, lens, 12, draft_len=draft_len, with_stats=True)
    want, j_rounds, j_emitted = _jax_spec(cfg, tree, ids, lens, 12, draft_len=draft_len, with_stats=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port_static(cfg, model, ids, lens, 12))
    assert (int(rounds), int(emitted)) == (int(j_rounds), int(j_emitted))


def test_speculative_eos_cut_and_one_token_match_jax(readers):
    cfg, tree, model = readers["neox"]
    ids, lens = _prompts("random", cfg.vocab_size)
    eos = int(_port_static(cfg, model, ids, lens, 8, eos_id=-1)[0, 3])  # a token the model emits
    got, rounds, emitted = _port_spec(cfg, model, ids, lens, 8, eos_id=eos, with_stats=True)
    want, j_rounds, j_emitted = _jax_spec(cfg, tree, ids, lens, 8, eos_id=eos, with_stats=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _port_static(cfg, model, ids, lens, 8, eos_id=eos))
    assert (int(rounds), int(emitted)) == (int(j_rounds), int(j_emitted))
    np.testing.assert_array_equal(_port_spec(cfg, model, ids, lens, 1), _jax_spec(cfg, tree, ids, lens, 1))


def test_speculative_with_int8_weights_matches_jax(readers):
    cfg, tree, model = readers["llama-gqa"]
    qtree = jax.tree.map(np.asarray, jgen.quantize_decode_params(tree, jax_cfg(cfg)))

    def k6(d):  # the int8 values held as bf16 (exact)
        return {k: (v.astype(jnp.bfloat16) if k.endswith("@q8") else v) for k, v in d.items()}

    jtree = k6({k: v for k, v in qtree.items() if k != "layers"})
    jtree["layers"] = [k6(layer) for layer in qtree["layers"]]
    qmodel = pgen.quantize_decode_params(model, cfg, scheme="int8")
    ids, lens = _prompts("repetitive", cfg.vocab_size)
    got = _port_spec(cfg, qmodel, ids, lens, 10)
    np.testing.assert_array_equal(got, _jax_spec(cfg, jtree, ids, lens, 10))
    np.testing.assert_array_equal(got, _port_static(cfg, qmodel, ids, lens, 10))


@pytest.mark.parametrize("name", ["llama-gqa", "gemma2"])
def test_speculative_int8_kv_cache_matches_jax(readers, name):
    cfg, tree, model = readers[name]
    ids, lens = _prompts("repetitive", cfg.vocab_size)
    got = _port_spec(cfg, model, ids, lens, 10, kv_cache="int8")
    np.testing.assert_array_equal(got, _jax_spec(cfg, tree, ids, lens, 10, kv_cache="int8"))
    np.testing.assert_array_equal(got, _port_static(cfg, model, ids, lens, 10, kv_cache="int8"))


def test_speculative_float_cache_with_window_and_cap_matches_jax(readers):
    cfg, tree, model = readers["gemma2"]
    ids, lens = _prompts("repetitive", cfg.vocab_size)  # prompts longer than the window of 5
    got = _port_spec(cfg, model, ids, lens, 10, draft_len=4)
    np.testing.assert_array_equal(got, _jax_spec(cfg, tree, ids, lens, 10, draft_len=4))
    np.testing.assert_array_equal(got, _port_static(cfg, model, ids, lens, 10))


def test_scripted_emission_matches_jax(readers):
    """Emits exactly the script; a prompt-copying script accepts more tokens
    a round than a novel one; rounds and tokens equal JAX's."""
    cfg, tree, model = readers["neox"]
    rng = np.random.RandomState(5)
    b, plen, max_new = 3, 16, 24
    ids = rng.randint(1, cfg.vocab_size, (b, plen)).astype(np.int64)
    lens = np.full((b,), plen, np.int64)
    copy = np.zeros((b, max_new), np.int64)
    for r in range(b):
        pos = 0
        while pos < max_new:
            start = rng.randint(0, plen - 8)
            span = ids[r, start: start + min(8, max_new - pos)]
            copy[r, pos: pos + len(span)] = span
            pos += len(span)
    novel = rng.randint(1, cfg.vocab_size, (b, max_new)).astype(np.int64)
    tpr = {}
    for label, script in (("copy", copy), ("novel", novel)):
        got = _port_spec(cfg, model, ids, lens, max_new, draft_len=4, with_stats=True, scripted=True, script=script)
        want = _jax_spec(cfg, tree, ids, lens, max_new, draft_len=4, with_stats=True, scripted=True, script=script)
        np.testing.assert_array_equal(got[0], script)
        assert [int(v) for v in got[1:]] == [int(v) for v in want[1:]]
        tpr[label] = int(got[2]) / (b * int(got[1]))
    assert tpr["copy"] > tpr["novel"] and tpr["copy"] >= 2.0


def test_speculative_rejects_bad_configs():
    with pytest.raises(ValueError):
        pspec.make_speculative_generate_fn(NEOX, 4, EOS, draft_len=0)
    with pytest.raises(ValueError):
        pspec.make_speculative_generate_fn(NEOX, 4, EOS, kv_cache="int4")
    with pytest.raises(ValueError):
        pspec.make_speculative_generate_fn(NEOX, 4, EOS, scripted=True, temperature=1.0)
    with pytest.raises(NotImplementedError):
        pspec.make_speculative_generate_fn(NEOX, 4, EOS, mesh=object())
    fn = pspec.make_speculative_generate_fn(NEOX, 110, EOS)  # 16 + 110 + 8 > 128 positions
    ids, lens = _prompts("random", NEOX.vocab_size)
    with pytest.raises(ValueError):
        fn(params_from_jax(_tree(NEOX), NEOX), torch.from_numpy(ids), torch.from_numpy(lens))


# ---------------------------------------------------------------- the verify forward
@pytest.mark.parametrize("name,kv_cache", [("neox", None), ("llama-gqa", None), ("gemma2", None),
                                           ("gemma2", "int8")])
def test_contiguous_writes_logits_match_jax_on_a_filled_cache(readers, name, kv_cache):
    """A prefill, then a verify segment at n .. n + 4, then a second segment
    that starts inside the first (a rejected draft's slots are overwritten):
    logits within 1e-4 of JAX's at every step (1e-3 with the int8 cache, where
    a K/V value on a rounding boundary may land one int8 step away after f32
    sums in another order), the caches' written slots too."""
    cfg, tree, model = readers[name]
    jcfg = jax_cfg(cfg)
    ids, lens = _prompts("random", cfg.vocab_size)
    m = 40
    jdt, pdt = (jnp.int8, torch.int8) if kv_cache else (jnp.float32, torch.float32)
    jcache, pcache = jgen.init_cache(jcfg, 3, m, dtype=jdt), pgen.init_cache(cfg, 3, m, pdt)
    pos = np.broadcast_to(np.arange(16), (3, 16)).copy()
    valid = np.arange(m)[None, :] < lens[:, None]
    wmask = np.arange(16)[None, :] < lens[:, None]
    jl_, jcache = jgen.forward_with_cache(tree, jcfg, jnp.asarray(ids), jnp.asarray(pos), jcache, jnp.asarray(valid),
                                          jnp.asarray(wmask))
    pl_, pcache = pgen.forward_with_cache(model, cfg, torch.from_numpy(ids), torch.from_numpy(pos), pcache,
                                          torch.from_numpy(valid), torch.from_numpy(wmask))
    rng = np.random.RandomState(3)
    start = lens.copy()
    for step in range(2):
        seg = rng.randint(1, cfg.vocab_size, (3, 5))
        seg_pos = start[:, None] + np.arange(5)[None, :]
        valid = np.arange(m)[None, :] < (start + 5)[:, None]
        jl_, jcache = jgen.forward_with_cache(tree, jcfg, jnp.asarray(seg), jnp.asarray(seg_pos), jcache,
                                              jnp.asarray(valid), contiguous_writes=True)
        pl_, pcache = pgen.forward_with_cache(model, cfg, torch.from_numpy(seg), torch.from_numpy(seg_pos), pcache,
                                              torch.from_numpy(valid), contiguous_writes=True)
        tol = 1e-3 if kv_cache else 1e-4
        np.testing.assert_allclose(pl_.numpy(), np.asarray(jl_), atol=tol, rtol=tol)
        for li in range(cfg.num_layers):
            for r in range(3):
                hi = start[r] + 5
                a, b = pcache.k[li][r, :, :hi].float().numpy(), np.asarray(jcache.k[li])[r, :, :hi].astype(np.float32)
                np.testing.assert_allclose(a, b, atol=1.01 if kv_cache else 1e-5)
        start = start + np.array([2, 0, 4])  # the next segment overwrites 3, 5 and 1 drafted slots


def test_verify_forward_equals_one_token_steps(readers):
    """Within the port: the verify forward's logits at positions n .. n + 4
    equal five one-token steps' on the same tokens (1e-5)."""
    cfg, _, model = readers["gemma2"]
    ids, lens = _prompts("random", cfg.vocab_size)
    m = 30
    seg = torch.from_numpy(np.random.RandomState(4).randint(1, cfg.vocab_size, (3, 5)))
    caches, outs = [], []
    for _ in range(2):
        cache = pgen.init_cache(cfg, 3, m, torch.float32)
        slots = torch.arange(m)
        pgen.forward_with_cache(model, cfg, torch.from_numpy(ids), slots[:16].expand(3, 16), cache,
                                slots[None] < torch.from_numpy(lens)[:, None],
                                slots[None, :16] < torch.from_numpy(lens)[:, None])
        caches.append(cache)
    n = torch.from_numpy(lens)
    verify, _ = pgen.forward_with_cache(model, cfg, seg, n[:, None] + torch.arange(5), caches[0],
                                        torch.arange(m)[None] < (n + 5)[:, None], contiguous_writes=True)
    for j in range(5):
        step, _ = pgen.forward_with_cache(model, cfg, seg[:, j:j + 1], (n + j)[:, None], caches[1],
                                          torch.arange(m)[None] <= (n + j)[:, None])
        outs.append(step[:, 0])
    np.testing.assert_allclose(verify.numpy(), torch.stack(outs, 1).numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- sampling
def test_sampled_speculative_matches_sequential_distribution():
    """tests/test_speculative.py's setup: the joint distribution of the
    first two sampled tokens, speculative against the port's sequential
    sampler, within 0.06 total variation; seeds give different draws."""
    cfg = GPTNeoXConfig(vocab_size=8, hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32,
                        max_position_embeddings=64)
    model = params_from_jax(jax.tree.map(np.asarray, jneox.init_gpt_neox_params(jax_cfg(cfg),
                                                                                 jax.random.PRNGKey(2))), cfg)
    bsz, calls, temp = 150, 64, 1.3
    ids = torch.tensor(np.tile([3, 5, 2, 6], (bsz, 1)))
    lens = torch.full((bsz,), 4)
    static_fn = pgen.make_generate_fn(cfg, 2, eos_id=-1, temperature=temp)
    spec_fn = pspec.make_speculative_generate_fn(cfg, 2, eos_id=-1, draft_len=3, temperature=temp)

    def joint(fn, base):
        counts = np.zeros((8, 8), np.int64)
        for s in range(calls):
            toks = fn(model, ids, lens, base + s).numpy()
            np.add.at(counts, (toks[:, 0], toks[:, 1]), 1)
        return counts / counts.sum()

    tv = 0.5 * np.abs(joint(static_fn, 0) - joint(spec_fn, 10_000)).sum()
    assert tv < 0.06, f"total variation {tv:.3f} too large"
    assert not np.array_equal(spec_fn(model, ids, lens, 0).numpy(), spec_fn(model, ids, lens, 1).numpy())


# ---------------------------------------------------------------- the slot pool
CB_CFG = GPTNeoXConfig(vocab_size=97, **_SMALL)


@pytest.fixture(scope="module")
def cb_reader():
    tree = _tree(CB_CFG)
    return tree, params_from_jax(tree, CB_CFG)


def _jax_static_stream(tree, prompt, max_new):
    fn = jgen.make_generate_fn(jax_cfg(CB_CFG), max_new, EOS)
    toks = np.asarray(fn(tree, jnp.asarray([prompt], jnp.int32), jnp.asarray([len(prompt)], jnp.int32), 0))[0]
    toks = toks.tolist()[:max_new]
    return toks[: toks.index(EOS)] if EOS in toks else toks


def test_speculative_slot_pool_matches_jax(cb_reader):
    """tests/test_continuous_batching.py's workloads: mixed lengths with slot
    churn against the JAX speculative pool and the JAX static engine, a
    reused slot's history and cache isolated, and stop strings."""
    tree, model = cb_reader
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(1, 97, int(n)).tolist(), int(k)) for n, k in zip([9, 30, 5, 17, 12], [8, 5, 12, 7, 9])]
    spec = ContinuousBatcher(model, CB_CFG, EOS, slots=2, max_len=96, chunk=8, speculative=True, draft_len=4)
    jspec_pool = jcb.ContinuousBatcher(tree, jax_cfg(CB_CFG), EOS, slots=2, max_len=96, chunk=8, speculative=True,
                                       draft_len=4)
    out = spec.generate(reqs)
    assert out == jspec_pool.generate(reqs)
    assert out == [_jax_static_stream(tree, p, k) for p, k in reqs]
    assert spec.stats["spec_rounds"] > 0 and spec.stats["spec_emitted"] >= spec.stats["spec_rounds"]

    rng = np.random.RandomState(3)  # slot reuse
    first = [(rng.randint(1, 97, 40).tolist(), 8) for _ in range(2)]
    spec.generate(first)
    prompt = rng.randint(1, 97, 5).tolist()
    assert spec.generate([(prompt, 8)])[0] == _jax_static_stream(tree, prompt, 8)

    rng = np.random.RandomState(5)  # stop strings fire at a chunk boundary
    prompt = rng.randint(1, 97, 12).tolist()
    one = ContinuousBatcher(model, CB_CFG, EOS, slots=1, max_len=96, chunk=8, speculative=True, draft_len=3)
    ref = one.generate([(prompt, 20)])[0]
    assert ref == _jax_static_stream(tree, prompt, 20)
    needle = ref[2]
    stopped = one.generate([(prompt, 20)], stop_check=lambda i, toks: needle in toks)[0]
    assert needle in stopped and stopped == ref[: len(stopped)]


def test_speculative_slot_pool_builds_with_its_defaults(cb_reader):
    """``ContinuousBatcher(speculative=True)`` (which raised before slice 7)
    builds with the JAX defaults: draft_len 7, ngram 3, R = chunk // 4
    rounds a chunk, draft_len + 1 positions of headroom, a -1 history."""
    _, model = cb_reader
    pool = ContinuousBatcher(model, CB_CFG, EOS, speculative=True)
    assert (pool.draft_len, pool.ngram, pool.rounds, pool.headroom) == (7, 3, 4, 8)
    assert pool.hist.shape == (8, CB_CFG.max_position_embeddings) and (pool.hist == -1).all()


def test_speculative_slot_pool_raises_without_room(cb_reader):
    _, model = cb_reader
    with pytest.raises(ValueError):
        ContinuousBatcher(model, CB_CFG, EOS, max_len=40, speculative=True, draft_len=8)
    with pytest.raises(ValueError):
        ContinuousBatcher(model, CB_CFG, EOS, speculative=True, draft_len=0)


# ---------------------------------------------------------------- the reader backend
def test_reader_backend_speculative_engines_match_jax():
    """tests/test_speculative.py's reader: both speculative engines' texts
    equal JaxReaderLM's (and the static engine's), with stop strings and
    per-request max_gen_toks."""
    tok = make_word_tokenizer([" ".join(f"w{i}" for i in range(60))])
    cfg = GPTNeoXConfig(vocab_size=tok.vocab_size + 10, **_SMALL)
    tree = jax.tree.map(np.asarray, jneox.init_gpt_neox_params(jax_cfg(cfg), jax.random.PRNGKey(1)))
    model = params_from_jax(tree, cfg)
    reqs = [{"context": f"w{i} w{i + 1} w{i + 2} w{i} w{i + 1}",
             "gen_kwargs": {"until": ["\n"], "max_gen_toks": 6 + 2 * (i % 3)}} for i in range(5)]
    static = TorchReaderLM(model, cfg, tok, batch_size=2).generate_until(reqs)
    for engine in ("speculative", "continuous_spec"):
        got = TorchReaderLM(model, cfg, tok, batch_size=2, gen_engine=engine, draft_len=4).generate_until(reqs)
        want = JaxReaderLM(tree, jax_cfg(cfg), tok, batch_size=2, gen_engine=engine, draft_len=4).generate_until(reqs)
        assert got == want == static, engine
