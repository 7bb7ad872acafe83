"""Port parity: KV-cache generation, K3's plain version, the quantized
reader, continuous batching and the reader backend.

The JAX package and the port get the same tiny GPT-NeoX (2 layers, hidden
128, 2 heads, vocab 256; numpy weights carried across by
``params_from_jax``) and the same numpy inputs, in f32. Tolerances:
  * K3 plain vs the Pallas kernel in interpret mode: 1e-5;
  * float weights: greedy tokens equal, logits within 1e-4;
  * int8 weights: the port's int8 decode does not row-quantise x (K6, as
    the JAX TPU kernel), where JAX's CPU route does, so the port is held to
    JAX's float forward on the dequantized weights wq * scale, at 2e-2 of
    max |logit|;
  * temperature sampling: the distribution, not the tokens (torch.Generator
    is not jax.random).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_word_tokenizer
from retrieval_scaling_tpu.models import generate as jgen
from retrieval_scaling_tpu.models import gpt_neox as jneox
from retrieval_scaling_tpu.ops.flash_attention import flash_attention as jax_flash
from retrieval_scaling_tpu.rag_eval.models import JaxReaderLM
from retrieval_scaling_tpu_torch.models import generate as pgen
from retrieval_scaling_tpu_torch.models.continuous_batching import ContinuousBatcher, clamp_request
from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig
from retrieval_scaling_tpu_torch.models.hf_convert import params_from_jax
from retrieval_scaling_tpu_torch.ops.flash_attention import flash_decode, flash_decode_reference
from retrieval_scaling_tpu_torch.rag_eval.models import TorchReaderLM

torch.set_num_threads(1)
SIZES = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=512,
             max_position_embeddings=128)
CFG = GPTNeoXConfig(**SIZES)
JCFG = jneox.GPTNeoXConfig(**SIZES, attention_impl="xla")
EOS = 0


@pytest.fixture(scope="module")
def params():
    """A JAX GPT-NeoX tree (``init_gpt_neox_params``' layout) drawn with
    numpy: N(0, 0.02) weights, and biases and LayerNorms perturbed too."""
    rng = np.random.RandomState(0)
    d, h, hd, ff, v = 128, 2, 64, 512, 256
    n = lambda *shape: (0.02 * rng.randn(*shape)).astype(np.float32)  # noqa: E731
    one = lambda *shape: (1.0 + n(*shape)).astype(np.float32)  # noqa: E731
    layers = [{"ln1_scale": one(d), "ln1_bias": n(d), "qkv_w": n(d, 3, h, hd), "qkv_b": n(3, h, hd),
               "attn_out_w": n(h, hd, d), "attn_out_b": n(d), "ln2_scale": one(d), "ln2_bias": n(d),
               "mlp_in_w": n(d, ff), "mlp_in_b": n(ff), "mlp_out_w": n(ff, d), "mlp_out_b": n(d)} for _ in range(2)]
    return {"embed_in": n(v, d), "final_ln_scale": one(d), "final_ln_bias": n(d), "embed_out": n(d, v),
            "layers": layers}


@pytest.fixture(scope="module")
def model(params):
    return params_from_jax(params, CFG)


def _prompts(seed, lens, width=None):
    rng = np.random.RandomState(seed)
    width = width or max(lens)
    ids = np.zeros((len(lens), width), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 256, n)
    return ids, np.asarray(lens)


_jax_forward = jax.jit(jgen.forward_with_cache, static_argnums=(1,))


def _jax_tokens(params, ids, lens, max_new, **kw):
    fn = jgen.make_generate_fn(JCFG, max_new, EOS, **kw)
    return np.asarray(fn(params, jnp.asarray(ids, jnp.int32), jnp.asarray(lens, jnp.int32), 0))


def _port_tokens(model, ids, lens, max_new, **kw):
    return pgen.make_generate_fn(CFG, max_new, EOS, **kw)(model, torch.from_numpy(ids), torch.from_numpy(lens)).numpy()


# ---------------------------------------------------------------- K3
@pytest.mark.parametrize("dtype", [np.float32])
def test_k3_plain_matches_jax_kernel_decode_rows(dtype):
    """Sq = 1 rows against a masked 256-slot cache, n_rep 2 (GQA), one row
    with no visible key (exactly 0 in both)."""
    rng = np.random.RandomState(1)
    b, h, hkv, m, d = 3, 4, 2, 256, 64
    q = rng.randn(b, h, 1, d).astype(dtype)
    k, v = (rng.randn(b, hkv, m, d).astype(dtype) for _ in range(2))
    mask = np.arange(m)[None, :] < np.array([256, 77, 0])[:, None]
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask),
                               interpret=True))
    out = flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert (out[2] == 0).all()


@pytest.mark.parametrize("d,cap", [(64, 50.0), (96, 30.0)])
def test_k3_plain_soft_cap_matches_jax_kernel(d, cap):
    """K3's soft-cap (Gemma-2 decode) against the Pallas kernel's: GQA rows
    against a masked cache, one row with no visible key; 1e-5. q is scaled
    so that the scores spread to about cap / 2 and the cap changes the
    output (checked against the uncapped plain version)."""
    rng = np.random.RandomState(d)
    b, h, hkv, m = 2, 4, 2, 200
    q = (cap / 2 * rng.randn(b, h, 1, d)).astype(np.float32)
    k, v = (rng.randn(b, hkv, m, d).astype(np.float32) for _ in range(2))
    mask = np.arange(m)[None, :] < np.array([150, 0])[:, None]
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask=jnp.asarray(mask),
                               logit_cap=cap, interpret=True))
    out = flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask),
                       logit_cap=cap)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert (out[1] == 0).all()
    uncapped = flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask))
    assert (uncapped - out).abs().max().item() > 0.1


# ---------------------------------------------------------------- float weights
def test_forward_with_cache_logits_match_jax(params, model):
    """Prefill with pads and one decode step: logits within 1e-4."""
    ids, lens = _prompts(2, [12, 7])
    m = 16
    jcache = jgen.init_cache(JCFG, 2, m, dtype=jnp.float32)
    pcache = pgen.init_cache(CFG, 2, m, dtype=torch.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    valid = np.arange(m)[None, :] < lens[:, None]
    wmask = np.arange(12)[None, :] < lens[:, None]
    jl, jcache = _jax_forward(params, JCFG, jnp.asarray(ids), jnp.asarray(pos), jcache,
                                         jnp.asarray(valid), jnp.asarray(wmask))
    pl, pcache = pgen.forward_with_cache(model, CFG, torch.from_numpy(ids), torch.from_numpy(pos.copy()), pcache,
                                         torch.from_numpy(valid), torch.from_numpy(wmask))
    for r, n in enumerate(lens):
        np.testing.assert_allclose(pl[r, :n].numpy(), np.asarray(jl)[r, :n], atol=1e-4)
    nxt = np.array([[5], [9]])
    valid2 = np.arange(m)[None, :] < (lens + 1)[:, None]
    jl2, _ = _jax_forward(params, JCFG, jnp.asarray(nxt), jnp.asarray(lens[:, None]), jcache,
                                     jnp.asarray(valid2))
    pl2, _ = pgen.forward_with_cache(model, CFG, torch.from_numpy(nxt), torch.from_numpy(lens[:, None].copy()),
                                     pcache, torch.from_numpy(valid2))
    np.testing.assert_allclose(pl2.numpy(), np.asarray(jl2), atol=1e-4)


@pytest.mark.parametrize("kv_cache", [None, "int8"])
def test_greedy_tokens_match_jax(params, model, kv_cache):
    ids, lens = _prompts(3, [20, 13, 7])
    assert np.array_equal(_port_tokens(model, ids, lens, 10, kv_cache=kv_cache),
                          _jax_tokens(params, ids, lens, 10, kv_cache=kv_cache))


def test_temperature_sampling_follows_the_softmax(params, model):
    """The first sampled token of 4,000 copies of one prompt follows
    softmax(logits / T) of the JAX forward: Pearson's chi-square over the
    256 tokens stays within 6 standard deviations of its 255 degrees of
    freedom, and the argmax token (greedy's choice) is not what it draws."""
    ids, lens = _prompts(4, [9])
    t = 0.7
    toks = _port_tokens(model, np.repeat(ids, 4000, 0), np.repeat(lens, 4000), 1, temperature=t)[:, 0]
    logits = np.asarray(jax.jit(jneox.gpt_neox_forward, static_argnums=1)(params, JCFG, jnp.asarray(ids)))[0, 8] / t
    p = np.exp(logits - logits.max())
    p /= p.sum()
    expected = p * len(toks)
    chi2 = ((np.bincount(toks, minlength=256) - expected) ** 2 / expected).sum()
    assert chi2 < 255 + 6 * np.sqrt(2 * 255), chi2
    assert (toks != p.argmax()).mean() > 0.5


# ---------------------------------------------------------------- quantized weights
def test_quantize_decode_params_matches_jax(params, model):
    """Same wq bit for bit, scales within one f32 ulp, same layout."""
    ours = pgen.quantize_decode_params(model, CFG)
    theirs = params_from_jax(jax.tree.map(np.asarray, jgen.quantize_decode_params(params, JCFG)), CFG)
    for a, b in [(ours.q8, theirs.q8)] + [(x.q8, y.q8) for x, y in zip(ours.layers, theirs.layers)]:
        assert a.keys() == b.keys()
        for key in a:
            if a[key].dtype == torch.int8:
                assert torch.equal(a[key], b[key]), key
            else:
                np.testing.assert_array_max_ulp(a[key].numpy(), b[key].numpy(), maxulp=1)


def _dequantized_tree(params, qtree):
    """The JAX float tree whose projection weights are wq * scale."""
    d, h, hd = JCFG.hidden_size, JCFG.num_heads, JCFG.head_dim
    out = dict(params, layers=[])
    for layer, ql in zip(params["layers"], qtree["layers"]):
        w = np.asarray(ql["qkv_mi@q8"], np.float32) * np.asarray(ql["qkv_mi@s"])
        ao = np.asarray(ql["ao_mo@q8"], np.float32)
        new = dict(layer, qkv_w=w[:, : 3 * d].reshape(d, 3, h, hd), mlp_in_w=w[:, 3 * d:],
                   attn_out_w=(ao[:d] * np.asarray(ql["ao_mo@sa"])).reshape(h, hd, d),
                   mlp_out_w=ao[d:] * np.asarray(ql["ao_mo@sb"]))
        out["layers"].append(new)
    out["embed_out"] = np.asarray(qtree["embed_out@q8"], np.float32) * np.asarray(qtree["embed_out@s"])
    return out


@pytest.mark.parametrize("scheme", ["int8", "bf16"])
def test_quantized_decode_matches_jax_on_dequantized_weights(params, model, scheme):
    qtree = jax.tree.map(np.asarray, jgen.quantize_decode_params(params, JCFG, scheme=scheme))
    ref_tree = _dequantized_tree(params, qtree)
    qmodel = pgen.quantize_decode_params(model, CFG, scheme=scheme)
    ids, lens = _prompts(5, [10, 6])
    m = 12
    jcache = jgen.init_cache(JCFG, 2, m, dtype=jnp.float32)
    pcache = pgen.init_cache(CFG, 2, m, dtype=torch.float32)
    pos = np.broadcast_to(np.arange(10), (2, 10)).copy()
    valid = np.arange(m)[None, :] < lens[:, None]
    wmask = np.arange(10)[None, :] < lens[:, None]
    _, jcache = _jax_forward(ref_tree, JCFG, jnp.asarray(ids), jnp.asarray(pos), jcache,
                                        jnp.asarray(valid), jnp.asarray(wmask))
    _, pcache = pgen.forward_with_cache(qmodel, CFG, torch.from_numpy(ids), torch.from_numpy(pos), pcache,
                                        torch.from_numpy(valid), torch.from_numpy(wmask))
    nxt, valid2 = np.array([[3], [4]]), np.arange(m)[None, :] < (lens + 1)[:, None]
    jl, _ = _jax_forward(ref_tree, JCFG, jnp.asarray(nxt), jnp.asarray(lens[:, None]), jcache,
                                    jnp.asarray(valid2))
    pl, _ = pgen.forward_with_cache(qmodel, CFG, torch.from_numpy(nxt), torch.from_numpy(lens[:, None].copy()),
                                    pcache, torch.from_numpy(valid2))
    jl = np.asarray(jl)
    assert np.abs(pl.numpy() - jl).max() <= 2e-2 * np.abs(jl).max()


def test_int4_scheme_waits_for_k8(model, params):
    """The int4 scheme is K8's: per-weight ``@q4`` / ``@s4g`` streams (no
    fused layout), the same bytes as the JAX scheme, and greedy tokens equal
    to JAX's int4 reader (the plain K8 arithmetic on the CPU)."""
    ours = pgen.quantize_decode_params(model, CFG, scheme="int4")
    assert set(ours.layers[0].q8) == {f"{n}_w@{s}" for n in ("qkv", "attn_out", "mlp_in", "mlp_out")
                                      for s in ("q4", "s4g")} | {"qkv_b", "attn_out_b", "mlp_in_b", "mlp_out_b"}
    qtree = jax.tree.map(np.asarray, jgen.quantize_decode_params(params, JCFG, scheme="int4"))
    theirs = params_from_jax(qtree, CFG)
    for a, b in [(ours.q8, theirs.q8), (ours.layers[1].q8, theirs.layers[1].q8)]:
        for key in a:
            assert torch.equal(a[key], b[key]) if a[key].dtype == torch.uint8 else torch.allclose(a[key], b[key])
    ids, lens = _prompts(11, [20, 13, 7])
    assert np.array_equal(_port_tokens(ours, ids, lens, 10), _jax_tokens(qtree, ids, lens, 10))
    with pytest.raises(ValueError):
        pgen.quantize_decode_params(model, CFG, scheme="int2")


# ---------------------------------------------------------------- continuous batching
def _jax_static(params, requests, **kw):
    """JAX static greedy tokens of each request (one right-padded batch),
    cut at its budget and its first eos."""
    ids, lens = _prompts(0, [len(p) for p, _ in requests])
    for r, (prompt, _) in enumerate(requests):
        ids[r, : len(prompt)] = prompt
    toks = _jax_tokens(params, ids, lens, max(k for _, k in requests), **kw)
    out = []
    for row, (_, max_new) in zip(toks.tolist(), requests):
        row = row[:max_new]
        out.append(row[: row.index(EOS)] if EOS in row else row)
    return out


def test_continuous_batcher_matches_jax_static_greedy(params, model):
    """Mixed lengths, fewer slots than requests (slot reuse), token-exact
    against the JAX static engine; and clamp_request equals JAX's."""
    from retrieval_scaling_tpu.models.continuous_batching import clamp_request as jclamp

    rng = np.random.RandomState(6)
    requests = [(rng.randint(1, 256, int(rng.randint(3, 20))).tolist(), int(rng.choice([4, 8, 12])))
                for _ in range(6)]
    outs = ContinuousBatcher(model, CFG, EOS, slots=3, max_len=64, chunk=4).generate(requests)
    assert outs == _jax_static(params, requests)
    for args in (([1] * 100, 70, 64), ([1] * 5, 3, 64), ([1] * 40, 64, 64)):
        assert clamp_request(*args) == jclamp(*args)


def test_continuous_batcher_with_int8_cache_matches_jax_static(params, model):
    rng = np.random.RandomState(7)
    requests = [(rng.randint(1, 256, n).tolist(), k) for n, k in ((15, 6), (4, 9), (9, 5))]
    outs = ContinuousBatcher(model, CFG, EOS, slots=2, max_len=48, chunk=4, dtype=torch.int8).generate(requests)
    assert outs == _jax_static(params, requests, kv_cache="int8")


def test_speculative_and_mesh_raise(model):
    """A mesh (module 14) still raises in both generation engines; the
    speculative slot pool runs since slice 7 (tests/test_torch_speculative.py
    holds it, with ``test_speculative_slot_pool_builds_with_its_defaults``)."""
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(model, CFG, EOS, speculative=True, mesh=object())
    with pytest.raises(NotImplementedError):
        pgen.make_generate_fn(CFG, 4, EOS, mesh=object())


# ---------------------------------------------------------------- reader backend
@pytest.fixture(scope="module")
def readers(params):
    words = [f"w{i}" for i in range(250)]
    tok = make_word_tokenizer([" ".join(words)])
    cfg_kw = dict(SIZES, vocab_size=256)
    jcfg = jneox.GPTNeoXConfig(**cfg_kw, attention_impl="xla")
    return tok, jcfg, params


def _requests(seed):
    rng = np.random.RandomState(seed)
    ctx = [" ".join(f"w{i}" for i in rng.randint(3, 250, int(rng.randint(5, 40)))) for _ in range(5)]
    gen = [{"context": c, "gen_kwargs": {"max_gen_toks": int(rng.choice([3, 6])), "until": ["w7"]}} for c in ctx]
    pairs = [(c, " w5 w9") for c in ctx] + [("", "w3 w4")]
    return gen, pairs, ctx


@pytest.mark.parametrize("gen_engine", ["static", "continuous"])
def test_reader_backend_matches_jax_reader(readers, model, gen_engine):
    tok, jcfg, params = readers
    jlm = JaxReaderLM(params, jcfg, tok, batch_size=4, gen_engine=gen_engine)
    plm = TorchReaderLM(model, CFG, tok, batch_size=4, gen_engine=gen_engine)
    gen, pairs, ctx = _requests(8)
    assert plm.generate_until(gen) == jlm.generate_until(gen)
    if gen_engine == "static":
        for (a, ga), (b, gb) in zip(plm.loglikelihood(pairs), jlm.loglikelihood(pairs)):
            assert abs(a - b) <= 1e-4 * max(1.0, abs(b)) and ga == gb
        np.testing.assert_allclose(plm.loglikelihood_rolling(ctx[:2]), jlm.loglikelihood_rolling(ctx[:2]),
                                   rtol=1e-5)


def test_reader_backend_int8_scores_near_float(readers, model):
    tok, _, _ = readers
    gen, pairs, _ = _requests(9)
    floats = TorchReaderLM(model, CFG, tok, batch_size=4).loglikelihood(pairs)
    q8 = TorchReaderLM(model, CFG, tok, batch_size=4, quantization="int8", kv_cache="int8")
    for (a, _), (b, _) in zip(q8.loglikelihood(pairs), floats):
        assert abs(a - b) <= 2e-2 * max(1.0, abs(b))
    assert len(q8.generate_until(gen)) == len(gen)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K3 kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,h,hkv,sq,m,d", [(8, 8, 8, 1, 1024, 256), (1, 8, 2, 1, 2048, 128),
                                             (2, 4, 1, 3, 300, 64), (3, 16, 2, 1, 100, 128)])
def test_k3_kernel_matches_plain_on_cuda(cuda_device, dtype, b, h, hkv, sq, m, d):
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn(b, hkv, m, d, generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    lengths = torch.randint(1, m + 1, (b,), generator=gen, device=cuda_device)
    lengths[-1] = 0 if b > 1 else lengths[-1]
    mask = torch.arange(m, device=cuda_device)[None, :] < lengths[:, None]
    out = flash_decode(q, k, v, kv_mask=mask)
    ref = flash_decode_reference(q.float(), k.float(), v.float(), kv_mask=mask)
    torch.cuda.synchronize()
    # f32: 1e-4 of max |y|; bf16 / fp16: 1e-2 of max |y|, a few ulps of the
    # output's rounding at its own scale
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    if b > 1:
        assert (out[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,m,d,cap", [(8, 16, 8, 1, 4096, 256, 50.0), (2, 32, 32, 1, 300, 96, 30.0),
                                                (3, 8, 2, 2, 1000, 96, None)])
def test_k3_soft_cap_and_head_dim_96_match_plain_on_cuda(cuda_device, dtype, b, h, hkv, sq, m, d, cap):
    """K3 with Gemma-2's cap (a window folded into the key mask) and with
    Phi-3's head dim, against the plain version: 1e-4 (f32) / 1e-2 (bf16)
    of max |y|. With a cap, q is scaled so that the scores spread to about
    cap / 2: there the plain version's capped and uncapped outputs differ by
    more than ten times the limit, so a kernel without the cap fails."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + d)
    q = (torch.randn(b, h, sq, d, generator=gen, device=cuda_device) * (cap / 2 if cap else 3.0)).to(dtype)
    k, v = (torch.randn(b, hkv, m, d, generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    lengths = torch.randint(m // 2, m + 1, (b,), generator=gen, device=cuda_device)
    slots = torch.arange(m, device=cuda_device)[None, :]
    mask = (slots < lengths[:, None]) & (slots > lengths[:, None] - 1 - m // 3)  # a window of m // 3
    before = (flash_decode.launches, flash_decode.cap_launches)
    out = flash_decode(q, k, v, kv_mask=mask, logit_cap=cap)
    ref = flash_decode_reference(q.float(), k.float(), v.float(), kv_mask=mask, logit_cap=cap)
    torch.cuda.synchronize()
    assert (flash_decode.launches, flash_decode.cap_launches) == (before[0] + 1, before[1] + bool(cap))
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    if cap:
        uncapped = flash_decode_reference(q.float(), k.float(), v.float(), kv_mask=mask)
        assert (uncapped - ref).abs().max().item() > 10 * tol
