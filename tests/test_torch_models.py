"""Port parity: BERT, GPT-NeoX, the blockwise loss, HF I/O and the tokenizer.

The JAX package's models and the port's get the same parameters (numpy,
carried across by ``params_from_jax``) and the same inputs, in f32.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from helpers import make_word_tokenizer
from retrieval_scaling_tpu.models import bert as jbert
from retrieval_scaling_tpu.models import gpt_neox as jneox
from retrieval_scaling_tpu.models.loss import blockwise_row_lm_loss as jax_blockwise
from retrieval_scaling_tpu_torch.evals.perplexity import make_row_loss_fn
from retrieval_scaling_tpu_torch.models.bert import BertConfig, contriever_embed
from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig, gpt_neox_forward, neox_logits
from retrieval_scaling_tpu_torch.models.hf_convert import (
    WordLevelTokenizer,
    bert_params_from_state_dict,
    gpt_neox_params_from_state_dict,
    hf_config_from_cfg,
    hf_state_dict_from_params,
    load_hf_encoder,
    load_hf_reader,
    load_tokenizer,
    params_from_jax,
    save_hf_checkpoint,
)
from retrieval_scaling_tpu_torch.models.loss import blockwise_row_lm_loss

torch.set_num_threads(1)
ATOL = 1e-4


def _randomized(tree, seed):
    """JAX init leaves biases at 0 and LayerNorms at 1; perturb every leaf so
    a mis-mapped bias or scale cannot hide."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32) + 0.02 * rng.randn(*x.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def bert_pair():
    jcfg = jbert.BertConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position_embeddings=64, attention_impl="xla",
    )
    params = _randomized(jbert.init_bert_params(jcfg, jax.random.PRNGKey(0)), 0)
    cfg = BertConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position_embeddings=64,
    )
    return jcfg, params, cfg, params_from_jax(params, cfg)


@pytest.fixture(scope="module")
def neox_pair():
    jcfg = jneox.GPTNeoXConfig(
        vocab_size=101, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position_embeddings=64, attention_impl="xla",
    )
    params = _randomized(jneox.init_gpt_neox_params(jcfg, jax.random.PRNGKey(1)), 1)
    cfg = GPTNeoXConfig(
        vocab_size=101, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
        max_position_embeddings=64,
    )
    return jcfg, params, cfg, params_from_jax(params, cfg)


def _bert_inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 97, size=(3, 20))
    mask = np.ones_like(ids)
    mask[1, 12:] = 0
    mask[2, 5:] = 0
    return ids, mask


@pytest.mark.parametrize("normalize", [False, True])
def test_bert_matches_jax(bert_pair, normalize):
    jcfg, params, _, model = bert_pair
    ids, mask = _bert_inputs()
    jparams = jax.tree.map(jnp.asarray, params)
    ref_hidden = np.asarray(jbert.bert_encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    ref_emb = np.asarray(jbert.contriever_embed(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), normalize=normalize))
    with torch.no_grad():
        hidden = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        emb = contriever_embed(model, torch.from_numpy(ids), torch.from_numpy(mask), normalize=normalize).numpy()
    np.testing.assert_allclose(hidden, ref_hidden, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(emb, ref_emb, atol=ATOL, rtol=ATOL)


def test_gpt_neox_matches_jax(neox_pair):
    jcfg, params, _, model = neox_pair
    ids = np.random.RandomState(1).randint(0, 101, size=(2, 24))
    ref = np.asarray(jneox.gpt_neox_forward(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids)))
    with torch.no_grad():
        logits = gpt_neox_forward(model, torch.from_numpy(ids))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref, atol=ATOL, rtol=ATOL)


def test_blockwise_loss_matches_dense_and_jax(neox_pair):
    jcfg, params, cfg, model = neox_pair
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 101, size=(3, 37))
    labels = ids.copy()
    labels[0, :10] = -100
    labels[2, 30:] = -100
    t_ids, t_lab = torch.from_numpy(ids), torch.from_numpy(labels)
    with torch.no_grad():
        dense_sum, dense_cnt = make_row_loss_fn(cfg)(model, t_ids, t_lab)  # CPU: the dense path
        hidden = gpt_neox_forward(model, t_ids, return_hidden=True)
        blk_sum, blk_cnt = blockwise_row_lm_loss(lambda h: neox_logits(model, h), hidden, t_lab, block=16)
    jparams = jax.tree.map(jnp.asarray, params)
    jhidden = jneox.gpt_neox_forward(jparams, jcfg, jnp.asarray(ids), return_hidden=True)
    ref_sum, ref_cnt = jax_blockwise(lambda h: jneox.neox_logits(jparams, h), jhidden, jnp.asarray(labels), block=16)
    np.testing.assert_array_equal(blk_cnt.numpy(), dense_cnt.numpy())
    np.testing.assert_array_equal(blk_cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_allclose(blk_sum.numpy(), dense_sum.numpy(), rtol=1e-5)
    np.testing.assert_allclose(blk_sum.numpy(), np.asarray(ref_sum), rtol=ATOL)


def test_bert_hf_round_trip_and_transformers_parity(bert_pair, tmp_path):
    _, _, cfg, model = bert_pair
    sd = hf_state_dict_from_params(model)
    back = bert_params_from_state_dict(sd, cfg)
    for (k, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k

    hf = transformers.BertModel(transformers.BertConfig(**hf_config_from_cfg(cfg)), add_pooling_layer=False)
    hf.load_state_dict(sd, strict=True)
    hf.eval()
    ids, mask = _bert_inputs()
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
        ours = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)

    save_hf_checkpoint(model, str(tmp_path / "contriever"))
    loaded = load_hf_encoder(str(tmp_path / "contriever"))
    assert loaded.cfg == cfg
    hf2 = transformers.AutoModel.from_pretrained(str(tmp_path / "contriever"))
    hf2.eval()
    with torch.no_grad():
        ref2 = hf2(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
        ours2 = loaded(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(ours2.numpy(), ref2.numpy(), atol=ATOL, rtol=ATOL)


def test_gpt_neox_hf_round_trip_and_transformers_parity(neox_pair, tmp_path):
    _, _, cfg, model = neox_pair
    sd = hf_state_dict_from_params(model)
    back = gpt_neox_params_from_state_dict(sd, cfg)
    for (k, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k

    save_hf_checkpoint(model, str(tmp_path / "pythia"))
    loaded = load_hf_reader(str(tmp_path / "pythia"))
    assert loaded.cfg == cfg
    hf = transformers.AutoModelForCausalLM.from_pretrained(str(tmp_path / "pythia"))
    hf.eval()
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 101, size=(2, 24)))
    with torch.no_grad():
        ref = hf(input_ids=ids).logits
        ours = gpt_neox_forward(loaded, ids)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL, rtol=ATOL)


TEXTS = [
    "the quick brown fox, jumps over the lazy dog.",
    "it's a test: 3 words (or more) -- and a_b_c_term_7!",
]


def test_word_tokenizer_matches_hf(tmp_path):
    hf_tok = make_word_tokenizer(TEXTS[:1])
    hf_tok.save_pretrained(str(tmp_path / "hf"))
    ours = WordLevelTokenizer.from_pretrained(str(tmp_path / "hf"))
    assert (ours.vocab_size, ours.pad_token_id, ours.eos_token_id) == (
        hf_tok.vocab_size, hf_tok.pad_token_id, hf_tok.eos_token_id,
    )
    for text in TEXTS:
        ids = hf_tok(text)["input_ids"]
        assert ours(text)["input_ids"] == ids
        assert ours.decode(ids) == hf_tok.decode(ids)
        assert ours.decode(ids, skip_special_tokens=True) == hf_tok.decode(ids, skip_special_tokens=True)
    batch = dict(max_length=5, truncation=True, padding=False)
    assert ours(TEXTS, **batch)["input_ids"] == hf_tok(TEXTS, **batch)["input_ids"]

    # what the port writes, transformers reads with the same ids
    ours.save_pretrained(str(tmp_path / "ours"))
    back = transformers.AutoTokenizer.from_pretrained(str(tmp_path / "ours"))
    for text in TEXTS:
        assert back(text)["input_ids"] == ours(text)["input_ids"]
    assert (back.pad_token_id, back.eos_token_id) == (ours.pad_token_id, ours.eos_token_id)


def test_load_tokenizer_without_transformers(tmp_path, monkeypatch):
    make_word_tokenizer(TEXTS).save_pretrained(str(tmp_path))
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, WordLevelTokenizer)

    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    spec["normalizer"] = {"type": "Lowercase"}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError):
        load_tokenizer(str(tmp_path))
