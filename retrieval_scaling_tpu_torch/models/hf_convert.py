"""HuggingFace checkpoints <-> the port's modules, and tokenizer loading.

Ports the BERT, GPT-NeoX, llama-family and T5 halves of
``retrieval_scaling_tpu/models/hf_convert.py``:

* configs from a ``config.json`` dict (``bert_config_from_hf``,
  ``gpt_neox_config_from_hf``, ``llama_config_from_hf``) and back
  (``hf_config_from_cfg``). The JAX package reads the config through
  ``transformers``' config classes, which fill in what a ``config.json``
  leaves out; the port reads the plain dict, so ``_LLAMA_DEFAULTS`` holds
  those class defaults (Gemma-2's alternating ``layer_types`` and caps,
  Mistral's 4096-token window, Qwen2's QKV bias, each family's eps);
* HF state dicts (``pytorch_model.bin``, read by ``torch.load``) to modules
  (``bert_params_from_state_dict``, ``gpt_neox_params_from_state_dict``,
  ``llama_params_from_state_dict``: Phi-3's fused ``qkv_proj`` /
  ``gate_up_proj`` split, Gemma-2's four norms, OLMo-1's missing norm
  weights) and back (``hf_state_dict_from_params``), so random-weight
  checkpoints in the real HF layout can be written without ``transformers``;
* ``params_from_jax``: the JAX package's parameter trees (as numpy) to the
  port's modules, which carries weights across for the parity tests; a BERT
  tree from the JAX ``quantize_bert_params`` keeps its int8 FFN bytes
  (``Int8Linear``); a
  tree that went through the JAX ``quantize_decode_params`` (``@q8`` /
  ``@s`` / ``@sa`` / ``@sb`` and int4 ``@q4`` / ``@s4g`` keys) becomes a
  ``QuantizedGPTNeoX`` or ``QuantizedLlama`` in the same ``[K, N]`` layout,
  with the ``@padcols`` columns sliced off;
* ``load_hf_reader`` and the ``reader_*`` helpers dispatch on the model
  type (GPT-NeoX, or the llama family of ``_LLAMA_MODEL_TYPES``);
* the GTR (T5) encoder: ``t5_config_from_hf`` (with ``T5Config``'s
  defaults for keys a ``config.json`` leaves out),
  ``t5_encoder_params_from_state_dict``, ``load_sentence_transformers_projection``
  (a local ``*_Dense`` module's weight as ``[in, out]``) and
  ``load_hf_t5_encoder``; ``save_hf_checkpoint`` writes a T5 encoder as a
  ``T5EncoderModel`` checkpoint plus a ``2_Dense`` module;
* ``load_tokenizer``: ``transformers.AutoTokenizer`` when it can be imported,
  otherwise ``WordLevelTokenizer``, which reads only the WordLevel +
  Whitespace ``tokenizer.json`` that ``tests/helpers.py`` builds.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from retrieval_scaling_tpu_torch.models.bert import BertConfig, BertModel
from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoX, GPTNeoXConfig, gpt_neox_forward, neox_logits
from retrieval_scaling_tpu_torch.models.llama import Llama, LlamaConfig, llama_forward, llama_logits
from retrieval_scaling_tpu_torch.models.t5 import T5Encoder, T5EncoderConfig

CHECKPOINT_FILE = "pytorch_model.bin"


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
def bert_config_from_hf(hf_config: Mapping[str, Any], pooling: str = "mean") -> BertConfig:
    if hf_config.get("model_type", "bert") != "bert":
        raise NotImplementedError(f"encoder model_type {hf_config.get('model_type')!r} is not ported yet")
    return BertConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        type_vocab_size=hf_config["type_vocab_size"],
        layer_norm_eps=hf_config["layer_norm_eps"],
        pooling=pooling,
    )


def gpt_neox_config_from_hf(hf_config: Mapping[str, Any]) -> GPTNeoXConfig:
    if hf_config.get("model_type", "gpt_neox") != "gpt_neox":
        raise NotImplementedError(f"reader model_type {hf_config.get('model_type')!r} is not ported yet")
    return GPTNeoXConfig(
        vocab_size=hf_config["vocab_size"],
        hidden_size=hf_config["hidden_size"],
        num_layers=hf_config["num_hidden_layers"],
        num_heads=hf_config["num_attention_heads"],
        intermediate_size=hf_config["intermediate_size"],
        max_position_embeddings=hf_config["max_position_embeddings"],
        rotary_pct=hf_config["rotary_pct"],
        rotary_base=hf_config.get("rotary_emb_base", 10000.0),
        layer_norm_eps=hf_config["layer_norm_eps"],
        use_parallel_residual=hf_config["use_parallel_residual"],
    )


# --------------------------------------------------------------------------
# llama family (Llama 1/2/3, Mistral, Qwen2/2.5, Qwen3, Gemma, Gemma-2, OLMo-1/2, Phi-3)
# --------------------------------------------------------------------------
_LLAMA_MODEL_TYPES = (
    "llama", "mistral", "qwen2", "qwen3", "gemma", "gemma2", "olmo", "olmo2", "phi3",
)

# What transformers' config class of each family (4.57) sets for a key that
# config.json leaves out, for the keys the JAX package reads with getattr.
_LLAMA_DEFAULTS = {
    "llama": {"rms_norm_eps": 1e-6},
    "mistral": {"rms_norm_eps": 1e-6, "sliding_window": 4096, "num_key_value_heads": 8},
    "qwen2": {"rms_norm_eps": 1e-6, "num_key_value_heads": 32},
    "qwen3": {"rms_norm_eps": 1e-6, "head_dim": 128, "num_key_value_heads": 32},
    "gemma": {"rms_norm_eps": 1e-6, "head_dim": 256, "tie_word_embeddings": True, "num_key_value_heads": 16},
    "gemma2": {"rms_norm_eps": 1e-6, "head_dim": 256, "tie_word_embeddings": True, "sliding_window": 4096,
               "query_pre_attn_scalar": 256, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
               "num_key_value_heads": 4},
    "olmo": {},
    "olmo2": {},
    "phi3": {},
}


def _sliding_pattern(hf: Mapping[str, Any], model_type: str, n_layers: int):
    if model_type == "gemma2":
        # the class default: even layers slide, odd layers are global
        types = hf.get("layer_types") or [
            "sliding_attention" if (i + 1) % 2 else "full_attention" for i in range(n_layers)
        ]
        return tuple(t == "sliding_attention" for t in types)
    if model_type in ("mistral", "phi3") and hf.get("sliding_window"):
        return (True,) * n_layers
    return None


def llama_config_from_hf(hf_config: Mapping[str, Any]) -> LlamaConfig:
    """A ``LlamaConfig`` from a llama-family ``config.json`` dict, with the
    JAX ``llama_config_from_hf``'s reading of the same config class."""
    model_type = hf_config.get("model_type", "llama")
    if model_type not in _LLAMA_MODEL_TYPES:
        raise NotImplementedError(f"reader model_type {model_type!r} is not in the llama family")
    hf = {**_LLAMA_DEFAULTS[model_type], **hf_config}
    if model_type == "llama":  # the class derives head_dim
        hf.setdefault("head_dim", hf["hidden_size"] // hf["num_attention_heads"])
    rope_scaling = hf.get("rope_scaling") or {}
    n_layers = hf["num_hidden_layers"]
    gemma = model_type in ("gemma", "gemma2")
    return LlamaConfig(
        rope_scaling_type=rope_scaling.get("rope_type", rope_scaling.get("type", None)),
        rope_factor=float(rope_scaling.get("factor", 1.0)),
        rope_low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
        rope_high_freq_factor=float(rope_scaling.get("high_freq_factor", 4.0)),
        rope_original_max_pos=int(rope_scaling.get("original_max_position_embeddings", 8192)),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=n_layers,
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads") or hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        head_dim=hf.get("head_dim"),
        rope_base=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        attention_bias=hf.get("attention_bias", model_type == "qwen2"),  # Qwen2's bias predates the field
        qk_norm=model_type == "qwen3",
        tie_embeddings=hf.get("tie_word_embeddings", False),
        hidden_act="gelu_tanh" if gemma else "silu",
        rms_norm_offset=gemma,
        embedding_multiplier=float(hf["hidden_size"]) ** 0.5 if gemma else 1.0,
        attn_logit_softcap=hf.get("attn_logit_softcapping"),
        final_logit_softcap=hf.get("final_logit_softcapping"),
        query_pre_attn_scalar=hf.get("query_pre_attn_scalar"),
        sliding_window=hf.get("sliding_window") if model_type in ("gemma2", "mistral", "phi3") else None,
        sliding_pattern=_sliding_pattern(hf, model_type, n_layers),
        norm_type="layernorm_np" if model_type == "olmo" else "rms",
        norm_placement="post_output" if model_type == "olmo2" else "pre_post" if model_type == "gemma2" else "pre",
        clip_qkv=hf.get("clip_qkv"),
        qk_norm_full=model_type == "olmo2",
    )


def _llama_model_type(cfg: LlamaConfig) -> str:
    """The HF model type whose config class reads back as ``cfg``."""
    if cfg.norm_placement == "pre_post":
        return "gemma2"
    if cfg.rms_norm_offset:
        return "gemma"
    if cfg.norm_placement == "post_output":
        return "olmo2"
    if cfg.norm_type == "layernorm_np":
        return "olmo"
    if cfg.qk_norm:
        return "qwen3"
    if cfg.sliding_pattern is not None:
        return "mistral"
    return "qwen2" if cfg.attention_bias else "llama"


def _llama_hf_config(cfg: LlamaConfig) -> Dict[str, Any]:
    model_type = _llama_model_type(cfg)
    arch = {"llama": "LlamaForCausalLM", "mistral": "MistralForCausalLM", "qwen2": "Qwen2ForCausalLM",
            "qwen3": "Qwen3ForCausalLM", "gemma": "GemmaForCausalLM", "gemma2": "Gemma2ForCausalLM",
            "olmo": "OlmoForCausalLM", "olmo2": "Olmo2ForCausalLM"}[model_type]
    out = {
        "architectures": [arch], "model_type": model_type,
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "intermediate_size": cfg.intermediate_size, "max_position_embeddings": cfg.max_position_embeddings,
        "rope_theta": cfg.rope_base, "rms_norm_eps": cfg.rms_eps,
        "attention_bias": cfg.attention_bias, "tie_word_embeddings": cfg.tie_embeddings,
        "hidden_act": "gelu_pytorch_tanh" if cfg.hidden_act == "gelu_tanh" else "silu",
        "rope_scaling": None, "initializer_range": 0.02, "bos_token_id": 0, "eos_token_id": 0,
    }
    if cfg.head_dim is not None:
        out["head_dim"] = cfg.head_dim
    if cfg.rope_scaling_type is not None:
        out["rope_scaling"] = {
            "rope_type": cfg.rope_scaling_type, "factor": cfg.rope_factor,
            "low_freq_factor": cfg.rope_low_freq_factor, "high_freq_factor": cfg.rope_high_freq_factor,
            "original_max_position_embeddings": cfg.rope_original_max_pos,
        }
    if model_type in ("gemma2", "mistral"):
        out["sliding_window"] = cfg.sliding_window
    if model_type == "gemma2":
        out["layer_types"] = ["sliding_attention" if w else "full_attention"
                              for w in (cfg.sliding_pattern or (False,) * cfg.num_layers)]
        out.update(query_pre_attn_scalar=cfg.query_pre_attn_scalar, attn_logit_softcapping=cfg.attn_logit_softcap,
                   final_logit_softcapping=cfg.final_logit_softcap)
    if model_type == "olmo":
        out["clip_qkv"] = cfg.clip_qkv
    return out


# T5Config's defaults (transformers 4.57) for keys a config.json may leave out
_T5_DEFAULTS = {
    "vocab_size": 32128, "d_model": 512, "d_kv": 64, "d_ff": 2048, "num_layers": 6, "num_heads": 8,
    "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
    "feed_forward_proj": "relu",
}


def t5_config_from_hf(hf_config: Mapping[str, Any], projection_dim: int | None = None) -> T5EncoderConfig:
    hf = {**_T5_DEFAULTS, **hf_config}
    return T5EncoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["d_model"],
        num_layers=hf["num_layers"],
        num_heads=hf["num_heads"],
        head_dim=hf["d_kv"],
        intermediate_size=hf["d_ff"],
        relative_buckets=hf["relative_attention_num_buckets"],
        relative_max_distance=hf["relative_attention_max_distance"],
        rms_eps=hf["layer_norm_epsilon"],
        gated_act="gated" in hf["feed_forward_proj"],
        projection_dim=projection_dim,
    )


def _t5_hf_config(cfg: T5EncoderConfig) -> Dict[str, Any]:
    return {
        "architectures": ["T5EncoderModel"], "model_type": "t5",
        "vocab_size": cfg.vocab_size, "d_model": cfg.hidden_size, "d_kv": cfg.head_dim, "d_ff": cfg.intermediate_size,
        "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
        "relative_attention_num_buckets": cfg.relative_buckets,
        "relative_attention_max_distance": cfg.relative_max_distance,
        "layer_norm_epsilon": cfg.rms_eps, "feed_forward_proj": "gated-gelu" if cfg.gated_act else "relu",
        "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0, "initializer_factor": 1.0,
    }


def hf_config_from_cfg(cfg: BertConfig | GPTNeoXConfig | LlamaConfig | T5EncoderConfig) -> Dict[str, Any]:
    """The ``config.json`` dict of an HF checkpoint with this architecture."""
    if isinstance(cfg, LlamaConfig):
        return _llama_hf_config(cfg)
    if isinstance(cfg, T5EncoderConfig):
        return _t5_hf_config(cfg)
    common = {
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_act": "gelu",
        "initializer_range": 0.02,
    }
    if isinstance(cfg, BertConfig):
        return {
            "architectures": ["BertModel"], "model_type": "bert",
            "type_vocab_size": cfg.type_vocab_size, "pad_token_id": 0,
            "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
            "position_embedding_type": "absolute", **common,
        }
    return {
        "architectures": ["GPTNeoXForCausalLM"], "model_type": "gpt_neox",
        "rotary_pct": cfg.rotary_pct, "rotary_emb_base": cfg.rotary_base,
        "use_parallel_residual": cfg.use_parallel_residual,
        "tie_word_embeddings": False, "bos_token_id": 0, "eos_token_id": 0, **common,
    }


# --------------------------------------------------------------------------
# state dicts
# --------------------------------------------------------------------------
def _strip_prefixes(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop MoCo/InBatch/DDP wrapper prefixes (``encoder_q.``, ``module.``,
    ``bert.``...), anchored on ``embeddings.word_embeddings.weight``."""
    anchor = "embeddings.word_embeddings.weight"
    candidates = [k[: -len(anchor)] for k in state if k.endswith(anchor)]
    if not candidates:
        raise KeyError(f"No '{anchor}' key found in checkpoint")
    q_first = [c for c in candidates if "encoder_q" in c]
    prefix = q_first[0] if q_first else min(candidates, key=len)
    if not prefix:
        return dict(state)
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _module_from_state(cls, cfg, state: Mapping[str, torch.Tensor], device, dtype):
    with torch.device("meta"):
        model = cls(cfg)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True, assign=True)
    return model.to(device=device, dtype=dtype)


def _neox_qkv_rows(w: torch.Tensor, cfg: GPTNeoXConfig, to_hf: bool) -> torch.Tensor:
    """Reorder fused-QKV rows between HF's [H, 3, hd] and the port's [3, H, hd]."""
    h, hd = cfg.num_heads, cfg.head_dim
    tail = w.shape[1:]
    src = (h, 3, hd) if not to_hf else (3, h, hd)
    return w.reshape(*src, *tail).transpose(0, 1).reshape(3 * h * hd, *tail)


_BERT_LAYER_KEYS = {
    "attn_out": "attention.output.dense",
    "attn_ln": "attention.output.LayerNorm",
    "mlp_in": "intermediate.dense",
    "mlp_out": "output.dense",
    "mlp_ln": "output.LayerNorm",
}
_NEOX_LAYER_KEYS = {
    "ln1": "input_layernorm",
    "qkv": "attention.query_key_value",
    "attn_out": "attention.dense",
    "ln2": "post_attention_layernorm",
    "mlp_in": "mlp.dense_h_to_4h",
    "mlp_out": "mlp.dense_4h_to_h",
}


def bert_params_from_state_dict(state: Mapping[str, Any], cfg: BertConfig, device=None, dtype=torch.float32) -> BertModel:
    sd = _strip_prefixes(state)
    out = {
        "word.weight": sd["embeddings.word_embeddings.weight"],
        "position.weight": sd["embeddings.position_embeddings.weight"],
        "token_type.weight": sd["embeddings.token_type_embeddings.weight"],
        "ln.weight": sd["embeddings.LayerNorm.weight"],
        "ln.bias": sd["embeddings.LayerNorm.bias"],
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        for kind in ("weight", "bias"):
            out[f"layers.{i}.qkv.{kind}"] = torch.cat(
                [torch.as_tensor(sd[f"{p}attention.self.{n}.{kind}"]) for n in ("query", "key", "value")]
            )
            for ours, theirs in _BERT_LAYER_KEYS.items():
                out[f"layers.{i}.{ours}.{kind}"] = sd[f"{p}{theirs}.{kind}"]
    return _module_from_state(BertModel, cfg, out, device, dtype)


def gpt_neox_params_from_state_dict(state: Mapping[str, Any], cfg: GPTNeoXConfig, device=None, dtype=torch.float32) -> GPTNeoX:
    sd = {k[len("gpt_neox."):] if k.startswith("gpt_neox.") else k: v for k, v in state.items()}
    out = {
        "embed_in.weight": sd["embed_in.weight"],
        "final_ln.weight": sd["final_layer_norm.weight"],
        "final_ln.bias": sd["final_layer_norm.bias"],
        "embed_out.weight": sd["embed_out.weight"],
    }
    for i in range(cfg.num_layers):
        for ours, theirs in _NEOX_LAYER_KEYS.items():
            for kind in ("weight", "bias"):
                t = torch.as_tensor(sd[f"layers.{i}.{theirs}.{kind}"])
                out[f"layers.{i}.{ours}.{kind}"] = _neox_qkv_rows(t, cfg, to_hf=False) if ours == "qkv" else t
    return _module_from_state(GPTNeoX, cfg, out, device, dtype)


# (port name, HF name) of the llama-family layer weights stored [in, out] here, [out, in] in HF
_LLAMA_PROJ_KEYS = (
    ("q_w", "self_attn.q_proj"), ("k_w", "self_attn.k_proj"), ("v_w", "self_attn.v_proj"),
    ("o_w", "self_attn.o_proj"), ("gate_w", "mlp.gate_proj"), ("up_w", "mlp.up_proj"), ("down_w", "mlp.down_proj"),
)


def _llama_norm_keys(cfg: LlamaConfig):
    """(port name, HF name) of the layer's norm weights."""
    keys = [("input_norm", "input_layernorm")]
    if cfg.norm_placement == "post_output":  # OLMo-2
        keys += [("post_attn_norm", "post_attention_layernorm"), ("post_mlp_norm", "post_feedforward_layernorm")]
    elif cfg.norm_placement == "pre_post":  # Gemma-2
        keys += [("post_attn_norm", "post_attention_layernorm"), ("post_mlp_norm", "post_feedforward_layernorm"),
                 ("post_norm", "pre_feedforward_layernorm")]
    else:
        keys += [("post_norm", "post_attention_layernorm")]
    return keys


def llama_params_from_state_dict(state: Mapping[str, Any], cfg: LlamaConfig, device=None,
                                 dtype=torch.float32) -> Llama:
    sd = {k[len("model."):] if k.startswith("model.") else k: torch.as_tensor(v) for k, v in state.items()}
    d, h, hkv, hd = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    ones = torch.ones(d)
    out = {
        "embed.weight": sd["embed_tokens.weight"],
        # OLMo-1's norms are weightless: no weights in the checkpoint
        "final_norm": sd.get("norm.weight", ones),
    }
    if not cfg.tie_embeddings:
        # a base-model checkpoint carries no head: the tied weights stand in
        out["lm_head"] = sd.get("lm_head.weight", sd["embed_tokens.weight"]).t()
    for i in range(cfg.num_layers):
        p, o = f"layers.{i}.", f"layers.{i}."
        w = {}
        if p + "self_attn.qkv_proj.weight" in sd:  # Phi-3's fused projections
            w["q_w"], w["k_w"], w["v_w"] = sd[p + "self_attn.qkv_proj.weight"].split([h * hd, hkv * hd, hkv * hd])
            w["gate_w"], w["up_w"] = sd[p + "mlp.gate_up_proj.weight"].chunk(2)
            w["o_w"], w["down_w"] = sd[p + "self_attn.o_proj.weight"], sd[p + "mlp.down_proj.weight"]
        else:
            w = {ours: sd[f"{p}{theirs}.weight"] for ours, theirs in _LLAMA_PROJ_KEYS}
        for ours, t in w.items():
            out[o + ours] = t.t()
        for ours, theirs in _llama_norm_keys(cfg):
            out[o + ours] = sd.get(f"{p}{theirs}.weight", ones)
        if cfg.norm_placement == "post_output":  # OLMo-2 has no pre-MLP norm
            out[o + "post_norm"] = ones
        if cfg.attention_bias:
            for n in ("q", "k", "v"):
                out[f"{o}{n}_b"] = sd[f"{p}self_attn.{n}_proj.bias"]
        if cfg.qk_norm or cfg.qk_norm_full:
            out[o + "q_norm"], out[o + "k_norm"] = sd[p + "self_attn.q_norm.weight"], sd[p + "self_attn.k_norm.weight"]
    return _module_from_state(Llama, cfg, {k: v.contiguous() for k, v in out.items()}, device, dtype)


def _llama_hf_state_dict(model: Llama) -> Dict[str, torch.Tensor]:
    cfg = model.cfg
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = {"model.embed_tokens.weight": sd["embed.weight"], "model.norm.weight": sd["final_norm"]}
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = sd["lm_head"].t().contiguous()
    for i in range(cfg.num_layers):
        o, p = f"layers.{i}.", f"model.layers.{i}."
        for ours, theirs in _LLAMA_PROJ_KEYS:
            out[f"{p}{theirs}.weight"] = sd[o + ours].t().contiguous()
        for ours, theirs in _llama_norm_keys(cfg):
            out[f"{p}{theirs}.weight"] = sd[o + ours]
        if cfg.attention_bias:
            for n in ("q", "k", "v"):
                out[f"{p}self_attn.{n}_proj.bias"] = sd[f"{o}{n}_b"]
        if cfg.qk_norm or cfg.qk_norm_full:
            out[p + "self_attn.q_norm.weight"], out[p + "self_attn.k_norm.weight"] = sd[o + "q_norm"], sd[o + "k_norm"]
    return out


def _t5_layer_keys(cfg: T5EncoderConfig):
    """(port name, HF ``encoder.block.{i}.`` name) of a T5 layer's weights."""
    keys = [("attn_norm", "layer.0.layer_norm.weight"), ("ffn_norm", "layer.1.layer_norm.weight")]
    keys += [(f"{n}.weight", f"layer.0.SelfAttention.{n}.weight") for n in ("q", "k", "v", "o")]
    ffn = ("wi_0", "wi_1", "wo") if cfg.gated_act else ("wi", "wo")
    return keys + [(f"{n}.weight", f"layer.1.DenseReluDense.{n}.weight") for n in ffn]


def t5_encoder_params_from_state_dict(state: Mapping[str, Any], cfg: T5EncoderConfig, projection=None, device=None,
                                      dtype=torch.float32) -> T5Encoder:
    """A ``T5EncoderModel`` (or full T5) state dict as the port's T5Encoder;
    ``projection`` [in, out] is the sentence-transformers Dense weight."""
    sd = {k[len("encoder."):] if k.startswith("encoder.") else k: torch.as_tensor(v) for k, v in state.items()}
    out = {
        "embed.weight": sd.get("shared.weight", sd.get("embed_tokens.weight")),
        "rel_bias": sd["block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
        "final_norm": sd["final_layer_norm.weight"],
    }
    for i in range(cfg.num_layers):
        for ours, theirs in _t5_layer_keys(cfg):
            out[f"layers.{i}.{ours}"] = sd[f"block.{i}.{theirs}"]
    if projection is not None:
        out["projection"] = torch.as_tensor(projection)
    return _module_from_state(T5Encoder, cfg, {k: v.contiguous() for k, v in out.items()}, device, dtype)


def _t5_hf_state_dict(model: T5Encoder) -> Dict[str, torch.Tensor]:
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out = {"shared.weight": sd["embed.weight"], "encoder.embed_tokens.weight": sd["embed.weight"].clone(),
           "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": sd["rel_bias"],
           "encoder.final_layer_norm.weight": sd["final_norm"]}
    for i in range(model.cfg.num_layers):
        for ours, theirs in _t5_layer_keys(model.cfg):
            out[f"encoder.block.{i}.{theirs}"] = sd[f"layers.{i}.{ours}"]
    return out


def hf_state_dict_from_params(model: BertModel | GPTNeoX | Llama | T5Encoder) -> Dict[str, torch.Tensor]:
    """HF-layout state dict (BertModel without pooler / GPTNeoXForCausalLM /
    the llama family's ...ForCausalLM / T5EncoderModel without the Dense
    projection), on the CPU."""
    if isinstance(model, Llama):
        return _llama_hf_state_dict(model)
    if isinstance(model, T5Encoder):
        return _t5_hf_state_dict(model)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    cfg = model.cfg
    if isinstance(model, BertModel):
        out = {
            "embeddings.word_embeddings.weight": sd["word.weight"],
            "embeddings.position_embeddings.weight": sd["position.weight"],
            "embeddings.token_type_embeddings.weight": sd["token_type.weight"],
            "embeddings.LayerNorm.weight": sd["ln.weight"],
            "embeddings.LayerNorm.bias": sd["ln.bias"],
        }
        for i in range(cfg.num_layers):
            p = f"encoder.layer.{i}."
            for kind in ("weight", "bias"):
                for n, part in zip(("query", "key", "value"), sd[f"layers.{i}.qkv.{kind}"].chunk(3)):
                    out[f"{p}attention.self.{n}.{kind}"] = part.clone()
                for ours, theirs in _BERT_LAYER_KEYS.items():
                    out[f"{p}{theirs}.{kind}"] = sd[f"layers.{i}.{ours}.{kind}"]
        return out
    out = {
        "gpt_neox.embed_in.weight": sd["embed_in.weight"],
        "gpt_neox.final_layer_norm.weight": sd["final_ln.weight"],
        "gpt_neox.final_layer_norm.bias": sd["final_ln.bias"],
        "embed_out.weight": sd["embed_out.weight"],
    }
    for i in range(cfg.num_layers):
        for ours, theirs in _NEOX_LAYER_KEYS.items():
            for kind in ("weight", "bias"):
                t = sd[f"layers.{i}.{ours}.{kind}"]
                out[f"gpt_neox.layers.{i}.{theirs}.{kind}"] = (
                    _neox_qkv_rows(t, cfg, to_hf=True).contiguous() if ours == "qkv" else t
                )
    return out


def _tensor(x) -> torch.Tensor:
    """numpy (or a JAX array) -> torch, keeping int8 and bf16 (ml_dtypes)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _quantized_store(tree: Mapping[str, Any], keys, device) -> Dict[str, torch.Tensor]:
    """The ``@q8`` / ``@q4`` and scale entries of a JAX quantized tree, pad
    columns cut."""
    store = {}
    for name in keys:
        if f"{name}@q8" not in tree and f"{name}@q4" not in tree:
            continue
        pad = tree.get(f"{name}@padcols")
        cut = None if pad is None or not np.asarray(pad).shape[0] else -np.asarray(pad).shape[0]
        for suffix in ("@q8", "@s", "@sa", "@sb", "@q4", "@s4g"):
            if f"{name}{suffix}" in tree:
                store[f"{name}{suffix}"] = _tensor(tree[f"{name}{suffix}"])[:, :cut].contiguous().to(device)
    return store


def _quantized_from_jax(tree: Mapping[str, Any], cfg: GPTNeoXConfig, device, dtype):
    from retrieval_scaling_tpu_torch.models.generate import QuantizedGPTNeoX, QuantizedLayer

    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    with torch.device("meta"):
        base = GPTNeoX(cfg)
    floats = {
        "embed_in.weight": t(tree["embed_in"]),
        "final_ln.weight": t(tree["final_ln_scale"]), "final_ln.bias": t(tree["final_ln_bias"]),
    }
    for i, layer in enumerate(tree["layers"]):
        for ln in ("ln1", "ln2"):
            floats[f"layers.{i}.{ln}.weight"] = t(layer[ln + "_scale"])
            floats[f"layers.{i}.{ln}.bias"] = t(layer[ln + "_bias"])
    base.load_state_dict(floats, strict=False, assign=True)
    for module in (base.embed_in, base.final_ln, *(m for layer in base.layers for m in (layer.ln1, layer.ln2))):
        module.to(device=device, dtype=dtype)
    layers = []
    for layer, jl in zip(base.layers, tree["layers"]):
        store = _quantized_store(jl, ("qkv_mi", "ao_mo", "qkv_w", "attn_out_w", "mlp_in_w", "mlp_out_w"), device)
        for bias in ("qkv_b", "attn_out_b", "mlp_in_b", "mlp_out_b"):
            store[bias] = t(jl[bias]).reshape(-1).to(device=device, dtype=dtype)
        layers.append(QuantizedLayer(layer, store))
    return QuantizedGPTNeoX(base, layers, _quantized_store(tree, ("embed_out",), device))


_LLAMA_QUANT_KEYS = ("qkv3", "gateup", "q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


def _llama_floats_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig, with_projections: bool):
    """The port's state dict of a JAX llama tree; projections (2-D) only
    where the tree holds them as floats."""
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    out = {"embed.weight": t(tree["embed"]), "final_norm": t(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"])
    for i, layer in enumerate(tree["layers"]):
        for name, val in layer.items():
            if "@" in name or (not with_projections and name in _LLAMA_QUANT_KEYS):
                continue
            v = t(val)
            if name == "o_w":
                v = v.reshape(-1, v.shape[-1])
            elif name in ("q_w", "k_w", "v_w"):
                v = v.reshape(v.shape[0], -1)
            elif name in ("q_b", "k_b", "v_b") or (cfg.qk_norm_full and name in ("q_norm", "k_norm")):
                v = v.reshape(-1)
            out[f"layers.{i}.{name}"] = v
    return out


def _llama_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig, device, dtype):
    from retrieval_scaling_tpu_torch.models.generate import QuantizedLlama, QuantizedLlamaLayer

    quantized = any("@" in k for k in tree["layers"][0])
    floats = _llama_floats_from_jax(tree, cfg, not quantized)
    if not quantized:
        return _module_from_state(Llama, cfg, {k: v.contiguous() for k, v in floats.items()}, device, dtype)
    with torch.device("meta"):
        base = Llama(cfg)
    base.load_state_dict(floats, strict=False, assign=True)
    for name, p in list(base.named_parameters()):
        if name in floats:
            p.data = p.data.to(device=device, dtype=dtype)
    base.embed.to(device=device, dtype=dtype)
    layers = [QuantizedLlamaLayer(layer, _quantized_store(jl, _LLAMA_QUANT_KEYS, device))
              for layer, jl in zip(base.layers, tree["layers"])]
    return QuantizedLlama(base, layers, _quantized_store(tree, ("lm_head",), device))


def _t5_from_jax(tree: Mapping[str, Any], cfg: T5EncoderConfig, device, dtype) -> T5Encoder:
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    out = {"embed.weight": t(tree["embed"]), "rel_bias": t(tree["rel_bias"]), "final_norm": t(tree["final_norm"])}
    if "projection" in tree:
        out["projection"] = t(tree["projection"])
    for i, layer in enumerate(tree["layers"]):
        p = f"layers.{i}."
        out[p + "attn_norm"], out[p + "ffn_norm"] = t(layer["attn_norm"]), t(layer["ffn_norm"])
        for n in ("q", "k", "v"):
            w = t(layer[n + "_w"])
            out[f"{p}{n}.weight"] = w.reshape(w.shape[0], -1).T
        o = t(layer["o_w"])
        out[p + "o.weight"] = o.reshape(-1, o.shape[-1]).T
        for n in ("wi", "wi_0", "wi_1", "wo"):
            if n in layer:
                out[f"{p}{n}.weight"] = t(layer[n]).T
    return _module_from_state(T5Encoder, cfg, {k: v.contiguous() for k, v in out.items()}, device, dtype)


def params_from_jax(tree: Mapping[str, Any], cfg: BertConfig | GPTNeoXConfig | LlamaConfig | T5EncoderConfig,
                    device=None, dtype=torch.float32):
    """The JAX package's parameter tree (numpy leaves) as the port's module."""
    if isinstance(cfg, LlamaConfig):
        return _llama_from_jax(tree, cfg, device, dtype)
    if isinstance(cfg, T5EncoderConfig):
        return _t5_from_jax(tree, cfg, device, dtype)
    if isinstance(cfg, GPTNeoXConfig) and any("@" in k for k in tree["layers"][0]):
        return _quantized_from_jax(tree, cfg, device, dtype)
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    d = cfg.hidden_size
    if isinstance(cfg, BertConfig):
        emb = tree["embeddings"]
        out = {
            "word.weight": t(emb["word"]), "position.weight": t(emb["position"]),
            "token_type.weight": t(emb["token_type"]),
            "ln.weight": t(emb["ln_scale"]), "ln.bias": t(emb["ln_bias"]),
        }
        prefixes = {"attn_ln": "attn_ln", "mlp_ln": "mlp_ln"}
        cls = BertModel
    else:
        out = {
            "embed_in.weight": t(tree["embed_in"]), "embed_out.weight": t(tree["embed_out"]).T,
            "final_ln.weight": t(tree["final_ln_scale"]), "final_ln.bias": t(tree["final_ln_bias"]),
        }
        prefixes = {"ln1": "ln1", "ln2": "ln2"}
        cls = GPTNeoX
    # a tree from the JAX quantize_bert_params holds the FFN as int8 pairs
    quantized = "mlp_in_wq" in tree["layers"][0]
    for i, layer in enumerate(tree["layers"]):
        p = f"layers.{i}."
        out[p + "qkv.weight"] = t(layer["qkv_w"]).reshape(d, 3 * d).T
        out[p + "qkv.bias"] = t(layer["qkv_b"]).reshape(3 * d)
        out[p + "attn_out.weight"] = t(layer["attn_out_w"]).reshape(d, d).T
        out[p + "attn_out.bias"] = t(layer["attn_out_b"])
        for name in ("mlp_in", "mlp_out"):
            # int8 pairs replace these placeholders below
            w = torch.zeros(np.asarray(layer[name + "_wq"]).shape) if quantized else t(layer[name + "_w"])
            out[p + name + ".weight"] = w.T
            out[p + name + ".bias"] = t(layer[name + "_b"])
        for ours, theirs in prefixes.items():
            out[p + ours + ".weight"] = t(layer[theirs + "_scale"])
            out[p + ours + ".bias"] = t(layer[theirs + "_bias"])
    model = _module_from_state(cls, cfg, {k: v.contiguous() for k, v in out.items()}, device, dtype)
    if quantized:
        from retrieval_scaling_tpu_torch.models.bert import quantize_bert_layer
        from retrieval_scaling_tpu_torch.ops.quant_matmul import QuantizedWeight

        for module, layer in zip(model.layers, tree["layers"]):
            quantize_bert_layer(module, {name: (QuantizedWeight(_tensor(layer[name + "_wq"]).to(device),
                                                                _tensor(layer[name + "_ws"]).to(device)),
                                                getattr(module, name).bias.detach())
                                         for name in ("mlp_in", "mlp_out")})
    return model


# --------------------------------------------------------------------------
# checkpoints on disk
# --------------------------------------------------------------------------
def _read_checkpoint(path: str):
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    weights = os.path.join(path, CHECKPOINT_FILE)
    if not os.path.exists(weights):
        raise FileNotFoundError(f"{weights} not found: checkpoints are read from a local HF directory")
    return hf_config, torch.load(weights, map_location="cpu", weights_only=True, mmap=True)


def save_hf_checkpoint(model: BertModel | GPTNeoX | Llama | T5Encoder, path: str) -> None:
    """Write ``config.json`` + ``pytorch_model.bin`` in the HF layout (and a
    T5 encoder's projection as the sentence-transformers ``2_Dense`` module)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_from_cfg(model.cfg), f, indent=2)
    torch.save(hf_state_dict_from_params(model), os.path.join(path, CHECKPOINT_FILE))
    if isinstance(model, T5Encoder) and model.projection is not None:
        dense = os.path.join(path, "2_Dense")
        os.makedirs(dense, exist_ok=True)
        d_in, d_out = model.projection.shape
        with open(os.path.join(dense, "config.json"), "w") as f:
            json.dump({"in_features": d_in, "out_features": d_out, "bias": False,
                       "activation_function": "torch.nn.modules.linear.Identity"}, f)
        torch.save({"linear.weight": model.projection.detach().cpu().t().contiguous()},
                   os.path.join(dense, CHECKPOINT_FILE))


def load_sentence_transformers_projection(model_dir: str) -> torch.Tensor | None:
    """A local sentence-transformers Dense module's weight (GTR's
    ``2_Dense/``: ``pytorch_model.bin`` or ``model.safetensors`` holding
    ``linear.weight`` [out, in]) as [in, out] f32, or None."""
    import glob

    for dense_dir in sorted(glob.glob(os.path.join(model_dir, "*_Dense"))):
        st_bin = os.path.join(dense_dir, CHECKPOINT_FILE)
        st_safe = os.path.join(dense_dir, "model.safetensors")
        if os.path.exists(st_safe):
            from safetensors.torch import load_file

            weights = load_file(st_safe)
        elif os.path.exists(st_bin):
            weights = torch.load(st_bin, map_location="cpu", weights_only=True)
        else:
            continue
        for key, val in weights.items():
            if key.endswith("weight"):
                return val.float().t().contiguous()
    return None


def load_hf_t5_encoder(path: str, device=None, dtype=torch.float32) -> T5Encoder:
    """A GTR (T5) encoder from a local directory, with its Dense projection
    when the directory holds one."""
    hf_config, state = _read_checkpoint(path)
    projection = load_sentence_transformers_projection(path)
    cfg = t5_config_from_hf(hf_config, projection_dim=None if projection is None else projection.shape[1])
    return t5_encoder_params_from_state_dict(state, cfg, projection, device=device, dtype=dtype)


def load_hf_encoder(path: str, pooling: str | None = None, device=None, dtype=torch.float32) -> BertModel:
    """A BERT-family encoder from a local HF directory. Pooling: mean for
    contriever-named checkpoints, CLS otherwise (the reference's rule)."""
    if pooling is None:
        pooling = "mean" if "contriever" in str(path).lower() else "cls"
    hf_config, state = _read_checkpoint(path)
    cfg = bert_config_from_hf(hf_config, pooling=pooling)
    return bert_params_from_state_dict(state, cfg, device=device, dtype=dtype)


def load_hf_reader(path: str, device=None, dtype=torch.float32) -> GPTNeoX | Llama:
    """A GPT-NeoX (Pythia) or llama-family reader from a local HF directory,
    dispatched on ``model_type``, in f32 by default (the JAX package's
    default)."""
    hf_config, state = _read_checkpoint(path)
    if hf_config.get("model_type") in _LLAMA_MODEL_TYPES:
        cfg = llama_config_from_hf(hf_config)
        return llama_params_from_state_dict(state, cfg, device=device, dtype=dtype)
    cfg = gpt_neox_config_from_hf(hf_config)
    return gpt_neox_params_from_state_dict(state, cfg, device=device, dtype=dtype)


def reader_hidden(model, cfg, input_ids: torch.Tensor) -> torch.Tensor:
    """Forward to the final-norm hidden states (the blockwise-loss entry)."""
    if isinstance(cfg, LlamaConfig):
        return llama_forward(model, cfg, input_ids)
    return gpt_neox_forward(model, input_ids, return_hidden=True)


def reader_logits_from_hidden(model, cfg, hidden: torch.Tensor) -> torch.Tensor:
    if isinstance(cfg, LlamaConfig):
        return llama_logits(model, cfg, hidden)
    return neox_logits(model, hidden)


def reader_logits(model, cfg, input_ids: torch.Tensor) -> torch.Tensor:
    return reader_logits_from_hidden(model, cfg, reader_hidden(model, cfg, input_ids))


# --------------------------------------------------------------------------
# tokenizers
# --------------------------------------------------------------------------
_PIECE_RE = re.compile(r"\w+|[^\w\s]+")  # the Whitespace pre-tokenizer's split


def _token_text(tok) -> str | None:
    return tok.get("content") if isinstance(tok, dict) else tok


class WordLevelTokenizer:
    """Pure-Python reader of a WordLevel + Whitespace ``tokenizer.json``.

    Encodes and decodes as ``PreTrainedTokenizerFast`` does for that file:
    whitespace/punctuation pieces looked up in the vocab (unknown -> unk),
    no special tokens added, decode joins tokens with single spaces.
    """

    def __init__(self, vocab: Mapping[str, int], unk_token: str, special_tokens=(),
                 pad_token: str | None = None, eos_token: str | None = None):
        self.vocab = dict(vocab)
        self._inv = {i: w for w, i in self.vocab.items()}
        self.unk_token, self.pad_token, self.eos_token = unk_token, pad_token, eos_token
        self.special_tokens = list(special_tokens)
        self._special_ids = {self.vocab[t] for t in self.special_tokens}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def pad_token_id(self) -> int | None:
        return None if self.pad_token is None else self.vocab[self.pad_token]

    @property
    def eos_token_id(self) -> int | None:
        return None if self.eos_token is None else self.vocab[self.eos_token]

    @classmethod
    def from_pretrained(cls, path: str) -> "WordLevelTokenizer":
        with open(os.path.join(path, "tokenizer.json")) as f:
            spec = json.load(f)
        model = spec.get("model") or {}
        if (
            model.get("type") != "WordLevel"
            or spec.get("pre_tokenizer") != {"type": "Whitespace"}
            or any(spec.get(k) for k in ("normalizer", "post_processor", "decoder"))
        ):
            raise ValueError(
                f"{path}/tokenizer.json is not a plain WordLevel + Whitespace tokenizer; "
                "loading it needs transformers"
            )
        config = {}
        cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                config = json.load(f)
        specials = [t["content"] for t in spec.get("added_tokens", []) if t.get("special")]
        return cls(
            model["vocab"], model["unk_token"], specials,
            pad_token=_token_text(config.get("pad_token")),
            eos_token=_token_text(config.get("eos_token")),
        )

    def save_pretrained(self, path: str) -> None:
        """Write the ``tokenizer.json`` / ``tokenizer_config.json`` pair that
        ``from_pretrained`` and ``transformers.AutoTokenizer`` both read."""
        os.makedirs(path, exist_ok=True)
        added = [
            {"id": self.vocab[t], "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t in self.special_tokens
        ]
        spec = {
            "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": self.vocab, "unk_token": self.unk_token},
        }
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            json.dump(spec, f, ensure_ascii=False)
        config = {
            "tokenizer_class": "PreTrainedTokenizerFast", "clean_up_tokenization_spaces": False,
            "unk_token": self.unk_token, "pad_token": self.pad_token, "eos_token": self.eos_token,
        }
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump(config, f, indent=2)

    def _encode(self, text: str) -> list:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(p, unk) for p in _PIECE_RE.findall(text)]

    def __call__(self, text, max_length: int | None = None, truncation: bool = False, padding: bool = False,
                 add_special_tokens: bool = True):
        # the WordLevel tokenizer adds no special tokens either way
        if padding:
            raise NotImplementedError("padding is done by the callers")
        limit = max_length if truncation and max_length is not None else None
        if isinstance(text, str):
            return {"input_ids": self._encode(text)[:limit]}
        return {"input_ids": [self._encode(t)[:limit] for t in text]}

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return " ".join(
            self._inv[int(i)] for i in ids
            if not (skip_special_tokens and int(i) in self._special_ids)
        )


def load_tokenizer(path: str):
    """``transformers.AutoTokenizer`` when installed, else ``WordLevelTokenizer``."""
    try:
        import transformers
    except ImportError:
        return WordLevelTokenizer.from_pretrained(path)
    return transformers.AutoTokenizer.from_pretrained(path)
