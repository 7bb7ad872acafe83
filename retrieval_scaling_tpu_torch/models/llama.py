"""Llama-family causal reader LM as a PyTorch module (Llama 1/2/3, Mistral,
Qwen2/2.5, Qwen3, Gemma, Gemma-2, OLMo-1/2, Phi-3).

Ports ``retrieval_scaling_tpu/models/llama.py``: ``LlamaConfig``,
``init_llama_params``, ``rope_inv_freq`` (none / ``linear`` / ``llama3``),
``rotary_cos_sin``, ``apply_rotary``, ``_qkv`` (Qwen2 bias, Qwen3 per-head
and OLMo-2 full-width q/k norms, OLMo-1 ``clip_qkv``), ``attn_out_proj``,
``llama_mlp`` (SiLU / gelu-tanh), ``llama_forward`` (norm placements
``pre`` / ``post_output`` / ``pre_post``, a sliding window on the layers of
``sliding_pattern``), ``llama_logits`` (Gemma-2's final soft-cap, also after
a quantized head), ``llama_lm`` and ``llama_embed``.

Weights keep the JAX package's ``[K, N]`` layouts, flattened to 2-D
(``q_w`` [d, H * hd], ``o_w`` [H * hd, d], ``lm_head`` [d, V]), so
``hf_convert.params_from_jax`` copies them as they are. Attention goes
through ``multi_head_attention``: on a CUDA tensor every layer launches K1,
with K2's window and soft-cap where the config asks for them. The
projections dispatch per weight, as in the JAX package: a layer (or the
model) that carries a ``q8`` store from ``models.generate.quantize_decode_params``
reads its fused ``qkv3`` / ``gateup`` or per-weight int8, bf16 or int4
weights through ``ops.quant_matmul``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
from retrieval_scaling_tpu_torch.ops.flash_attention import multi_head_attention
from retrieval_scaling_tpu_torch.ops.matmul import matmul_f32

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    head_dim: int | None = None          # Qwen3 / Gemma decouple head_dim from hidden / heads
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    attention_bias: bool = False         # Qwen2-style QKV bias
    qk_norm: bool = False                # Qwen3 per-head q/k RMSNorm
    tie_embeddings: bool = False
    # RoPE scaling (HF rope_scaling): None | "linear" | "llama3"
    rope_scaling_type: str | None = None
    rope_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    # Gemma: gelu-tanh MLP, RMSNorm scale = 1 + weight, embeddings * sqrt(d)
    hidden_act: str = "silu"             # "silu" | "gelu_tanh"
    rms_norm_offset: bool = False
    embedding_multiplier: float = 1.0
    # OLMo-1: weightless LayerNorm and QKV clipping; OLMo-2: norms on the
    # sublayer outputs and full-width q/k RMSNorm
    norm_type: str = "rms"               # "rms" | "layernorm_np"
    norm_placement: str = "pre"          # "pre" | "post_output" (OLMo-2) | "pre_post" (Gemma-2)
    clip_qkv: float | None = None
    qk_norm_full: bool = False
    # Gemma-2: soft-caps and the attention scale override
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_pre_attn_scalar: float | None = None
    # layers where sliding_pattern is True see keys in (q - sliding_window, q]
    sliding_window: int | None = None
    sliding_pattern: tuple | None = None

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    def layer_window(self, li: int) -> int | None:
        """The sliding window of layer ``li``, or None (full causal)."""
        if self.sliding_window is not None and self.sliding_pattern is not None and self.sliding_pattern[li]:
            return self.sliding_window
        return None


def _param(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, h, hkv, hd, ff = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.intermediate_size
        self.input_norm = _param(d, **kw)
        self.q_w, self.k_w, self.v_w = _param(d, h * hd, **kw), _param(d, hkv * hd, **kw), _param(d, hkv * hd, **kw)
        self.o_w = _param(h * hd, d, **kw)
        self.post_norm = _param(d, **kw)
        self.gate_w, self.up_w, self.down_w = _param(d, ff, **kw), _param(d, ff, **kw), _param(ff, d, **kw)
        if cfg.attention_bias:
            self.q_b, self.k_b, self.v_b = _param(h * hd, **kw), _param(hkv * hd, **kw), _param(hkv * hd, **kw)
        if cfg.qk_norm_full:  # over the flattened projection; JAX stores [H, hd]
            self.q_norm, self.k_norm = _param(h * hd, **kw), _param(hkv * hd, **kw)
        elif cfg.qk_norm:
            self.q_norm, self.k_norm = _param(hd, **kw), _param(hd, **kw)
        if cfg.norm_placement in ("post_output", "pre_post"):
            self.post_attn_norm, self.post_mlp_norm = _param(d, **kw), _param(d, **kw)


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.embed.weight.requires_grad_(False)
        self.layers = nn.ModuleList(LlamaLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = _param(cfg.hidden_size, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.hidden_size, cfg.vocab_size, **kw)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states [B, S, D]."""
        return llama_forward(self, self.cfg, input_ids)


_NORM_PARAMS = ("input_norm", "post_norm", "final_norm", "post_attn_norm", "post_mlp_norm", "q_norm", "k_norm")


@torch.no_grad()
def init_llama_params(cfg: LlamaConfig, generator: torch.Generator, device=None, dtype=torch.float32) -> Llama:
    """Random Llama: N(0, 0.02) projections and embeddings, unit norms and
    zero biases (``init_llama_params``' scheme), drawn on ``device``."""
    model = Llama(cfg, device=device, dtype=dtype)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _NORM_PARAMS:
            p.fill_(1.0)
        elif leaf in ("q_b", "k_b", "v_b"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return model


# --------------------------------------------------------------------------
# norms and rotary embeddings
# --------------------------------------------------------------------------
def _layer_norm_np(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Weightless LayerNorm in f32 (OLMo-1)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, offset: bool = False) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if offset:  # Gemma stores scale - 1; the 1 + w is taken in f32
        return (normed * (1.0 + scale.float())).to(x.dtype)
    return normed.to(x.dtype) * scale


def llama_norm(cfg: LlamaConfig, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layernorm_np":
        return _layer_norm_np(x, cfg.rms_eps)
    return _rms_norm(x, scale, cfg.rms_eps, cfg.rms_norm_offset)


def rope_inv_freq(cfg: LlamaConfig, device=None) -> torch.Tensor:
    """Base inverse frequencies [hd / 2] with HF rope_scaling applied."""
    dims = cfg.hd
    inv_freq = 1.0 / (cfg.rope_base ** (torch.arange(0, dims, 2, dtype=torch.float32, device=device) / dims))
    if cfg.rope_scaling_type == "linear":
        inv_freq = inv_freq / cfg.rope_factor
    elif cfg.rope_scaling_type == "llama3":
        # Llama-3.1 NTK-by-parts: low-frequency bands divide by factor,
        # high-frequency bands stay, mid bands interpolate
        low_wavelen = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
        high_wavelen = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / cfg.rope_factor
        smooth = (cfg.rope_original_max_pos / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        mid = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(wavelen > low_wavelen, scaled, torch.where(wavelen < high_wavelen, inv_freq, mid))
    elif cfg.rope_scaling_type not in (None, "default"):
        # e.g. Phi-3-128k "longrope", "yarn", "dynamic"
        raise NotImplementedError(
            f"rope_scaling type {cfg.rope_scaling_type!r} is not supported (supported: linear, llama3)"
        )
    return inv_freq


def rotary_cos_sin(positions: torch.Tensor, cfg: LlamaConfig):
    """cos, sin [..., hd] at integer ``positions`` of any shape (HF layout):
    the rows of the JAX package's table, computed where they are needed."""
    freqs = positions.float()[..., None] * rope_inv_freq(cfg, positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary over the full head dim in f32. x [B, H, S, hd];
    cos / sin broadcast against it."""
    xf = x.float()
    half = xf.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------
def _store(module):
    """The quantized-weight store of a layer or model, or None."""
    return getattr(module, "q8", None)


def _qkv(layer, cfg: LlamaConfig, x: torch.Tensor):
    """Project to q [B, H, S, hd] and k, v [B, Hkv, S, hd] (grouped)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    store = _store(layer)
    if qm.has_q8(store, "qkv3"):
        # the fused q|k|v store of quantize_decode_params: one weight stream
        qkv = qm.q8_dot(store, "qkv3", x)
        q, k, v = qkv.split([h * hd, hkv * hd, hkv * hd], dim=-1)
    elif qm.has_q8(store, "q_w"):
        q, k, v = (qm.q8_dot(store, n, x) for n in ("q_w", "k_w", "v_w"))
    else:
        q, k, v = x @ layer.q_w, x @ layer.k_w, x @ layer.v_w
    if cfg.attention_bias:
        q, k, v = q + layer.q_b, k + layer.k_b, v + layer.v_b
    if cfg.clip_qkv is not None:  # OLMo-1
        q, k, v = (t.clamp(-cfg.clip_qkv, cfg.clip_qkv) for t in (q, k, v))
    if cfg.qk_norm_full:  # OLMo-2: one RMSNorm over all heads of a token
        q, k = _rms_norm(q, layer.q_norm, cfg.rms_eps), _rms_norm(k, layer.k_norm, cfg.rms_eps)
    q, k, v = q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)
    if cfg.qk_norm and not cfg.qk_norm_full:  # Qwen3: per head
        q, k = _rms_norm(q, layer.q_norm, cfg.rms_eps), _rms_norm(k, layer.k_norm, cfg.rms_eps)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attn_out_proj(layer, attn: torch.Tensor) -> torch.Tensor:
    """Output projection: attn [B, H, S, hd] -> [B, S, D] (float or quantized)."""
    b, h, s, hd = attn.shape
    flat = attn.transpose(1, 2).reshape(b, s, h * hd)
    store = _store(layer)
    if qm.has_q8(store, "o_w"):
        return qm.q8_dot(store, "o_w", flat)
    return flat @ layer.o_w


def _act(cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh") if cfg.hidden_act == "gelu_tanh" else F.silu(x)


def llama_mlp(layer, cfg: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    """Gated MLP: down(act(gate(h)) * up(h)) (float or quantized weights)."""
    store = _store(layer)
    if qm.has_q8(store, "gateup"):
        # the fused gate|up store: one stream, the output split in two
        pre, up = qm.q8_dot(store, "gateup", h).chunk(2, dim=-1)
        return qm.q8_dot(store, "down_w", _act(cfg, pre) * up)
    if qm.has_q8(store, "gate_w"):
        return qm.q8_dot(store, "down_w", _act(cfg, qm.q8_dot(store, "gate_w", h)) * qm.q8_dot(store, "up_w", h))
    return (_act(cfg, h @ layer.gate_w) * (h @ layer.up_w)) @ layer.down_w


def embed_tokens(model, cfg: LlamaConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings, times Gemma's multiplier rounded to their dtype."""
    x = model.embed(input_ids)
    if cfg.embedding_multiplier != 1.0:
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=x.dtype, device=x.device)
    return x


def llama_forward(model, cfg: LlamaConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                  bidirectional: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, S, D] (pre-head)."""
    x = embed_tokens(model, cfg, input_ids)
    s = input_ids.shape[1]
    cos, sin = rotary_cos_sin(torch.arange(s, device=input_ids.device), cfg)
    kv_mask = None if attention_mask is None else attention_mask.bool()
    post_only = cfg.norm_placement == "post_output"   # OLMo-2
    pre_post = cfg.norm_placement == "pre_post"       # Gemma-2
    sm_scale = cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar is not None else None
    for li, layer in enumerate(model.layers):
        window = None if bidirectional else cfg.layer_window(li)
        h = x if post_only else llama_norm(cfg, x, layer.input_norm)
        q, k, v = _qkv(layer, cfg, h)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        attn = multi_head_attention(q, k, v, kv_mask=kv_mask, causal=not bidirectional, sm_scale=sm_scale,
                                    logit_cap=cfg.attn_logit_softcap, window=window)
        attn_out = attn_out_proj(layer, attn)
        if post_only or pre_post:
            attn_out = llama_norm(cfg, attn_out, layer.post_attn_norm)
        x = x + attn_out
        h = x if post_only else llama_norm(cfg, x, layer.post_norm)
        mlp_out = llama_mlp(layer, cfg, h)
        if post_only or pre_post:
            mlp_out = llama_norm(cfg, mlp_out, layer.post_mlp_norm)
        x = x + mlp_out
    return llama_norm(cfg, x, model.final_norm)


def llama_logits(model, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Vocab logits in f32 (float, tied or quantized head), Gemma-2's final
    soft-cap applied after any of them."""
    store = _store(model)
    if qm.has_q8(store, "lm_head"):
        logits = qm.q8_dot(store, "lm_head", hidden, out_dtype=torch.float32)
    else:
        head = model.embed.weight.t() if cfg.tie_embeddings else model.lm_head
        logits = matmul_f32(hidden, head)
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


def llama_lm(model, cfg: LlamaConfig, input_ids: torch.Tensor, labels: torch.Tensor):
    """HF-compatible causal LM loss: (sum of NLL, number of scored tokens);
    labels -100 are not scored."""
    from retrieval_scaling_tpu_torch.models.loss import blockwise_row_lm_loss, use_blockwise

    hidden = llama_forward(model, cfg, input_ids)
    if use_blockwise(input_ids.shape[1], cfg.vocab_size, input_ids.device):
        row_loss, row_count = blockwise_row_lm_loss(lambda h: llama_logits(model, cfg, h), hidden, labels)
        return row_loss.sum(), row_count.sum()
    logits = llama_logits(model, cfg, hidden)
    shift_labels = labels[:, 1:]
    mask = shift_labels != IGNORE_INDEX
    safe = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
    logprobs = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_ll = torch.gather(logprobs, -1, safe[..., None].long())[..., 0]
    return -(token_ll * mask).sum(), mask.sum()


def llama_embed(model, cfg: LlamaConfig, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                pooling: str = "last", normalize: bool = True, bidirectional: bool = False) -> torch.Tensor:
    """Decoder embedding (GRIT / Qwen3-embedding style): the last real
    token's hidden state, or the masked mean (GRIT: bidirectional)."""
    hidden = llama_forward(model, cfg, input_ids, attention_mask, bidirectional=bidirectional)
    if pooling == "last":
        last = (attention_mask.sum(dim=1).long() - 1).clamp_min(0)
        emb = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    elif pooling == "mean":
        maskf = attention_mask.to(hidden.dtype)
        emb = (hidden * maskf[..., None]).sum(dim=1) / maskf.sum(dim=1, keepdim=True).clamp_min(1e-9)
    else:
        raise ValueError(f"Unknown pooling: {pooling!r}")
    if normalize:
        emb = emb / emb.float().norm(dim=-1, keepdim=True).clamp_min(1e-9).to(emb.dtype)
    return emb
