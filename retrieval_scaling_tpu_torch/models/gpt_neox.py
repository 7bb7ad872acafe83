"""GPT-NeoX (Pythia) causal reader LM as a PyTorch module.

Ports ``retrieval_scaling_tpu/models/gpt_neox.py``: ``GPTNeoXConfig``,
``init_gpt_neox_params``, the partial rotary embedding, ``neox_qkv`` /
``neox_attn_out`` / ``neox_mlp``, the parallel residual of
``gpt_neox_forward`` and ``neox_logits``. Causal attention goes through
``multi_head_attention``, so on a CUDA tensor every layer launches K1. The
GPT-2 / OPT variants are not ported yet.

The projections dispatch per weight, as in the JAX package: a layer (or the
model) that carries a ``q8`` store from ``models.generate.quantize_decode_params``
reads its int8 / bf16 weights through ``ops.quant_matmul``, so one
quantized parameter set serves scoring and decoding.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_scaling_tpu_torch.models.bert import _init_normal
from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
from retrieval_scaling_tpu_torch.ops.flash_attention import multi_head_attention
from retrieval_scaling_tpu_torch.ops.matmul import matmul_f32

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 8
    intermediate_size: int = 8192
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25
    rotary_base: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dims(self) -> int:
        return int(self.head_dim * self.rotary_pct)


class GPTNeoXLayer(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, ff, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.ln1 = nn.LayerNorm(d, eps=eps, **kw)
        self.qkv = nn.Linear(d, 3 * d, **kw)  # output columns ordered [3, H, hd]
        self.attn_out = nn.Linear(d, d, **kw)
        self.ln2 = nn.LayerNorm(d, eps=eps, **kw)
        self.mlp_in = nn.Linear(d, ff, **kw)
        self.mlp_out = nn.Linear(ff, d, **kw)


class GPTNeoX(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_in = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(GPTNeoXLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.embed_out = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Final-LayerNorm hidden states [B, S, D]."""
        return gpt_neox_forward(self, input_ids, return_hidden=True)


def init_gpt_neox_params(cfg: GPTNeoXConfig, generator: torch.Generator, device=None, dtype=torch.float32) -> GPTNeoX:
    """Random GPTNeoX: N(0, 0.02) weights, zero biases, unit LayerNorms."""
    model = GPTNeoX(cfg, device=device, dtype=dtype)
    _init_normal(model, generator)
    return model


def rotary_cos_sin(positions: torch.Tensor, dims: int, base: float):
    """cos, sin [..., dims] at integer ``positions`` of any shape."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dims, 2, dtype=torch.float32, device=positions.device) / dims))
    freqs = positions.float()[..., None] * inv_freq  # [..., dims/2]
    emb = torch.cat([freqs, freqs], dim=-1)          # [..., dims] (HF layout)
    return emb.cos(), emb.sin()


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-style rotate-half rotary. x: [B, H, S, rot_dims]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def apply_partial_rotary(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rot: int) -> torch.Tensor:
    """Rotary on the first ``rot`` dims of t [B, H, S, hd] in f32; the rest pass."""
    if rot == 0:
        return t
    return torch.cat([_apply_rotary(t[..., :rot].float(), cos, sin).to(t.dtype), t[..., rot:]], dim=-1)


def _store(module):
    """The quantized-weight store of a layer or model, or None."""
    return getattr(module, "q8", None)


def neox_qkv(layer: GPTNeoXLayer, cfg: GPTNeoXConfig, ln1: torch.Tensor):
    """Fused QKV projection -> (q, k, v) each [B, H, S, hd] (views)."""
    b, s, _ = ln1.shape
    store = _store(layer)
    if qm.has_q8(store, "qkv_mi"):
        # launch-fused qkv|mlp_in storage: scoring takes the qkv column span
        nqkv = 3 * cfg.num_heads * cfg.head_dim
        qkv = qm.q8_col_slice_dot(store, "qkv_mi", ln1, 0, nqkv) + store["qkv_b"]
    elif qm.has_q8(store, "qkv_w"):
        qkv = qm.q8_dot(store, "qkv_w", ln1) + store["qkv_b"]
    else:
        qkv = layer.qkv(ln1)
    qkv = qkv.view(b, s, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def neox_attn_out(layer: GPTNeoXLayer, attn: torch.Tensor) -> torch.Tensor:
    """Output projection: attn [B, H, S, hd] -> [B, S, D]."""
    b, h, s, hd = attn.shape
    flat = attn.transpose(1, 2).reshape(b, s, h * hd)
    store = _store(layer)
    if qm.has_q8(store, "ao_mo"):
        return qm.q8_row_part_dot(store, "ao_mo", flat, "a") + store["attn_out_b"]
    if qm.has_q8(store, "attn_out_w"):
        return qm.q8_dot(store, "attn_out_w", flat) + store["attn_out_b"]
    return layer.attn_out(flat)


def neox_mlp(layer: GPTNeoXLayer, inp: torch.Tensor) -> torch.Tensor:
    store = _store(layer)
    if qm.has_q8(store, "qkv_mi"):
        qkv_cols = store["qkv_b"].numel()  # the bias spans the qkv columns
        n_total = store["qkv_mi@q8"].shape[1]
        h = F.gelu(qm.q8_col_slice_dot(store, "qkv_mi", inp, qkv_cols, n_total) + store["mlp_in_b"])
        return qm.q8_row_part_dot(store, "ao_mo", h, "b") + store["mlp_out_b"]
    if qm.has_q8(store, "mlp_in_w"):
        h = F.gelu(qm.q8_dot(store, "mlp_in_w", inp) + store["mlp_in_b"])
        return qm.q8_dot(store, "mlp_out_w", h) + store["mlp_out_b"]
    return layer.mlp_out(F.gelu(layer.mlp_in(inp)))


def neox_logits(model: GPTNeoX, x: torch.Tensor) -> torch.Tensor:
    """Final hidden -> vocab logits in f32 (float or quantized head)."""
    store = _store(model)
    if qm.has_q8(store, "embed_out"):
        return qm.q8_dot(store, "embed_out", x, out_dtype=torch.float32)
    return matmul_f32(x, model.embed_out.weight.t())


def gpt_neox_forward(model: GPTNeoX, input_ids: torch.Tensor, return_hidden: bool = False) -> torch.Tensor:
    """Logits [B, S, V] in f32, or the final-LayerNorm hidden states."""
    cfg = model.cfg
    s = input_ids.shape[1]
    x = model.embed_in(input_ids)
    rot = cfg.rotary_dims
    cos, sin = rotary_cos_sin(torch.arange(s, device=input_ids.device), max(rot, 2), cfg.rotary_base)
    for layer in model.layers:
        ln1 = layer.ln1(x)
        q, k, v = neox_qkv(layer, cfg, ln1)
        q, k = apply_partial_rotary(q, cos, sin, rot), apply_partial_rotary(k, cos, sin, rot)
        attn = multi_head_attention(q, k, v, causal=True)
        attn_out = neox_attn_out(layer, attn)
        if cfg.use_parallel_residual:
            x = x + attn_out + neox_mlp(layer, layer.ln2(x))
        else:
            x = x + attn_out
            x = x + neox_mlp(layer, layer.ln2(x))
    x = model.final_ln(x)
    return x if return_hidden else neox_logits(model, x)
