"""BERT encoder (Contriever) as a PyTorch module.

Ports ``retrieval_scaling_tpu/models/bert.py``: ``BertConfig``,
``bert_encode`` (``BertModel.forward``), ``_bert_layer`` (``BertLayer``),
``pool_embeddings`` and ``contriever_embed``. The Q/K/V projection is one
``Linear(d, 3d)`` whose output columns are ordered ``[3, H, hd]``, the JAX
``qkv_w`` layout. Attention goes through ``multi_head_attention``, so on a
CUDA tensor every layer launches the K1 kernel with the key-padding mask.
The int8 FFN layer is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_scaling_tpu_torch.ops.flash_attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pooling: str = "mean"  # "mean" (contriever) | "cls"
    # "exact" (erf), "tanh", or "auto": tanh for bf16 activations, where its
    # ~1e-3 error is below bf16 resolution, erf otherwise (the JAX rule)
    gelu: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, ff, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.attn_out = nn.Linear(d, d, **kw)
        self.attn_ln = nn.LayerNorm(d, eps=eps, **kw)
        self.mlp_in = nn.Linear(d, ff, **kw)
        self.mlp_out = nn.Linear(ff, d, **kw)
        self.mlp_ln = nn.LayerNorm(d, eps=eps, **kw)

    def forward(self, x: torch.Tensor, kv_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        # [B, H, S, hd] views of the fused projection: the kernel reads them strided
        q, k, v = self.qkv(x).view(b, s, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        attn = multi_head_attention(q, k, v, kv_mask=kv_mask)
        x = self.attn_ln(x + self.attn_out(attn.transpose(1, 2).reshape(b, s, d)))
        h = self.mlp_in(x)
        approx = cfg.gelu == "tanh" or (cfg.gelu == "auto" and h.dtype == torch.bfloat16)
        h = F.gelu(h, approximate="tanh" if approx else "none")
        return self.mlp_ln(x + self.mlp_out(h))


class BertModel(nn.Module):
    """``forward`` is ``bert_encode``: the last hidden state [B, S, D]."""

    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, d, **kw)
        self.position = nn.Embedding(cfg.max_position_embeddings, d, **kw)
        self.token_type = nn.Embedding(cfg.type_vocab_size, d, **kw)
        self.ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(BertLayer(cfg, **kw) for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        x = self.word(input_ids)
        x = x + self.position.weight[None, :s, :]
        x = x + self.token_type.weight[0][None, None, :]
        x = self.ln(x)
        kv_mask = attention_mask.bool()
        for layer in self.layers:
            x = layer(x, kv_mask)
        return x


def init_bert_params(cfg: BertConfig, generator: torch.Generator, device=None, dtype=torch.float32) -> BertModel:
    """Random BertModel: N(0, 0.02) weights, zero biases, unit LayerNorms."""
    model = BertModel(cfg, device=device, dtype=dtype)
    _init_normal(model, generator)
    return model


def _init_normal(model: nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, 0.02, generator=generator)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


def pool_embeddings(hidden: torch.Tensor, attention_mask: torch.Tensor, pooling: str) -> torch.Tensor:
    if pooling == "mean":
        mask = attention_mask[..., None].to(hidden.dtype)
        summed = (hidden * mask).sum(dim=1)
        counts = mask.sum(dim=1).clamp_min(1e-9)
        return summed / counts
    if pooling == "cls":
        return hidden[:, 0, :]
    raise ValueError(f"Unknown pooling: {pooling!r}")


def contriever_embed(
    model: BertModel,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    normalize: bool = False,
) -> torch.Tensor:
    """Passage/query embedding: encode + pool (+ optional L2 normalize)."""
    hidden = model(input_ids, attention_mask)
    emb = pool_embeddings(hidden, attention_mask, model.cfg.pooling)
    if normalize:
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb
