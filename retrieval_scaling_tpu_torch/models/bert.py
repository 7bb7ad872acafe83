"""BERT encoder (Contriever) as a PyTorch module.

Ports ``retrieval_scaling_tpu/models/bert.py``: ``BertConfig``,
``bert_encode`` (``BertModel.forward``, with the packed rows'
``position_ids`` / ``segment_ids``), ``_bert_layer`` and ``_bert_layer_int8``
(``BertLayer``), ``quantize_bert_params``, ``pool_embeddings``,
``contriever_embed`` and ``contriever_embed_packed``. The Q/K/V projection
is one ``Linear(d, 3d)`` whose output columns are ordered ``[3, H, hd]``,
the JAX ``qkv_w`` layout. Attention goes through ``multi_head_attention``,
so on a CUDA tensor every layer launches the K1 kernel with the
key-padding mask (K2s with ``segment_ids``). A layer whose FFN went
through ``quantize_bert_params`` holds ``Int8Linear`` modules and runs
``mlp_in`` as K9 (gelu in its epilogue) and ``mlp_out`` as K10 (residual +
LayerNorm in its epilogue).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
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

    def forward(self, x: torch.Tensor, kv_mask: torch.Tensor, segment_ids: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        # [B, H, S, hd] views of the fused projection: the kernel reads them strided
        q, k, v = self.qkv(x).view(b, s, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        attn = multi_head_attention(q, k, v, kv_mask=kv_mask, segment_ids=segment_ids)
        x = self.attn_ln(x + self.attn_out(attn.transpose(1, 2).reshape(b, s, d)))
        approx = cfg.gelu == "tanh" or (cfg.gelu == "auto" and x.dtype == torch.bfloat16)
        if isinstance(self.mlp_in, Int8Linear):
            # the int8 FFN: K9 with the gelu epilogue, then K10
            h = qm.int8_matmul(x, self.mlp_in.weight, self.mlp_in.bias,
                               activation="gelu_tanh" if approx else "gelu_exact", out_dtype=x.dtype)
            return qm.int8_matmul_residual_ln(h, x, self.mlp_out.weight, self.mlp_out.bias, self.mlp_ln.weight,
                                              self.mlp_ln.bias, eps=cfg.layer_norm_eps)
        h = F.gelu(self.mlp_in(x), approximate="tanh" if approx else "none")
        return self.mlp_ln(x + self.mlp_out(h))


class Int8Linear(nn.Module):
    """A per-output-channel symmetric int8 weight (``wq`` int8, ``scale``
    f32 [1, N]) and a float bias; only ``BertLayer`` reads it, through
    ``weight`` (a ``QuantizedWeight``). ``mlp_in`` holds the JAX ``[K, N]``
    layout (K9's), ``mlp_out`` the ``[N, K]`` one (K10's, ``res_ln_layout``):
    ``quantize_bert_layer`` makes both."""

    def __init__(self, qw: qm.QuantizedWeight, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("wq", qw.wq)
        self.register_buffer("scale", qw.scale)
        self.bias = nn.Parameter(bias, requires_grad=False)

    @property
    def weight(self) -> qm.QuantizedWeight:
        return qm.QuantizedWeight(self.wq, self.scale)


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

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                position_ids: torch.Tensor | None = None, segment_ids: torch.Tensor | None = None) -> torch.Tensor:
        """``position_ids`` [B, S] (packed rows: restart per segment) and
        ``segment_ids`` [B, S] (packed rows: block-diagonal attention)."""
        s = input_ids.shape[1]
        x = self.word(input_ids)
        if position_ids is not None:
            x = x + self.position(position_ids)
        else:
            x = x + self.position.weight[None, :s, :]
        x = x + self.token_type.weight[0][None, None, :]
        x = self.ln(x)
        kv_mask = attention_mask.bool()
        for layer in self.layers:
            x = layer(x, kv_mask, segment_ids)
        return x


def init_bert_params(cfg: BertConfig, generator: torch.Generator, device=None, dtype=torch.float32) -> BertModel:
    """Random BertModel: N(0, 0.02) weights, zero biases, unit LayerNorms."""
    model = BertModel(cfg, device=device, dtype=dtype)
    _init_normal(model, generator)
    return model


def quantize_bert_params(model: BertModel) -> BertModel:
    """FFN weight quantization for the int8 path (the JAX
    ``quantize_bert_params``): a copy of ``model`` whose ``mlp_in`` /
    ``mlp_out`` are per-output-channel symmetric int8 ``Int8Linear`` (their
    ``[K, N]`` bytes and f32 scales equal the JAX tree's ``mlp_*_wq`` /
    ``mlp_*_ws``), quantized from the weights as they are (so from bf16
    values in a bf16 model, as the JAX encoder casts before it quantizes);
    biases, attention and LayerNorms stay float."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for layer in out.layers:
            quantize_bert_layer(layer, {name: (qm.quantize_weight(lin.weight.t()), lin.bias.detach())
                                        for name, lin in (("mlp_in", layer.mlp_in), ("mlp_out", layer.mlp_out))})
    return out


def quantize_bert_layer(layer: BertLayer, ffn: dict) -> None:
    """Replace ``layer``'s FFN with ``Int8Linear``s from ``ffn``: {"mlp_in" /
    "mlp_out": (a ``[K, N]`` ``QuantizedWeight``, bias)}. ``mlp_out`` is
    stored in K10's ``[N, K]`` layout."""
    qw, bias = ffn["mlp_in"]
    layer.mlp_in = Int8Linear(qw, bias)
    qw, bias = ffn["mlp_out"]
    layer.mlp_out = Int8Linear(qm.res_ln_layout(qw), bias)


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


def contriever_embed_packed(
    model: BertModel,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    segment_ids: torch.Tensor,
    seg_starts: torch.Tensor,
    normalize: bool = False,
) -> torch.Tensor:
    """Packed-sequence embedding: many passages per row -> [B, G, D].

    Attention is block-diagonal through ``segment_ids`` (1..G per segment,
    0 = pad) and positions restart per segment, so each passage computes
    what it would alone. Mean pooling is a [B, S, G] one-hot product (the
    JAX segment-sum); CLS pooling takes each segment's first token
    (``seg_starts`` [B, G]). Slots past a row's last segment pool over an
    empty set; the caller drops them."""
    hidden = model(input_ids, (segment_ids > 0).to(torch.int32), position_ids=position_ids,
                   segment_ids=segment_ids)
    g = seg_starts.shape[1]
    if model.cfg.pooling == "mean":
        slots = torch.arange(1, g + 1, device=segment_ids.device)
        onehot = (segment_ids[:, :, None] == slots[None, None, :]).to(hidden.dtype)  # [B, S, G]
        summed = torch.einsum("bsd,bsg->bgd", hidden, onehot)
        emb = summed / onehot.sum(dim=1).clamp_min(1e-9)[..., None]
    elif model.cfg.pooling == "cls":
        emb = torch.gather(hidden, 1, seg_starts.long()[..., None].expand(-1, -1, hidden.shape[-1]))
    else:
        raise ValueError(f"Unknown pooling: {model.cfg.pooling!r}")
    if normalize:
        embf = emb.float()
        emb = (embf / torch.linalg.vector_norm(embf, dim=-1, keepdim=True).clamp_min(1e-9)).to(emb.dtype)
    return emb
