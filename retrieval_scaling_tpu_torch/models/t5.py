"""T5 encoder stack for sentence-transformers retrievers (GTR-T5 family).

Ports ``retrieval_scaling_tpu/models/t5.py``: ``T5EncoderConfig``,
``relative_position_buckets`` (HF's bidirectional bucketing), the RMS norm,
``t5_encode`` (pre-norm blocks; the v1.0 ReLU and the v1.1 gated-gelu FFN)
and ``t5_embed`` (mean pooling, the sentence-transformers Dense projection,
L2 normalisation). Linear weights keep HF's ``[out, in]`` layout; the
projection keeps the JAX package's ``[in, out]``.

Attention adds the relative-position bias to unscaled scores; it is XLA in
the JAX package (the Pallas kernel takes masks only), so it is plain torch
here and reaches no kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    hidden_size: int = 768        # d_model
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64            # d_kv (not hidden / heads in general)
    intermediate_size: int = 3072  # d_ff
    relative_buckets: int = 32
    relative_max_distance: int = 128
    rms_eps: float = 1e-6
    gated_act: bool = False       # v1.1 gated-gelu vs v1.0 relu
    projection_dim: int | None = None  # sentence-transformers Dense module


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """HF T5 bidirectional relative-position bucketing, [q_len, k_len] int64."""
    ctx = torch.arange(q_len, dtype=torch.int32, device=device)[:, None]
    mem = torch.arange(k_len, dtype=torch.int32, device=device)[None, :]
    rel = mem - ctx
    half = num_buckets // 2
    bucket = torch.where(rel > 0, half, 0)
    n = rel.abs()
    max_exact = half // 2
    f32 = dict(dtype=torch.float32, device=device)
    # the JAX arithmetic in f32: true divisions by f32 tensors
    ratio = n.float() / torch.tensor(float(max_exact), **f32) + 1e-9
    log_ratio = torch.log(ratio) / torch.log(torch.tensor(max_distance / max_exact, **f32))
    large = max_exact + (log_ratio * (half - max_exact)).to(torch.int32)
    large = large.clamp_max(half - 1)
    return (bucket + torch.where(n < max_exact, n, large)).long()


class T5Layer(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, bias=False)
        d, inner, ff = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.intermediate_size
        self.attn_norm = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.q, self.k, self.v = (nn.Linear(d, inner, **kw) for _ in range(3))
        self.o = nn.Linear(inner, d, **kw)
        self.ffn_norm = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        if cfg.gated_act:
            self.wi_0, self.wi_1 = nn.Linear(d, ff, **kw), nn.Linear(d, ff, **kw)
        else:
            self.wi = nn.Linear(d, ff, **kw)
        self.wo = nn.Linear(ff, d, **kw)


class T5Encoder(nn.Module):
    """``forward`` is ``t5_encode``: the last hidden state [B, S, D] after the
    final RMS norm."""

    def __init__(self, cfg: T5EncoderConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.rel_bias = nn.Parameter(torch.zeros(cfg.relative_buckets, cfg.num_heads, device=device, dtype=dtype))
        self.final_norm = nn.Parameter(torch.ones(cfg.hidden_size, device=device, dtype=dtype))
        self.layers = nn.ModuleList(T5Layer(cfg, device=device, dtype=dtype) for _ in range(cfg.num_layers))
        self.projection = None
        if cfg.projection_dim:
            self.projection = nn.Parameter(torch.zeros(cfg.hidden_size, cfg.projection_dim, device=device,
                                                       dtype=dtype))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s = input_ids.shape
        h, hd = cfg.num_heads, cfg.head_dim
        x = self.embed(input_ids)
        buckets = relative_position_buckets(s, s, cfg.relative_buckets, cfg.relative_max_distance, x.device)
        pos_bias = self.rel_bias[buckets].float().permute(2, 0, 1)[None]  # [1, H, S, S]
        key_ok = attention_mask[:, None, None, :].bool()

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, s, h, hd).transpose(1, 2)

        for layer in self.layers:
            y = _rms_norm(x, layer.attn_norm, cfg.rms_eps)
            q, k, v = heads(layer.q(y)), heads(layer.k(y)), heads(layer.v(y))
            scores = torch.einsum("bnqk,bnmk->bnqm", q.float(), k.float()) + pos_bias  # T5: no 1/sqrt(d)
            scores = scores.masked_fill(~key_ok, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            attn = torch.einsum("bnqm,bnmk->bnqk", probs, v)
            x = x + layer.o(attn.transpose(1, 2).reshape(b, s, h * hd))

            y = _rms_norm(x, layer.ffn_norm, cfg.rms_eps)
            if cfg.gated_act:
                inner = F.gelu(layer.wi_0(y), approximate="tanh") * layer.wi_1(y)
            else:
                inner = F.relu(layer.wi(y))
            x = x + layer.wo(inner)
        return _rms_norm(x, self.final_norm, cfg.rms_eps)


def init_t5_encoder_params(cfg: T5EncoderConfig, generator: torch.Generator, device=None,
                           dtype=torch.float32) -> T5Encoder:
    """Random T5Encoder: N(0, 0.02) weights, N(0, 0.1) position bias, unit norms."""
    model = T5Encoder(cfg, device=device, dtype=dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm"):
                continue
            p.normal_(0.0, 0.1 if name == "rel_bias" else 0.02, generator=generator)
    return model


def t5_embed(model: T5Encoder, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             normalize: bool = True) -> torch.Tensor:
    """GTR-style embedding: mean pool -> optional projection -> L2 norm."""
    hidden = model(input_ids, attention_mask)
    maskf = attention_mask[..., None].to(hidden.dtype)
    emb = (hidden * maskf).sum(dim=1) / maskf.sum(dim=1).clamp_min(1e-9)
    if model.projection is not None:
        emb = emb @ model.projection
    if normalize:
        embf = emb.float()
        emb = (embf / torch.linalg.vector_norm(embf, dim=-1, keepdim=True).clamp_min(1e-9)).to(emb.dtype)
    return emb
