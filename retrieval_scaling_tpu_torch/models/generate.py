"""Autoregressive generation for the GPT-NeoX and llama-family readers with
a KV cache.

Ports ``retrieval_scaling_tpu/models/generate.py``:

* ``KVCache`` / ``init_cache``: per-layer ``[B, H, max_len, hd]`` buffers
  (``num_kv_heads`` heads for the llama family; float, or int8 rows with
  per-(b, head, slot) f32 scales);
* ``_write_kv``: a prefill writes the slots [0, S) of the tokens that
  ``write_mask`` lets through (one slice write; pads keep their zeros, as
  the JAX one-hot writes left them); a decode step, and a segment with
  ``contiguous_writes`` (a speculative verify segment), writes each row's
  run ``positions[b]`` in place (``index_put_``), replacing the slots'
  contents, where the JAX package's ``dynamic_update_slice`` aliased the
  while-loop carry;
* ``_prefill_attention_from_slot0``: a prefill segment over a float cache
  (slot 0 of an empty cache, every prefill caller's case; the name states
  the contract) is causal self-attention with the valid-slot mask, one K1 /
  K2 launch on the card;
* ``_attention_with_cache``: a segment over a filled float cache (a decode
  step or a verify segment) runs K3 (``ops.flash_attention.flash_decode``)
  at every cache length, each query row bounded by its own position (and
  its sliding window) inside the kernel, Gemma-2's soft-cap passed to it;
  K3 maps the query groups of GQA onto its rows, which is what the JAX
  decode step's group fold does. The int8 cache's attention is plain torch
  here (window and cap included), as it is XLA code in the JAX package;
* ``quantize_decode_params``: int8 and bf16 schemes with the fused layouts
  (GPT-NeoX's parallel residual ``qkv_mi`` / ``ao_mo``, the llama family's
  ``qkv3`` and ``gateup`` beside ``o_w``, ``down_w`` and an untied head) and
  the int4 scheme (per-weight group-128 streams through K8; a weight whose K
  is not a multiple of 128 stays int8), ``forward_with_cache`` and
  ``make_generate_fn`` (greedy or temperature sampling) for both families.

``lax.while_loop`` becomes a Python loop whose tokens stay on the device;
``mesh`` / ``param_shardings`` (module 14) raise until their slice lands.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from retrieval_scaling_tpu_torch.models.gpt_neox import (
    GPTNeoX,
    GPTNeoXConfig,
    apply_partial_rotary,
    neox_attn_out,
    neox_logits,
    neox_mlp,
    neox_qkv,
    rotary_cos_sin,
)
from retrieval_scaling_tpu_torch.models import llama as lm
from retrieval_scaling_tpu_torch.models.llama import Llama, LlamaConfig
from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
from retrieval_scaling_tpu_torch.ops.flash_attention import flash_decode, multi_head_attention

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: List[torch.Tensor]  # L per-layer tensors [B, H, max_len, hd], written in place
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]] = None  # int8 cache: L tensors [B, H, max_len] f32
    v_scale: Optional[List[torch.Tensor]] = None


def _check_reader(cfg) -> None:
    if not isinstance(cfg, (GPTNeoXConfig, LlamaConfig)):
        raise NotImplementedError(f"{type(cfg).__name__} readers are not ported (GPT-NeoX and the llama family are)")


def embedding(model) -> nn.Embedding:
    """The token embedding of a reader (GPT-NeoX ``embed_in``, llama ``embed``)."""
    return model.embed if isinstance(model.cfg, LlamaConfig) else model.embed_in


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> KVCache:
    """Zeroed KV cache; ``dtype=torch.int8`` gives int8 rows with f32 scales.
    Llama-family caches hold ``num_kv_heads`` heads (GQA)."""
    _check_reader(cfg)
    if isinstance(cfg, LlamaConfig):
        shape = (batch, cfg.num_kv_heads, max_len, cfg.hd)
    else:
        shape = (batch, cfg.num_heads, max_len, cfg.head_dim)
    zeros = lambda dt, shp: [torch.zeros(shp, dtype=dt, device=device) for _ in range(cfg.num_layers)]  # noqa: E731
    if dtype == torch.int8:
        return KVCache(zeros(torch.int8, shape), zeros(torch.int8, shape),
                       zeros(torch.float32, shape[:3]), zeros(torch.float32, shape[:3]))
    return KVCache(zeros(dtype, shape), zeros(dtype, shape))


def _attention_with_cache(q, keys, values, q_pos, key_valid, sm_scale=None, k_scale=None, v_scale=None,
                          logit_cap=None, window=None):
    """q [B, H, S, hd] against the cache [B, Hkv, M, hd]; q_pos [B, S],
    key_valid [B, M]. Query j of row b sees the valid slots at or below
    ``q_pos[b, j]`` (a decode step's key_valid ends there anyway);
    ``window`` also hides keys at or below ``q_pos - window``; ``logit_cap``
    soft-caps the scaled scores before the mask.

    A float cache runs K3 with the per-query positions; the int8 cache's
    attention is plain: ``k_scale`` / ``v_scale`` [B, Hkv, M] fold into the
    scores and the probabilities, with bf16 operands and f32 sums, as in JAX."""
    b, h, sq, hd = q.shape
    hkv = keys.shape[1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    if k_scale is None:
        return flash_decode(q, keys, values, kv_mask=key_valid.expand(b, keys.shape[2]), sm_scale=sm_scale,
                            logit_cap=logit_cap, q_pos=q_pos.expand(b, sq), window=window)
    if hkv != h:  # GQA: query groups fold into the row axis
        g = h // hkv
        q2 = q.reshape(b, hkv, g * sq, hd)
        qpos2 = q_pos[:, None, :].expand(b, g, sq).reshape(b, g * sq)
        out = _attention_with_cache(q2, keys, values, qpos2, key_valid, sm_scale, k_scale, v_scale,
                                    logit_cap=logit_cap, window=window)
        return out.reshape(b, h, sq, hd)
    scores = q.to(torch.bfloat16).float() @ keys.to(torch.bfloat16).float().transpose(-1, -2)
    scores = scores * k_scale[:, :, None, :] * sm_scale
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    key_pos = torch.arange(keys.shape[2], device=q.device)
    ok = key_valid[:, None, None, :] & (key_pos[None, None, None, :] <= q_pos[:, None, :, None])
    if window is not None:
        ok = ok & (key_pos[None, None, None, :] > q_pos[:, None, :, None] - window)
    probs = torch.softmax(scores.masked_fill(~ok, NEG_INF), dim=-1) * v_scale[:, :, None, :]
    return (probs.to(torch.bfloat16).float() @ values.to(torch.bfloat16).float()).to(q.dtype)


def _prefill_attention_from_slot0(q, k, v, cache_dtype, key_valid, sm_scale=None, logit_cap=None, window=None):
    """A prefill segment's attention over a float cache. Its contract is in
    its name: the segment starts at slot 0 of an empty cache (``_write_kv``
    writes it at slots [0, S)), so its attention is causal self-attention
    over the segment's own K/V (rounded to the cache's dtype) with the
    valid-slot mask: one K1 (K2 with a window or a cap) launch on the card,
    where the JAX package ran XLA over the whole cache."""
    s = q.shape[2]
    return multi_head_attention(q, k.to(cache_dtype), v.to(cache_dtype),
                                kv_mask=key_valid[:, :s].expand(q.shape[0], s),
                                causal=True, sm_scale=sm_scale, window=window, logit_cap=logit_cap)


def _block_attention(q, k, v, cache_k, cache_v, positions, key_valid, over_cache, ks, vs, sm_scale=None,
                     logit_cap=None, window=None):
    """A block's attention after its K/V were written: a prefill over a
    float cache takes ``_prefill_attention_from_slot0``; a segment over the
    cache (``over_cache``: a decode step or a verify segment) and every
    segment of the int8 cache take ``_attention_with_cache``."""
    if not over_cache and ks is None:
        return _prefill_attention_from_slot0(q, k, v, cache_k.dtype, key_valid, sm_scale, logit_cap, window)
    return _attention_with_cache(q, cache_k, cache_v, positions, key_valid, sm_scale, k_scale=ks, v_scale=vs,
                                 logit_cap=logit_cap, window=window)


def _quantize_kv_rows(t):
    """[B, H, S, hd] float -> (int8 rows, f32 scales [B, H, S])."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(tf / safe[..., None]).to(torch.int8), scale


def _write_kv(cache_k, cache_v, k, v, positions, write_mask, ks=None, vs=None, over_cache=False):
    """Write new K/V ([B, H, S, hd]) into the cache ([B, H, M, hd]) in place.

    A segment ``over_cache`` (a decode step, or a verify segment whose rows
    are runs ``start + arange(S)``): row b's tokens replace the slots
    ``positions[b]``. Prefill: the segment's slots [0, S); tokens that
    ``write_mask`` [B, S] hides keep the slot's previous (zero) content."""
    if cache_k.dtype == torch.int8:
        (k, k_sc), (v, v_sc) = _quantize_kv_rows(k), _quantize_kv_rows(v)
    b, _, s, _ = k.shape
    if over_cache:
        rows = torch.arange(b, device=k.device)[:, None]
        # advanced indices around a slice: the result is [B, S, H, hd]
        cache_k[rows, :, positions] = k.transpose(1, 2).to(cache_k.dtype)
        cache_v[rows, :, positions] = v.transpose(1, 2).to(cache_v.dtype)
        if ks is not None:
            ks[rows, :, positions] = k_sc.transpose(1, 2)
            vs[rows, :, positions] = v_sc.transpose(1, 2)
        return
    keep = torch.ones((b, s), dtype=torch.bool, device=k.device) if write_mask is None else write_mask.bool()
    wm = keep[:, None, :, None]
    cache_k[:, :, :s] = torch.where(wm, k.to(cache_k.dtype), cache_k[:, :, :s])
    cache_v[:, :, :s] = torch.where(wm, v.to(cache_v.dtype), cache_v[:, :, :s])
    if ks is not None:
        ks[:, :, :s] = torch.where(wm[..., 0], k_sc, ks[:, :, :s])
        vs[:, :, :s] = torch.where(wm[..., 0], v_sc, vs[:, :, :s])


# --------------------------------------------------------------------------
# quantized parameters
# --------------------------------------------------------------------------
class QuantizedLayer(nn.Module):
    """A GPT-NeoX layer whose projections live in the ``q8`` store."""

    def __init__(self, layer, store: dict):
        super().__init__()
        self.ln1, self.ln2 = layer.ln1, layer.ln2
        self.q8 = store


class QuantizedGPTNeoX(nn.Module):
    """GPT-NeoX with int8 (or 2-D bf16) projections and head; embeddings,
    LayerNorms and biases stay float and are shared with the float model."""

    def __init__(self, model: GPTNeoX, layers, store: dict):
        super().__init__()
        self.cfg = model.cfg
        self.embed_in, self.final_ln = model.embed_in, model.final_ln
        self.layers = nn.ModuleList(layers)
        self.q8 = store


_LLAMA_PROJECTIONS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


class QuantizedLlamaLayer(nn.Module):
    """A llama-family layer whose projections live in the ``q8`` store; its
    norms, biases and q/k norms are the float layer's own."""

    def __init__(self, layer, store: dict):
        super().__init__()
        for name, p in layer.named_parameters(recurse=False):
            if name not in _LLAMA_PROJECTIONS:
                setattr(self, name, p)
        self.q8 = store


class QuantizedLlama(nn.Module):
    """A llama-family reader with int8 / int4 (or 2-D bf16) projections and
    an untied head; embeddings and norms are shared with the float model
    (a tied head stays the float embedding)."""

    def __init__(self, model: Llama, layers, store: dict):
        super().__init__()
        self.cfg = model.cfg
        self.embed, self.final_norm = model.embed, model.final_norm
        self.layers = nn.ModuleList(layers)
        self.q8 = store


def quantize_decode_params(model, cfg, scheme: str = "int8"):
    """Weight-only quantized reader parameters (scoring and decode paths).

    Projection weights become per-output-channel int8 pairs (``<name>@q8`` /
    ``<name>@s``, 2-D in the JAX ``[K, N]`` layout). GPT-NeoX with the
    parallel residual: the layer's qkv|mlp_in weights are one N-concat stream
    (``qkv_mi``) and attn_out;mlp_out one K-concat stream with a scale per
    part (``ao_mo``, ``@sa`` / ``@sb``). Llama family: q|k|v (``qkv3``) and
    gate|up (``gateup``) N-concat streams, ``o_w``, ``down_w`` and an untied
    ``lm_head``. ``scheme="bf16"`` stores bf16 weights with unit scales in
    the same layout (no quantization). ``scheme="int4"`` keeps one stream
    per weight (``<name>@q4`` / ``<name>@s4g``, group-128 scales, K8); a
    weight whose K is not a multiple of 128 stays int8."""
    _check_reader(cfg)
    if scheme not in ("int8", "bf16", "int4"):
        raise ValueError(f"unknown quantization scheme {scheme!r}")

    def put(store, name, w2d):
        if scheme == "int4" and w2d.shape[0] % qm.INT4_GROUP == 0:
            store[f"{name}@q4"], store[f"{name}@s4g"] = qm.quantize_weight_int4(w2d)
        elif scheme == "bf16":
            store[f"{name}@q8"] = w2d.to(torch.bfloat16).contiguous()
            store[f"{name}@s"] = torch.ones((1, w2d.shape[1]), dtype=torch.float32, device=w2d.device)
        else:
            store[f"{name}@q8"], store[f"{name}@s"] = qm.quantize_weight(w2d)

    def put_kcat(store, name, wa, wb):
        if scheme == "bf16":
            store[f"{name}@q8"] = torch.cat([wa, wb]).to(torch.bfloat16).contiguous()
            store[f"{name}@sa"] = store[f"{name}@sb"] = torch.ones(
                (1, wa.shape[1]), dtype=torch.float32, device=wa.device)
        else:
            qa, qb = qm.quantize_weight(wa), qm.quantize_weight(wb)
            store[f"{name}@q8"] = torch.cat([qa.wq, qb.wq]).contiguous()
            store[f"{name}@sa"], store[f"{name}@sb"] = qa.scale, qb.scale

    if isinstance(cfg, LlamaConfig):
        layers = []
        with torch.no_grad():
            for layer in model.layers:
                store = {}
                if scheme == "int4":
                    for name in _LLAMA_PROJECTIONS:
                        put(store, name, getattr(layer, name).detach())
                else:
                    put(store, "qkv3", torch.cat([layer.q_w, layer.k_w, layer.v_w], dim=1).detach())
                    put(store, "gateup", torch.cat([layer.gate_w, layer.up_w], dim=1).detach())
                    put(store, "o_w", layer.o_w.detach())
                    put(store, "down_w", layer.down_w.detach())
                layers.append(QuantizedLlamaLayer(layer, store))
            head = {}
            if not cfg.tie_embeddings:
                put(head, "lm_head", model.lm_head.detach())
        return QuantizedLlama(model, layers, head)

    layers = []
    with torch.no_grad():
        for layer in model.layers:
            w = {n: getattr(layer, n).weight.detach().t() for n in ("qkv", "attn_out", "mlp_in", "mlp_out")}
            store = {
                "qkv_b": layer.qkv.bias.detach(), "attn_out_b": layer.attn_out.bias.detach(),
                "mlp_in_b": layer.mlp_in.bias.detach(), "mlp_out_b": layer.mlp_out.bias.detach(),
            }
            if cfg.use_parallel_residual and scheme != "int4":
                put(store, "qkv_mi", torch.cat([w["qkv"], w["mlp_in"]], dim=1))
                put_kcat(store, "ao_mo", w["attn_out"], w["mlp_out"])
            else:
                for n in ("qkv", "attn_out", "mlp_in", "mlp_out"):
                    put(store, f"{n}_w", w[n])
            layers.append(QuantizedLayer(layer, store))
        head = {}
        put(head, "embed_out", model.embed_out.weight.detach().t())
    return QuantizedGPTNeoX(model, layers, head)


# --------------------------------------------------------------------------
# forward with a cache
# --------------------------------------------------------------------------
def _block_with_cache(layer, cfg: GPTNeoXConfig, x, cache_k, cache_v, positions, key_valid, write_mask, rotary,
                      scales=None, over_cache=False):
    """One block writing its new K/V into the cache; returns x_out.
    ``over_cache``: the segment attends to the filled cache (a decode step
    or a verify segment), its K/V written at ``positions``."""
    b, s, _ = x.shape
    store = getattr(layer, "q8", None)
    ln1 = layer.ln1(x)
    fused = qm.has_q8(store, "qkv_mi") and cfg.use_parallel_residual
    if fused:
        # one K6 launch streams qkv|mlp_in for ln1 and ln2 at decode sizes
        ln2 = layer.ln2(x)
        nqkv = store["qkv_b"].numel()
        qkv_flat, mlp_h = qm.q8_dual_in_dot(store, "qkv_mi", ln1, ln2, nqkv)
        qkv = (qkv_flat + store["qkv_b"]).view(b, s, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        h_act = F.gelu(mlp_h + store["mlp_in_b"])
    else:
        q, k, v = neox_qkv(layer, cfg, ln1)
    cos, sin = rotary
    q, k = apply_partial_rotary(q, cos, sin, cfg.rotary_dims), apply_partial_rotary(k, cos, sin, cfg.rotary_dims)

    ks, vs = scales if scales is not None else (None, None)
    _write_kv(cache_k, cache_v, k, v, positions, write_mask, ks, vs, over_cache)
    attn = _block_attention(q, k, v, cache_k, cache_v, positions, key_valid, over_cache, ks, vs)

    if fused:
        # attn_out + mlp_out as one split-K stream (K7 at decode sizes)
        attn_flat = attn.transpose(1, 2).reshape(b, s, -1)
        both = qm.q8_splitk_dot(store, "ao_mo", attn_flat.to(h_act.dtype), h_act)
        return x + both + (store["attn_out_b"] + store["mlp_out_b"]).to(x.dtype)
    if cfg.use_parallel_residual:
        return x + neox_attn_out(layer, attn) + neox_mlp(layer, layer.ln2(x))
    x = x + neox_attn_out(layer, attn)
    return x + neox_mlp(layer, layer.ln2(x))


def _llama_block_with_cache(layer, cfg: LlamaConfig, x, cache_k, cache_v, positions, key_valid, write_mask, rotary,
                            window=None, scales=None, over_cache=False):
    """A llama-family block writing its grouped K/V into the cache; mirrors
    ``llama_forward`` across the family's variants (norm type and placement,
    gelu-tanh MLP, soft-capping, sliding windows). Returns x_out."""
    post_only = cfg.norm_placement == "post_output"
    pre_post = cfg.norm_placement == "pre_post"
    h = x if post_only else lm.llama_norm(cfg, x, layer.input_norm)
    q, k, v = lm._qkv(layer, cfg, h)  # q [B, H, S, hd]; k, v [B, Hkv, S, hd]
    cos, sin = rotary
    q, k = lm.apply_rotary(q, cos, sin), lm.apply_rotary(k, cos, sin)
    ks, vs = scales if scales is not None else (None, None)
    _write_kv(cache_k, cache_v, k, v, positions, write_mask, ks, vs, over_cache)
    sm_scale = cfg.query_pre_attn_scalar ** -0.5 if cfg.query_pre_attn_scalar is not None else None
    attn = _block_attention(q, k, v, cache_k, cache_v, positions, key_valid, over_cache, ks, vs, sm_scale,
                            cfg.attn_logit_softcap, window)
    attn_out = lm.attn_out_proj(layer, attn)
    if post_only or pre_post:
        attn_out = lm.llama_norm(cfg, attn_out, layer.post_attn_norm)
    x = x + attn_out
    h = x if post_only else lm.llama_norm(cfg, x, layer.post_norm)
    mlp_out = lm.llama_mlp(layer, cfg, h)
    if post_only or pre_post:
        mlp_out = lm.llama_norm(cfg, mlp_out, layer.post_mlp_norm)
    return x + mlp_out


@torch.no_grad()
def forward_with_cache(model, cfg, input_ids, positions, cache: KVCache, key_valid,
                       write_mask=None, logits_rows=None, contiguous_writes: bool = False
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Run a segment, writing K/V at ``positions``; returns (logits f32, cache).

    ``key_valid`` [B, M]: the slots that hold real keys after this call.
    A prefill segment starts at slot 0 (every prefill caller's case); its pad
    tokens must be hidden by ``write_mask``. A one-token segment without a
    ``write_mask`` is a decode step. ``contiguous_writes``: each row's
    positions are a run ``start + arange(S)`` over a filled cache (a
    speculative verify segment): its K/V replace those slots, so the slots of
    a rejected draft are overwritten, and each query attends to the cache up
    to its own position. The cache is updated in place.
    ``logits_rows`` [B]: apply the vocab head to that one position of each
    row only (logits [B, 1, V]); a prefill needs no more, and a long prompt's
    [B, S, V] f32 logits would not fit (Gemma-2: 8160 x 256000 is 8.4 GB a row)."""
    _check_reader(cfg)

    def head_input(x):
        if logits_rows is None:
            return x
        return x[torch.arange(x.shape[0], device=x.device), logits_rows][:, None]

    quantized = cache.k_scale is not None
    over_cache = write_mask is None and (input_ids.shape[1] == 1 or contiguous_writes)
    if isinstance(cfg, LlamaConfig):
        x = lm.embed_tokens(model, cfg, input_ids)
        cos, sin = lm.rotary_cos_sin(positions, cfg)  # [B, S, hd]
        rotary = (cos[:, None], sin[:, None])
        for li, layer in enumerate(model.layers):
            scales = (cache.k_scale[li], cache.v_scale[li]) if quantized else None
            x = _llama_block_with_cache(layer, cfg, x, cache.k[li], cache.v[li], positions, key_valid, write_mask,
                                        rotary, cfg.layer_window(li), scales, over_cache)
        return lm.llama_logits(model, cfg, lm.llama_norm(cfg, head_input(x), model.final_norm)), cache
    x = model.embed_in(input_ids)
    # rows of the JAX package's max_position_embeddings table, computed
    # directly at positions [B, S]; [B, 1, S, rot] to broadcast over heads
    cos, sin = rotary_cos_sin(positions, max(cfg.rotary_dims, 2), cfg.rotary_base)
    rotary = (cos[:, None], sin[:, None])
    for li, layer in enumerate(model.layers):
        scales = (cache.k_scale[li], cache.v_scale[li]) if quantized else None
        x = _block_with_cache(layer, cfg, x, cache.k[li], cache.v[li], positions, key_valid, write_mask,
                              rotary, scales, over_cache)
    return neox_logits(model, model.final_ln(head_input(x))), cache


def make_generate_fn(cfg, max_new_tokens: int, eos_id: int, temperature: float = 0.0,
                     kv_cache: str | None = None, mesh=None, param_shardings=None):
    """``(model, prompt_ids, prompt_lens, seed) -> tokens [B, max_new_tokens]``.

    prompt_ids [B, S_pad] right-padded on the model's device, prompt_lens
    [B]; rows that finish are filled with ``eos_id``. Greedy at
    ``temperature <= 0``, else sampled from ``softmax(logits / T)`` with a
    ``torch.Generator`` seeded from ``seed`` (other draws than ``jax.random``).
    ``kv_cache="int8"``: quantized cache."""
    _check_reader(cfg)
    if kv_cache not in (None, "", "none", "int8"):
        raise ValueError(f"unknown kv_cache {kv_cache!r}")
    if mesh is not None or param_shardings is not None:
        raise NotImplementedError("data- and tensor-parallel generation wait for module 14")

    def sample(lg, gen):
        if temperature <= 0.0:
            return lg.argmax(dim=-1)
        probs = torch.softmax(lg.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def fn(model, prompt_ids, prompt_lens, seed=0):
        device = prompt_ids.device
        b, s_pad = prompt_ids.shape
        max_len = s_pad + max_new_tokens
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"prompt ({s_pad}) + max_new_tokens ({max_new_tokens}) "
                             f"exceeds max_position_embeddings ({cfg.max_position_embeddings})")
        prompt_lens = prompt_lens.to(device=device, dtype=torch.long)
        cache_dtype = torch.int8 if kv_cache == "int8" else embedding(model).weight.dtype
        cache = init_cache(cfg, b, max_len, cache_dtype, device)
        slots = torch.arange(max_len, device=device)
        positions = slots[:s_pad].expand(b, s_pad)
        write_mask = slots[None, :s_pad] < prompt_lens[:, None]
        key_valid = slots[None, :] < prompt_lens[:, None]
        logits, cache = forward_with_cache(model, cfg, prompt_ids, positions, cache, key_valid, write_mask,
                                           logits_rows=prompt_lens - 1)
        gen = torch.Generator(device=device).manual_seed(int(seed)) if temperature > 0 else None
        last = sample(logits[:, 0], gen)
        tokens = torch.full((b, max_new_tokens), eos_id, dtype=torch.long, device=device)
        tokens[:, 0] = last
        finished = last == eos_id
        cur = prompt_lens.clone()
        for step in range(1, max_new_tokens):
            # the host looks at `finished` every 8 steps only: later steps of
            # a finished batch write eos, as the JAX loop's early exit leaves
            if step % 8 == 0 and bool(finished.all()):
                break
            key_valid = slots[None, :] < (cur + 1)[:, None]
            logits, cache = forward_with_cache(model, cfg, last[:, None], cur[:, None], cache, key_valid)
            nxt = torch.where(finished, eos_id, sample(logits[:, 0], gen))
            tokens[:, step] = nxt
            last, cur, finished = nxt, cur + 1, finished | (nxt == eos_id)
        return tokens

    return fn
