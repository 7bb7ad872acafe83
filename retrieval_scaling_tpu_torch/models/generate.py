"""Autoregressive generation for the GPT-NeoX reader with a KV cache.

Ports the GPT-NeoX half of ``retrieval_scaling_tpu/models/generate.py``:

* ``KVCache`` / ``init_cache``: per-layer ``[B, H, max_len, hd]`` buffers
  (float, or int8 rows with per-(b, head, slot) f32 scales);
* ``_write_kv``: a prefill writes the slots [0, S) of the tokens that
  ``write_mask`` lets through (one slice write; pads keep their zeros, as
  the JAX one-hot writes left them); a decode step writes one row per
  sequence in place (``index_put_``), where the JAX package aliased the
  while-loop carry;
* ``_attention_with_cache``: decode steps with a float cache run K3
  (``ops.flash_attention.flash_decode``) at every cache length; the
  prefill and the int8-cache attention are plain torch here, as they are
  XLA code in the JAX package;
* ``quantize_decode_params`` (int8 and bf16 schemes with the fused
  ``qkv_mi`` / ``ao_mo`` layout of the parallel residual), ``forward_with_cache``
  and ``make_generate_fn`` (greedy or temperature sampling).

``lax.while_loop`` becomes a Python loop whose tokens stay on the device;
``mesh`` / ``param_shardings`` (module 14), the llama family (module 10) and
the int4 scheme (kernel K8) raise until their slices land.
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
from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
from retrieval_scaling_tpu_torch.ops.flash_attention import flash_decode

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: List[torch.Tensor]  # L per-layer tensors [B, H, max_len, hd], written in place
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]] = None  # int8 cache: L tensors [B, H, max_len] f32
    v_scale: Optional[List[torch.Tensor]] = None


def _check_neox(cfg) -> None:
    if not isinstance(cfg, GPTNeoXConfig):
        raise NotImplementedError(f"{type(cfg).__name__} readers wait for the llama family (module 10)")


def init_cache(cfg: GPTNeoXConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> KVCache:
    """Zeroed KV cache; ``dtype=torch.int8`` gives int8 rows with f32 scales."""
    _check_neox(cfg)
    shape = (batch, cfg.num_heads, max_len, cfg.head_dim)
    zeros = lambda dt, shp: [torch.zeros(shp, dtype=dt, device=device) for _ in range(cfg.num_layers)]  # noqa: E731
    if dtype == torch.int8:
        return KVCache(zeros(torch.int8, shape), zeros(torch.int8, shape),
                       zeros(torch.float32, shape[:3]), zeros(torch.float32, shape[:3]))
    return KVCache(zeros(dtype, shape), zeros(dtype, shape))


def _attention_with_cache(q, keys, values, q_pos, key_valid, sm_scale=None, k_scale=None, v_scale=None,
                          all_visible=False):
    """q [B, H, S, hd] against the cache [B, Hkv, M, hd]; q_pos [B, S],
    key_valid [B, M]. Keys past a query's position are hidden unless
    ``all_visible`` (a decode step, where key_valid is the whole mask).

    int8 cache: ``k_scale`` / ``v_scale`` [B, Hkv, M] fold into the scores
    and the probabilities, with bf16 operands and f32 sums, as in JAX."""
    b, h, sq, hd = q.shape
    hkv = keys.shape[1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    if all_visible and k_scale is None:
        return flash_decode(q, keys, values, kv_mask=key_valid, sm_scale=sm_scale)
    if hkv != h:  # GQA: query groups fold into the row axis
        g = h // hkv
        q2 = q.reshape(b, hkv, g * sq, hd)
        qpos2 = q_pos[:, None, :].expand(b, g, sq).reshape(b, g * sq)
        out = _attention_with_cache(q2, keys, values, qpos2, key_valid, sm_scale, k_scale, v_scale)
        return out.reshape(b, h, sq, hd)
    if k_scale is not None:
        scores = q.to(torch.bfloat16).float() @ keys.to(torch.bfloat16).float().transpose(-1, -2)
        scores = scores * k_scale[:, :, None, :]
    else:
        scores = q.float() @ keys.float().transpose(-1, -2)
    scores = scores * sm_scale
    key_pos = torch.arange(keys.shape[2], device=q.device)
    ok = key_valid[:, None, None, :] & (key_pos[None, None, None, :] <= q_pos[:, None, :, None])
    probs = torch.softmax(scores.masked_fill(~ok, NEG_INF), dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, :]
        out = probs.to(torch.bfloat16).float() @ values.to(torch.bfloat16).float()
        return out.to(q.dtype)
    return (probs.to(values.dtype).float() @ values.float()).to(values.dtype)


def _quantize_kv_rows(t):
    """[B, H, S, hd] float -> (int8 rows, f32 scales [B, H, S])."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(tf / safe[..., None]).to(torch.int8), scale


def _write_kv(cache_k, cache_v, k, v, positions, write_mask, ks=None, vs=None):
    """Write new K/V ([B, H, S, hd]) into the cache ([B, H, M, hd]) in place.

    Decode (``write_mask is None`` and S == 1): one row per sequence at its
    position. Prefill: the segment's slots [0, S); tokens that
    ``write_mask`` [B, S] hides keep the slot's previous (zero) content."""
    if cache_k.dtype == torch.int8:
        (k, k_sc), (v, v_sc) = _quantize_kv_rows(k), _quantize_kv_rows(v)
    b, _, s, _ = k.shape
    if write_mask is None and s == 1:
        rows, pos = torch.arange(b, device=k.device), positions[:, 0]
        cache_k[rows, :, pos] = k[:, :, 0].to(cache_k.dtype)
        cache_v[rows, :, pos] = v[:, :, 0].to(cache_v.dtype)
        if ks is not None:
            ks[rows, :, pos] = k_sc[:, :, 0]
            vs[rows, :, pos] = v_sc[:, :, 0]
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


def quantize_decode_params(model: GPTNeoX, cfg: GPTNeoXConfig, scheme: str = "int8") -> QuantizedGPTNeoX:
    """Weight-only int8 reader parameters (scoring and decode paths).

    Projection weights become per-output-channel int8 pairs (``<name>@q8`` /
    ``<name>@s``, 2-D in the JAX ``[K, N]`` layout); with the parallel
    residual the layer's qkv|mlp_in weights are one N-concat stream
    (``qkv_mi``) and attn_out;mlp_out one K-concat stream with a scale per
    part (``ao_mo``, ``@sa`` / ``@sb``). ``scheme="bf16"`` stores bf16
    weights with unit scales in the same layout (no quantization)."""
    _check_neox(cfg)
    if scheme == "int4":
        raise NotImplementedError("the int4 scheme waits for kernel K8")
    if scheme not in ("int8", "bf16"):
        raise ValueError(f"unknown quantization scheme {scheme!r}")

    def put(store, name, w2d):
        if scheme == "bf16":
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

    layers = []
    with torch.no_grad():
        for layer in model.layers:
            w = {n: getattr(layer, n).weight.detach().t() for n in ("qkv", "attn_out", "mlp_in", "mlp_out")}
            store = {
                "qkv_b": layer.qkv.bias.detach(), "attn_out_b": layer.attn_out.bias.detach(),
                "mlp_in_b": layer.mlp_in.bias.detach(), "mlp_out_b": layer.mlp_out.bias.detach(),
            }
            if cfg.use_parallel_residual:
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
                      scales=None):
    """One block writing its new K/V into the cache; returns x_out."""
    decode = write_mask is None and x.shape[1] == 1
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
    _write_kv(cache_k, cache_v, k, v, positions, write_mask, ks, vs)
    attn = _attention_with_cache(q, cache_k, cache_v, positions, key_valid, k_scale=ks, v_scale=vs,
                                 all_visible=decode)

    if fused:
        # attn_out + mlp_out as one split-K stream (K7 at decode sizes)
        attn_flat = attn.transpose(1, 2).reshape(b, s, -1)
        both = qm.q8_splitk_dot(store, "ao_mo", attn_flat.to(h_act.dtype), h_act)
        return x + both + (store["attn_out_b"] + store["mlp_out_b"]).to(x.dtype)
    if cfg.use_parallel_residual:
        return x + neox_attn_out(layer, attn) + neox_mlp(layer, layer.ln2(x))
    x = x + neox_attn_out(layer, attn)
    return x + neox_mlp(layer, layer.ln2(x))


@torch.no_grad()
def forward_with_cache(model, cfg: GPTNeoXConfig, input_ids, positions, cache: KVCache, key_valid,
                       write_mask=None) -> Tuple[torch.Tensor, KVCache]:
    """Run a segment, writing K/V at ``positions``; returns (logits f32, cache).

    ``key_valid`` [B, M]: the slots that hold real keys after this call.
    A prefill segment starts at slot 0 (every caller's case); its pad tokens
    must be hidden by ``write_mask``. The cache is updated in place."""
    _check_neox(cfg)
    x = model.embed_in(input_ids)
    # rows of the JAX package's max_position_embeddings table, computed
    # directly at positions [B, S]; [B, 1, S, rot] to broadcast over heads
    cos, sin = rotary_cos_sin(positions, max(cfg.rotary_dims, 2), cfg.rotary_base)
    rotary = (cos[:, None], sin[:, None])
    quantized = cache.k_scale is not None
    for li, layer in enumerate(model.layers):
        scales = (cache.k_scale[li], cache.v_scale[li]) if quantized else None
        x = _block_with_cache(layer, cfg, x, cache.k[li], cache.v[li], positions, key_valid, write_mask,
                              rotary, scales)
    x = model.final_ln(x)
    return neox_logits(model, x), cache


def make_generate_fn(cfg: GPTNeoXConfig, max_new_tokens: int, eos_id: int, temperature: float = 0.0,
                     kv_cache: str | None = None, mesh=None, param_shardings=None):
    """``(model, prompt_ids, prompt_lens, seed) -> tokens [B, max_new_tokens]``.

    prompt_ids [B, S_pad] right-padded on the model's device, prompt_lens
    [B]; rows that finish are filled with ``eos_id``. Greedy at
    ``temperature <= 0``, else sampled from ``softmax(logits / T)`` with a
    ``torch.Generator`` seeded from ``seed`` (other draws than ``jax.random``).
    ``kv_cache="int8"``: quantized cache."""
    _check_neox(cfg)
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
        cache_dtype = torch.int8 if kv_cache == "int8" else model.embed_in.weight.dtype
        cache = init_cache(cfg, b, max_len, cache_dtype, device)
        slots = torch.arange(max_len, device=device)
        positions = slots[:s_pad].expand(b, s_pad)
        write_mask = slots[None, :s_pad] < prompt_lens[:, None]
        key_valid = slots[None, :] < prompt_lens[:, None]
        logits, cache = forward_with_cache(model, cfg, prompt_ids, positions, cache, key_valid, write_mask)
        gen = torch.Generator(device=device).manual_seed(int(seed)) if temperature > 0 else None
        last = sample(logits[torch.arange(b, device=device), prompt_lens - 1], gen)
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
