"""Attention forward: the hand-written Hopper kernel K1 and its plain version.

Ports ``retrieval_scaling_tpu/ops/flash_attention.py``. The Pallas kernels
there (``_flash_oneshot_kernel`` / ``_flash_kernel``) become one CUDA C++
kernel, ``csrc/flash_attn_fwd.cu``, built for ``sm_90a`` and bound with
ctypes. Layouts are the JAX package's: q/k/v ``[B, H, S, D]``, k/v may carry
fewer (GQA) heads, ``kv_mask`` ``[B, Sk]`` with True = keep.

* ``attention_reference`` is the plain PyTorch version (the counterpart of
  ``xla_attention``, but with the kernel's convention that a row with no
  visible key is exactly 0; ``xla_attention`` averages V uniformly there).
* ``flash_attention`` is the wrapper: a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel or raises.
* ``multi_head_attention`` is the models' entry point.
* K2 is the same kernel with the Pallas kernel's ``window`` (a causal
  sliding window: key j is visible to query i iff ``i - window < j <= i`` on
  end-aligned positions; key tiles wholly below the band are skipped) and
  ``logit_cap`` (Gemma-2's ``cap * tanh(s * scale / cap)``, applied before
  the mask) features.
* K2s is the same kernel with the Pallas kernel's ``segment_ids`` feature
  (packed rows): ``segment_ids`` [B, S] (contiguous runs, 0 = pad, Sq ==
  Sk); key j is visible to row i only if both carry the same nonzero id, so
  a pad row is exactly 0. ``segment_bounds`` (XLA in the JAX package, plain
  torch here) gives each token's run [lo, hi); the kernel runs each q tile
  over the key tiles of [min lo, max hi) of its rows only. Window, cap, key
  mask and segments compose in the one kernel.
* ``flash_decode`` is K3, the decode route of the same Pallas kernel
  (``flash_attention_sharded`` from ``models/generate.py``) and the
  attention of a speculative verify segment over a filled cache: Sq <= 16
  query rows against an M-slot KV cache with a [B, M] key mask, GQA, an
  optional soft-cap, f32 / bf16 / fp16, built from ``csrc/flash_decode.cu``.
  With ``q_pos`` [B, Sq] query j of row b sees slot s only where
  ``s <= q_pos[b, j]`` (and ``s > q_pos[b, j] - window``); the kernel takes
  each row's bound itself. ``flash_decode_reference`` is its plain version.

Head dims 64, 96 (Phi-3), 128 and 256 are kernel instances.

Each counts what it does on the card: ``flash_attention.launches`` and
``flash_decode.launches`` count kernel launches (``.window_launches`` /
``.cap_launches`` / ``.segment_launches`` those with a window, a cap or
segments; ``flash_decode.verify_launches`` those with per-query positions
and more than one query row), ``.cuda_calls`` on the
plain versions their calls on CUDA tensors (the main path leaves them at 0).
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30

_KERNEL_HEAD_DIMS = (64, 96, 128, 256)
_KERNEL_DTYPES = (torch.bfloat16, torch.float16)
_DECODE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DECODE_MAX_SQ = 16  # a verify segment of draft_len + 1 <= 16 tokens is one launch
# K3 splits the cache into runs of this many keys, whatever M, Sq or the row
# count: a row then sums its keys in the same order in a one-token step and
# in a verify segment (csrc/flash_decode.cu)
_DECODE_KEYS_PER_SPLIT = 128


def _plain_attention(q, k, v, kv_mask, causal, sm_scale, window=None, logit_cap=None, segment_ids=None):
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, sq, d)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k.float()) * sm_scale
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    if kv_mask is not None:
        # [B, Sk], or [B, Sq, Sk] for a per-query mask
        mask = kv_mask.bool()[:, None, None, None, :] if kv_mask.dim() == 2 else kv_mask.bool()[:, None, None]
        s = s.masked_fill(~mask, NEG_INF)
    if causal or window is not None:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        hide = ki > qi
        if window is not None:
            hide = hide | (ki <= qi - window)
        s = s.masked_fill(hide, NEG_INF)
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        s = s.masked_fill(~same[:, None, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF * 0.5)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqm,bkmd->bkgqd", p, v.float()) / l
    return out.reshape(b, h, sq, d).to(q.dtype)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    causal: bool = False,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_cap: float | None = None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain attention in f32, returned in q's dtype.

    Masked scores are NEG_INF, the exp reference is clamped at NEG_INF / 2
    and the normaliser floored at 1e-30, as in the Pallas kernels, so fully
    masked rows give exactly 0. Causal rows align to the end of the key row.
    ``window`` hides keys at or below ``i - window`` (and implies causal);
    ``logit_cap`` caps the scaled scores before the mask, as ``xla_attention``.
    ``segment_ids`` [B, S] hides every key of another segment, and every key
    from a pad row (id 0). GQA: query head h reads kv head h // (H // Hkv).
    """
    if q.is_cuda:
        attention_reference.cuda_calls += 1
    return _plain_attention(q, k, v, kv_mask, causal, sm_scale, window, logit_cap, segment_ids)


attention_reference.cuda_calls = 0


def segment_bounds(segment_ids: torch.Tensor):
    """Per-token [lo, hi) span of the token's segment along the row, as
    int32 [B, S] each (the JAX ``segment_bounds``). Segments must be
    contiguous runs (the packed layout); pad tokens (segment 0) get lo = hi = 0."""
    seg = segment_ids.to(torch.int32)
    b, s = seg.shape
    idx = torch.arange(s, dtype=torch.int32, device=seg.device).expand(b, s)
    edge = torch.full((b, 1), -1, dtype=torch.int32, device=seg.device)
    start = seg != torch.cat([edge, seg[:, :-1]], dim=1)  # first token of each run
    lo = torch.cummax(torch.where(start, idx, 0), dim=1).values
    end = seg != torch.cat([seg[:, 1:], edge], dim=1)  # last token of each run
    hi = torch.where(end.flip(1), (idx + 1).flip(1), s).cummin(dim=1).values.flip(1)
    pad = seg == 0
    return torch.where(pad, 0, lo).to(torch.int32), torch.where(pad, 0, hi).to(torch.int32)


def _check_kernel_inputs(q, k, v, kv_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[1]}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (supported: {_KERNEL_HEAD_DIMS})")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes bf16/fp16 q, k, v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        # rows are copied in 16-byte pieces: unit last-dim stride, other
        # strides in multiples of 8 elements, a 16-byte aligned base
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} strides {t.stride()} do not fit the kernel's 16-byte row copies")
    if kv_mask is not None and (
        kv_mask.shape != (b, k.shape[2]) or kv_mask.device != q.device
    ):
        raise ValueError(f"kv_mask must be [B, Sk] = {(b, k.shape[2])} on {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    causal: bool = False,
    sm_scale: float | None = None,
    window: int | None = None,
    logit_cap: float | None = None,
    segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1 / K2 / K2s wrapper. CPU tensors take ``attention_reference``;
    CUDA tensors launch ``csrc/flash_attn_fwd.cu`` on the current stream or
    raise.

    On CUDA, q/k/v may be strided views (the kernel takes batch, head and
    row strides) and the result is a [B, H, S, D] view of a [B, S, H, D]
    buffer, so ``out.transpose(1, 2).reshape(B, S, H * D)`` is free."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        causal = True  # HF sliding_window semantics are causal
    if segment_ids is not None and (segment_ids.shape != (q.shape[0], q.shape[2]) or k.shape[2] != q.shape[2]):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} must be [B, S] with Sq == Sk, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_mask, causal, sm_scale, window, logit_cap, segment_ids)
    _check_kernel_inputs(q, k, v, kv_mask)
    from retrieval_scaling_tpu_torch.ops._build import load_library

    lib = load_library("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_void_p,
    ]
    b, h, sq, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if sq == 0:
        return out
    mask = None if kv_mask is None else kv_mask.to(torch.bool).contiguous()
    seg = lo = hi = None
    if segment_ids is not None:
        if segment_ids.device != q.device:
            raise ValueError(f"segment_ids must be on {q.device}")
        seg = segment_ids.to(torch.int32).contiguous()
        lo, hi = segment_bounds(seg)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (seg, lo, hi)), out.data_ptr(),
        b, h, k.shape[1], sq, k.shape[2], d, int(causal), float(sm_scale), int(window or 0),
        float(logit_cap or 0.0), int(q.dtype == torch.float16), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed with CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.window_launches += window is not None
    flash_attention.cap_launches += bool(logit_cap)
    flash_attention.segment_launches += segment_ids is not None
    return out


flash_attention.launches = 0
flash_attention.window_launches = 0
flash_attention.cap_launches = 0
flash_attention.segment_launches = 0


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    causal: bool = False,
    sm_scale: float | None = None,
    segment_ids: torch.Tensor | None = None,
    window: int | None = None,
    logit_cap: float | None = None,
) -> torch.Tensor:
    """Attention entry point of the models. q, k, v: [B, H, S, D].

    Every call goes through ``flash_attention``, so on a CUDA tensor every
    call is a K1 launch (K2 with a window or a cap, K2s with
    ``segment_ids``). f32 inputs on the card (a reader loaded in f32) enter
    the kernel as bf16 with f32 sums, the precision of the TPU kernel's
    default-precision f32 dots, and come back in f32.
    """
    kw = dict(kv_mask=kv_mask, causal=causal, sm_scale=sm_scale, window=window, logit_cap=logit_cap,
              segment_ids=segment_ids)
    if q.is_cuda and q.dtype == torch.float32:
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        return flash_attention(q, k, v, **kw).float()
    return flash_attention(q, k, v, **kw)


def flash_decode_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
    logit_cap: float | None = None,
    q_pos: torch.Tensor | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """K3's plain version: attention of q [B, H, Sq, D] over the cache
    k/v [B, Hkv, M, D] with the [B, M] key mask, scores soft-capped by
    ``logit_cap``, in f32, returned in q's dtype; a row with no visible key
    is exactly 0. With ``q_pos`` [B, Sq], query j of row b also hides the
    slots above ``q_pos[b, j]`` and, with ``window``, those at or below
    ``q_pos[b, j] - window``."""
    if q.is_cuda:
        flash_decode_reference.cuda_calls += 1
    mask = _decode_mask(q, k, kv_mask, q_pos, window)
    return _plain_attention(q, k, v, mask, False, sm_scale, logit_cap=logit_cap)


flash_decode_reference.cuda_calls = 0


def _decode_mask(q, k, kv_mask, q_pos, window):
    """The [B, M] key mask, or with ``q_pos`` the [B, Sq, M] per-query mask."""
    if window is not None and q_pos is None:
        raise ValueError("a window needs q_pos: it moves with each query's position")
    if q_pos is None:
        return kv_mask
    b, sq, m = q.shape[0], q.shape[2], k.shape[2]
    if q_pos.shape != (b, sq):
        raise ValueError(f"q_pos must be [B, Sq] = {(b, sq)}, got {tuple(q_pos.shape)}")
    key = torch.arange(m, device=q.device)[None, None, :]
    pos = q_pos.to(device=q.device, dtype=torch.long)[:, :, None]
    vis = key <= pos
    if window is not None:
        vis = vis & (key > pos - window)
    return vis if kv_mask is None else vis & kv_mask.bool()[:, None, :]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
    logit_cap: float | None = None,
    q_pos: torch.Tensor | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """K3 wrapper. CPU tensors take ``flash_decode_reference``; CUDA tensors
    launch ``csrc/flash_decode.cu`` on the current stream or raise. With
    ``q_pos`` [B, Sq] each query row is causal by position over the cache
    (a decode step or a verify segment) and ``window`` moves with it;
    without it every row sees the whole [B, M] mask."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, kv_mask, sm_scale, logit_cap, q_pos, window)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} must be [B, H, S, D]")
    b, h, sq, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if not 1 <= sq <= _DECODE_MAX_SQ:
        raise ValueError(f"K3 takes 1..{_DECODE_MAX_SQ} query rows, got {sq}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (supported: {_KERNEL_HEAD_DIMS})")
    if q.dtype not in _DECODE_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K3 takes f32/bf16/fp16 q, k, v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {q.device}")
    if kv_mask is not None and (kv_mask.shape != (b, m) or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be [B, M] = {(b, m)} on {q.device}")
    if window is not None and q_pos is None:
        raise ValueError("a window needs q_pos: it moves with each query's position")
    pos = None
    if q_pos is not None:
        if q_pos.shape != (b, sq) or q_pos.device != q.device:
            raise ValueError(f"q_pos must be [B, Sq] = {(b, sq)} on {q.device}")
        pos = q_pos.to(torch.int32).contiguous()
    from retrieval_scaling_tpu_torch.ops._build import load_library

    lib = load_library("flash_decode")
    fn = lib.flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    qc = q.contiguous()
    rows = (h // hkv) * sq
    per = _DECODE_KEYS_PER_SPLIT
    splits = _ceil_div(m, per)
    out = torch.empty_like(qc)
    part_acc = torch.empty((b * hkv * splits * rows * d,) if splits > 1 else (1,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b * hkv * splits * rows * 2,) if splits > 1 else (1,), dtype=torch.float32,
                          device=q.device)
    mask = None if kv_mask is None else kv_mask.to(torch.bool).contiguous()
    err = fn(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
        None if pos is None else pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, h, hkv, sq, m, d, per, splits, int(window or 0), float(sm_scale), float(logit_cap or 0.0),
        _DECODE_DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed with CUDA error {err}")
    flash_decode.launches += 1
    flash_decode.cap_launches += bool(logit_cap)
    flash_decode.verify_launches += q_pos is not None and sq > 1
    return out


flash_decode.launches = 0
flash_decode.cap_launches = 0
flash_decode.verify_launches = 0
