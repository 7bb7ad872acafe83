"""Weight-only int8 / int4 / bf16 decode matmuls: the hand-written Hopper
kernels K6, K7, K8 and K9 and their plain versions.

Ports the decode half of ``retrieval_scaling_tpu/ops/quant_matmul.py``:

* ``QuantizedWeight``, ``quantize_weight``, ``_rowquant`` and
  ``_apply_activation``, the same arithmetic in f32;
* K6 ``w8_stream`` (``_w8_decode_kernel``): ``bf16(x) @ bf16(w) * scale[n]``
  with f32 sums and no activation quantization, for m <= 128 rows; with two
  inputs, column blocks below ``n_split`` read x1 and the rest x2
  (``q8_dual_in_dot``);
* K7 ``w8_splitk`` (``_w8_splitk_kernel``): ``xa @ Wa * sa + xb @ Wb * sb``
  from one row-concatenated ``[Wa; Wb]`` (GPT-NeoX's parallel residual);
* K9 ``int8_matmul`` (``_int8_matmul_kernel``): rows quantised to int8 by
  their absmax, int8 x int8 -> int32, then ``* row scale * column scale +
  bias`` and an activation;
* K10 ``int8_matmul_residual_ln`` (``_int8_res_ln_kernel``): the int8 FFN
  tail of the encoder, ``LayerNorm(x + dequant(int8dot(rowquant(h), wq)) +
  bias) * gamma + beta``, with K9's row quantisation pre-pass, on a weight
  stored once in the [N, K] layout (``res_ln_layout``); one CTA owns
  whole output rows, so the residual add and the LayerNorm statistics stay
  on the chip. Its plain version is ``int8_res_ln_reference`` (the spec is
  ``_int8_res_ln_xla``). ``_resident_ok`` and the ``m % BM`` gate were VMEM
  budgets: K10 takes every m, and output widths of 128 to 1,024 columns;
* K8 ``int4_decode_matmul`` (``_int4_decode_kernel``): rows quantised to
  int8 as for K9, group-128 int4 weights (``QuantizedWeight4``,
  ``quantize_weight_int4``, ``_int4_unpack``: the JAX package's packing, two
  nibbles per byte along K), per-group int32 dots scaled by their group's
  f32 scale and summed, then ``* row scale``. Every row count takes K8;
* the router ``int8_decode_matmul`` and the store helpers ``has_q8``,
  ``q8_dot``, ``q8_col_slice_dot``, ``q8_row_part_dot``, ``q8_dual_in_dot``
  and ``q8_splitk_dot`` over a dict that holds ``<name>@q8`` / ``@s`` (or
  ``@sa`` / ``@sb``) in the JAX package's ``[K, N]`` layout; ``has_q8`` and
  ``q8_dot`` also take the int4 pairs ``<name>@q4`` / ``@s4g``.

Routing by row count m fixes the numbers, as in the JAX package: m <= 128
(``M_DECODE_MAX``) takes K6 / K7, larger m with int8 weights takes K9, and
larger m with bf16 weights (the ``bf16`` scheme) is a plain matmul; int4
weights take K8 at every m. The JAX cut-offs at 4 * BM rows (and K8's 128
rows) and ``_resident_ok`` were VMEM budgets, and so were
``pad_cols_for_stream`` and its ``@padcols`` markers, the 32-row sublane
padding and the stacked dual-input rows: none is carried over.

Each wrapper takes its plain version only for a CPU tensor and launches its
kernel (``csrc/quant_matmul.cu``) for a CUDA tensor or raises. ``.launches``
on a wrapper counts kernel launches, ``.cuda_calls`` on a plain version its
calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from retrieval_scaling_tpu_torch.ops.matmul import matmul_f32

M_DECODE_MAX = 128  # largest row count the weight-streaming kernels take

_ACTIVATIONS = {"none": 0, "gelu_tanh": 1, "gelu_exact": 2}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BK = 64          # K rows per stage of the streaming kernels (csrc kBK)
_STREAM_BN = 64   # columns per CTA of the streaming kernels (csrc kBN)
_TARGET_CTAS = 264  # two CTAs for each of the H100's 132 SMs
_MAX_SPLITS = 64


INT4_GROUP = 128  # K rows per int4 scale group


class QuantizedWeight(NamedTuple):
    """Per-output-channel symmetric int8 (or bf16 with unit scales) weight."""

    wq: torch.Tensor     # [K, N] int8 or bf16
    scale: torch.Tensor  # [1, N] f32 (dequant multiplier)


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """[K, N] float -> per-column symmetric int8 (the JAX arithmetic in f32,
    bit for bit: a true division for the scale)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0, keepdim=True).clamp_min(1e-12)
    scale = absmax / torch.full_like(absmax, 127.0)
    wq = torch.round(wf / scale).to(torch.int8).contiguous()
    return QuantizedWeight(wq=wq, scale=scale)


class QuantizedWeight4(NamedTuple):
    """Group-128 symmetric int4 weight, nibble-packed along K."""

    packed: torch.Tensor  # [K // 2, N] uint8: low nibble row k, high nibble row k + K/2 (value + 8)
    scale: torch.Tensor   # [K // INT4_GROUP, N] f32


def quantize_weight_int4(w: torch.Tensor) -> QuantizedWeight4:
    """[K, N] float -> group-128 symmetric int4 in [-7, 7], packed as the JAX
    package packs it (bit for bit: true divisions, round half to even)."""
    k, n = w.shape
    if k % INT4_GROUP:
        raise ValueError(f"K = {k} is not a multiple of {INT4_GROUP}")
    wf = w.float().reshape(k // INT4_GROUP, INT4_GROUP, n)
    absmax = wf.abs().amax(dim=1).clamp_min(1e-12)  # [G, N]
    scale = absmax / torch.full_like(absmax, 7.0)
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7).reshape(k, n)
    offs = (q + 8).to(torch.uint8)
    lo, hi = offs[: k // 2], offs[k // 2:]
    return QuantizedWeight4((lo | (hi << 4)).contiguous(), scale.contiguous())


def _int4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """[K // 2, N] uint8 -> [K, N] int8 in [-7, 7] (top/bottom-half layout)."""
    p32 = packed.to(torch.int32)
    return torch.cat([(p32 & 0xF) - 8, (p32 >> 4) - 8]).to(torch.int8)


def _rowquant(x: torch.Tensor):
    """Per-row symmetric int8 quantization (f32 in, int8 + f32 scale out)."""
    absmax = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    # true divisions, as in JAX and K9: torch turns a division with a Python
    # scalar operand into a multiplication by a reciprocal
    c127 = torch.full_like(absmax, 127.0)
    xq = torch.round(x * (c127 / absmax)).to(torch.int8)
    return xq, absmax / c127


def _apply_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "none":
        return x
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if activation == "gelu_exact":
        return F.gelu(x)
    raise ValueError(f"unknown activation {activation!r}")


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match K = {k}")
    return x.reshape(-1, k)


def _scale_row(scale: torch.Tensor, n: int) -> torch.Tensor:
    return scale.reshape(1, n).float()


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def int8_matmul_reference(x2d, wq, scale, bias=None, activation="none", out_dtype=torch.bfloat16):
    """K9's plain version: rowquant(x) . wq summed in float64 (exact for
    int8 x int8 at any K the readers use), then ``* row scale * column scale
    + bias`` in f32, the activation, the output dtype."""
    if x2d.is_cuda:
        int8_matmul_reference.cuda_calls += 1
    xq, row_scale = _rowquant(x2d.float())
    acc = (xq.double() @ wq.double()).float()
    out = acc * row_scale * _scale_row(scale, wq.shape[1])
    if bias is not None:
        out = out + bias.float().reshape(1, -1)
    return _apply_activation(out, activation).to(out_dtype)


int8_matmul_reference.cuda_calls = 0


def w8_stream_reference(x2d, w, scale, out_dtype, x2=None, n_split=None):
    """K6's plain version: ``bf16(x) @ bf16(w) * scale`` with f32 sums; with
    ``x2``, columns at and past ``n_split`` read x2."""
    if x2d.is_cuda:
        w8_stream_reference.cuda_calls += 1
    wf = w.to(torch.bfloat16).float()
    sc = _scale_row(scale, w.shape[1])
    xb = x2d.to(torch.bfloat16).float()
    if x2 is None:
        return ((xb @ wf) * sc).to(out_dtype)
    x2b = x2.to(torch.bfloat16).float()
    y1 = (xb @ wf[:, :n_split]) * sc[:, :n_split]
    y2 = (x2b @ wf[:, n_split:]) * sc[:, n_split:]
    return torch.cat([y1, y2], dim=1).to(out_dtype)


w8_stream_reference.cuda_calls = 0


def w8_splitk_reference(xa, xb, w, sa, sb, out_dtype):
    """K7's plain version: ``xa @ Wa * sa + xb @ Wb * sb`` (bf16 operands,
    f32 sums) from the row-concatenated ``w = [Wa; Wb]``."""
    if xa.is_cuda:
        w8_splitk_reference.cuda_calls += 1
    ka, n = xa.shape[1], w.shape[1]
    wf = w.to(torch.bfloat16).float()
    acc_a = xa.to(torch.bfloat16).float() @ wf[:ka]
    acc_b = xb.to(torch.bfloat16).float() @ wf[ka:]
    return (acc_a * _scale_row(sa, n) + acc_b * _scale_row(sb, n)).to(out_dtype)


w8_splitk_reference.cuda_calls = 0


def int4_matmul_reference(x2d, packed, scale, out_dtype=torch.bfloat16):
    """K8's plain version (the JAX ``_int4_dot``): rowquant(x) with true
    divisions, one exact int32 dot per group of 128 K rows (summed in
    float64), ``acc = acc + part * scale[g]`` in group order in f32, then
    ``* row scale``."""
    if x2d.is_cuda:
        int4_matmul_reference.cuda_calls += 1
    xq, row_scale = _rowquant(x2d.float())
    w = _int4_unpack(packed)
    acc = torch.zeros((x2d.shape[0], w.shape[1]), dtype=torch.float32, device=x2d.device)
    for g in range(w.shape[0] // INT4_GROUP):
        sl = slice(g * INT4_GROUP, (g + 1) * INT4_GROUP)
        part = (xq[:, sl].double() @ w[sl].double()).float()
        acc = acc + part * scale[g].float()[None, :]
    return (acc * row_scale).to(out_dtype)


int4_matmul_reference.cuda_calls = 0


def int8_res_ln_reference(h2d, x2d, wq_nk, scale, bias, ln_scale, ln_bias, eps):
    """K10's plain version (the JAX ``_int8_res_ln_xla``): rowquant(h) . wq
    summed in float64 (exact), ``* row scale * column scale + bias + x`` in
    f32, the row mean and the mean of the squared deviations, then
    ``(y - mean) * rsqrt(var + eps) * ln_scale + ln_bias`` in x's dtype.
    ``wq_nk`` is the weight in K10's [N, K] layout (``res_ln_layout``)."""
    if h2d.is_cuda:
        int8_res_ln_reference.cuda_calls += 1
    n = wq_nk.shape[0]
    hq, row_scale = _rowquant(h2d.float())
    acc = (hq.double() @ wq_nk.double().t()).float()
    y = acc * row_scale * _scale_row(scale, n) + bias.float().reshape(1, n) + x2d.float()
    mean = y.mean(dim=1, keepdim=True)
    var = (y - mean).square().mean(dim=1, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + eps) * ln_scale.float().reshape(1, n) + ln_bias.float().reshape(1, n)
    return out.to(x2d.dtype)


int8_res_ln_reference.cuda_calls = 0


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------
def _lib():
    from retrieval_scaling_tpu_torch.ops._build import load_library

    lib = load_library("quant_matmul")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w8_stream.restype = i
        lib.w8_stream.argtypes = [p] * 7 + [i] * 8 + [p, p]
        lib.int8_rowquant.restype = i
        lib.int8_rowquant.argtypes = [p, p, p, i, i, i, p]
        lib.int8_gemm.restype = i
        lib.int8_gemm.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.int4_gemm.restype = i
        lib.int4_gemm.argtypes = [p] * 6 + [i] * 7 + [p, p]
        lib.int8_res_ln.restype = i
        lib.int8_res_ln.argtypes = [p] * 9 + [i] * 4 + [ctypes.c_float, p]
        lib._bound = True
    return lib


def _check_cuda(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}")


def _check_weight(w: torch.Tensor, kinds) -> int:
    """Row stride of a [K, N] weight view with unit column stride and
    16-byte aligned rows, as the kernels' 16-byte copies need."""
    if w.dtype not in kinds:
        raise TypeError(f"weight dtype {w.dtype} not supported (supported: {kinds})")
    ld = w.stride(0)
    if w.stride(1) != 1 or (ld * w.element_size()) % 16 or w.data_ptr() % 16:
        raise ValueError(f"weight strides {w.stride()} do not fit the kernel's 16-byte copies")
    return ld


def _splits(k_parts, n_blocks: int):
    """K ranges (begin, end, part) for the split-K grid: each part cut into
    equal _BK-aligned chunks so that about _TARGET_CTAS CTAs run."""
    total_k = sum(k for k in k_parts)
    want = max(1, min(_MAX_SPLITS, math.ceil(_TARGET_CTAS / n_blocks)))
    ranges, begin = [], 0
    for part, k in enumerate(k_parts):
        share = max(1, round(want * k / total_k))
        chunk = -(-max(1, -(-k // share)) // _BK) * _BK
        for b in range(0, k, chunk):
            ranges.append((begin + b, begin + min(b + chunk, k), part))
        begin += k
    if len(ranges) > _MAX_SPLITS:
        raise ValueError(f"{len(ranges)} K splits exceed the kernel's {_MAX_SPLITS}")
    return ranges


def _stream_launch(x_a, x_b, w, s_a, s_b, n_split, k_parts, out_dtype):
    """One K6/K7 launch: ``x_a`` [m, K] bf16 is the activation of column
    blocks below ``n_split`` and ``x_b`` of the rest (K6 dual); the K rows
    of part 1 (K7's Wb) take ``s_b`` instead of ``s_a``."""
    m, k = x_a.shape
    n = w.shape[1]
    ld = _check_weight(w, (torch.int8, torch.bfloat16))
    if k % _BK or n % 16 or n_split % _STREAM_BN or any(p % _BK for p in k_parts):
        raise ValueError(f"K {k} (parts {k_parts}) must be multiples of {_BK}, N {n} of 16 and "
                         f"n_split {n_split} of {_STREAM_BN}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"output dtype {out_dtype} not supported")
    ranges = _splits(k_parts, -(-n // _STREAM_BN))
    out = torch.empty((m, n), dtype=out_dtype, device=x_a.device)
    part = torch.empty((len(ranges), m, n), dtype=torch.float32, device=x_a.device)
    table = (ctypes.c_int * (3 * len(ranges)))(*(v for r in ranges for v in r))
    err = _lib().w8_stream(
        x_a.data_ptr(), x_b.data_ptr(), w.data_ptr(), s_a.data_ptr(), s_b.data_ptr(),
        part.data_ptr(), out.data_ptr(), m, k, n, ld, n_split, int(w.dtype == torch.int8),
        _OUT_KINDS[out_dtype], len(ranges), table, torch.cuda.current_stream(x_a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"w8_stream launch failed with CUDA error {err}")
    return out


def _bf16_rows(x, device):
    _check_cuda("x", x, device)
    return x.to(torch.bfloat16).contiguous()


def w8_stream(x2d, w, scale, out_dtype, x2=None, n_split=None):
    """K6 wrapper: ``bf16(x) @ bf16(w) * scale`` for m <= 128 rows; with
    ``x2`` (the dual input), columns at and past ``n_split`` read x2."""
    if x2d.device.type == "cpu":
        return w8_stream_reference(x2d, w, scale, out_dtype, x2=x2, n_split=n_split)
    m, k = x2d.shape
    if m > M_DECODE_MAX:
        raise ValueError(f"K6 streams at most {M_DECODE_MAX} rows, got {m}")
    _check_cuda("w", w, x2d.device)
    xa = _bf16_rows(x2d, x2d.device)
    xb = xa if x2 is None else _bf16_rows(x2, x2d.device)
    if xb.shape != xa.shape:
        raise ValueError(f"x2 {tuple(xb.shape)} does not match x {tuple(xa.shape)}")
    n = w.shape[1]
    sc = _scale_row(scale, n).contiguous()
    _check_cuda("scale", sc, x2d.device)
    out = _stream_launch(xa, xb, w, sc, sc, n if x2 is None else n_split, (k,), out_dtype)
    w8_stream.launches += 1
    return out


w8_stream.launches = 0


def w8_splitk(xa, xb, w, sa, sb, out_dtype):
    """K7 wrapper: ``xa @ Wa * sa + xb @ Wb * sb`` with ``w = [Wa; Wb]``."""
    if xa.device.type == "cpu":
        return w8_splitk_reference(xa, xb, w, sa, sb, out_dtype)
    m, ka = xa.shape
    if m > M_DECODE_MAX or xb.shape[0] != m:
        raise ValueError(f"K7 streams at most {M_DECODE_MAX} rows, got {m} / {xb.shape[0]}")
    _check_cuda("w", w, xa.device)
    x_cat = torch.cat([_bf16_rows(xa, xa.device), _bf16_rows(xb, xa.device)], dim=1)
    n = w.shape[1]
    s_a, s_b = _scale_row(sa, n).contiguous(), _scale_row(sb, n).contiguous()
    out = _stream_launch(x_cat, x_cat, w, s_a, s_b, n, (ka, w.shape[0] - ka), out_dtype)
    w8_splitk.launches += 1
    return out


w8_splitk.launches = 0


def int8_matmul(x, qw: QuantizedWeight, bias: Optional[torch.Tensor] = None, activation: str = "none",
                out_dtype=torch.bfloat16):
    """K9 wrapper: activation(dequant(int8dot(rowquant(x), wq)) + bias) -> [..., N].

    On CUDA one row-quantisation pre-pass then the int8 tensor-core GEMM:
    two launches, counted as one call in ``int8_matmul.launches``."""
    k, n = qw.wq.shape
    batch_shape = x.shape[:-1]
    x2d = _rows(x, k)
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x2d.device.type == "cpu":
        return int8_matmul_reference(x2d, qw.wq, qw.scale, bias, activation, out_dtype).reshape(*batch_shape, n)
    device = x2d.device
    _check_cuda("wq", qw.wq, device)
    ld = _check_weight(qw.wq, (torch.int8,))
    if k % 64 or n % 16:
        raise ValueError(f"K9 needs K % 64 == 0 and N % 16 == 0, got K {k}, N {n}")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"output dtype {out_dtype} not supported")
    m = x2d.shape[0]
    xin = x2d.contiguous()
    if xin.dtype not in _OUT_KINDS:
        raise TypeError(f"x dtype {xin.dtype} not supported")
    sc = _scale_row(qw.scale, n).contiguous()
    b = None if bias is None else bias.float().reshape(n).contiguous()
    xq = torch.empty((m, k), dtype=torch.int8, device=device)
    row_scale = torch.empty((m,), dtype=torch.float32, device=device)
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _lib()
    if m:
        err = lib.int8_rowquant(xin.data_ptr(), xq.data_ptr(), row_scale.data_ptr(), m, k,
                                _OUT_KINDS[xin.dtype], stream)
        if err != 0:
            raise RuntimeError(f"int8_rowquant launch failed with CUDA error {err}")
        err = lib.int8_gemm(xq.data_ptr(), qw.wq.data_ptr(), row_scale.data_ptr(), sc.data_ptr(),
                            None if b is None else b.data_ptr(), out.data_ptr(), m, k, n, ld,
                            _ACTIVATIONS[activation], _OUT_KINDS[out_dtype], stream)
        if err != 0:
            raise RuntimeError(f"int8_gemm launch failed with CUDA error {err}")
        int8_matmul.launches += 1
    return out.reshape(*batch_shape, n)


int8_matmul.launches = 0


_RES_LN_WIDTHS = (128, 256, 384, 512, 768, 1024)  # output widths of K10's instances


def res_ln_layout(qw: QuantizedWeight) -> QuantizedWeight:
    """The [K, N] int8 weight in the [N, K] layout that K10 reads (its B
    fragments load with ldmatrix along K); made once, when a model is
    quantized or loaded, never per call."""
    return QuantizedWeight(qw.wq.t().contiguous(), qw.scale)


def int8_matmul_residual_ln(h, x, qw_nk: QuantizedWeight, bias, ln_scale, ln_bias, eps: float = 1e-12):
    """K10 wrapper: LayerNorm(x + dequant(int8dot(rowquant(h), wq)) + bias)
    -> [..., N] in x's dtype; h [..., K], x [..., N], ``qw_nk.wq`` [N, K]
    (``res_ln_layout``), ``qw_nk.scale`` [1, N].

    On CUDA K9's row-quantisation pre-pass and the K10 kernel: counted as
    one call in ``int8_matmul_residual_ln.launches``. CPU tensors take
    ``int8_res_ln_reference``."""
    n, k = qw_nk.wq.shape
    batch_shape = x.shape[:-1]
    if h.shape[:-1] != batch_shape or x.shape[-1] != n or h.shape[-1] != k:
        raise ValueError(f"h {tuple(h.shape)} / x {tuple(x.shape)} do not match the [N, K] weight "
                         f"{tuple(qw_nk.wq.shape)}")
    h2d, x2d = _rows(h, k), x.reshape(-1, n)
    if h2d.device.type == "cpu":
        out = int8_res_ln_reference(h2d, x2d, qw_nk.wq, qw_nk.scale, bias, ln_scale, ln_bias, eps)
        return out.reshape(*batch_shape, n)
    device = h2d.device
    if n not in _RES_LN_WIDTHS or k % 64:
        raise ValueError(f"K10 holds whole rows of N in {_RES_LN_WIDTHS} columns and takes K % 64 == 0, "
                         f"got h [{h2d.shape[0]}, {k}] x wq [{n}, {k}]")
    if qw_nk.wq.dtype != torch.int8 or not qw_nk.wq.is_contiguous():
        raise TypeError(f"K10 takes a contiguous int8 [N, K] weight, got {qw_nk.wq.dtype} with strides "
                        f"{qw_nk.wq.stride()}")
    for name, t in (("x", x2d), ("wq", qw_nk.wq), ("scale", qw_nk.scale), ("bias", bias), ("ln_scale", ln_scale),
                    ("ln_bias", ln_bias)):
        _check_cuda(name, t, device)
    hin, xin = h2d.contiguous(), x2d.contiguous()
    if hin.dtype not in _OUT_KINDS or xin.dtype not in _OUT_KINDS:
        raise TypeError(f"h / x dtypes {hin.dtype} / {xin.dtype} not supported")
    m = hin.shape[0]
    out = torch.empty((m, n), dtype=xin.dtype, device=device)
    if m == 0:
        return out.reshape(*batch_shape, n)
    rows = [_scale_row(t, n).reshape(n).contiguous() for t in (qw_nk.scale, bias, ln_scale, ln_bias)]
    hq = torch.empty((m, k), dtype=torch.int8, device=device)
    row_scale = torch.empty((m,), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _lib()
    err = lib.int8_rowquant(hin.data_ptr(), hq.data_ptr(), row_scale.data_ptr(), m, k, _OUT_KINDS[hin.dtype], stream)
    if err != 0:
        raise RuntimeError(f"int8_rowquant launch failed with CUDA error {err}")
    sc, b, g, beta = rows
    err = lib.int8_res_ln(hq.data_ptr(), row_scale.data_ptr(), qw_nk.wq.data_ptr(), sc.data_ptr(), b.data_ptr(),
                          xin.data_ptr(), g.data_ptr(), beta.data_ptr(), out.data_ptr(), m, k, n,
                          _OUT_KINDS[xin.dtype], float(eps), stream)
    if err != 0:
        raise RuntimeError(f"int8_res_ln launch failed with CUDA error {err}")
    int8_matmul_residual_ln.launches += 1
    return out.reshape(*batch_shape, n)


int8_matmul_residual_ln.launches = 0


def _int4_splits(k2: int, n_blocks: int):
    """Packed-row ranges for K8's split-K grid: about _TARGET_CTAS CTAs,
    each range a multiple of 128 rows (one scale group) where K/2 allows,
    else of 64 (the kernel's stage)."""
    unit = 128 if k2 % 128 == 0 else 64
    want = max(1, min(_MAX_SPLITS, math.ceil(_TARGET_CTAS / n_blocks), k2 // unit))
    chunk = -(-k2 // want // unit) * unit
    return [(b, min(b + chunk, k2)) for b in range(0, k2, chunk)]


def int4_decode_matmul(x, qw: QuantizedWeight4, out_dtype=torch.bfloat16):
    """K8 wrapper: x @ dequant(int4 weight) -> [..., N] at every row count.

    On CUDA one row-quantisation pre-pass (K9's) then the int4 GEMM (and,
    with split K, a split sum): counted as one call in
    ``int4_decode_matmul.launches``. CPU tensors take ``int4_matmul_reference``."""
    k2, n = qw.packed.shape
    k = 2 * k2
    batch_shape = x.shape[:-1]
    x2d = _rows(x, k)
    if x2d.device.type == "cpu":
        return int4_matmul_reference(x2d, qw.packed, qw.scale, out_dtype).reshape(*batch_shape, n)
    device = x2d.device
    _check_cuda("packed", qw.packed, device)
    _check_cuda("scale", qw.scale, device)
    ld = _check_weight(qw.packed, (torch.uint8,))
    if k % INT4_GROUP or n % 16 or qw.scale.shape != (k // INT4_GROUP, n) or qw.scale.dtype != torch.float32:
        raise ValueError(f"K8 needs K % {INT4_GROUP} == 0, N % 16 == 0 and f32 scales [K/{INT4_GROUP}, N], "
                         f"got packed {tuple(qw.packed.shape)}, scale {tuple(qw.scale.shape)} {qw.scale.dtype}")
    if qw.scale.stride(1) != 1:
        raise ValueError(f"scale strides {qw.scale.stride()} must have a unit column stride")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"output dtype {out_dtype} not supported")
    xin = x2d.contiguous()
    if xin.dtype not in _OUT_KINDS:
        raise TypeError(f"x dtype {xin.dtype} not supported")
    m = xin.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=device)
    if m == 0:
        return out.reshape(*batch_shape, n)
    chunk_rows = 16 if m <= 16 else 32 if m <= 32 else 64
    ranges = _int4_splits(k2, -(-n // _STREAM_BN) * -(-m // chunk_rows))
    xq = torch.empty((m, k), dtype=torch.int8, device=device)
    row_scale = torch.empty((m,), dtype=torch.float32, device=device)
    part = torch.empty((len(ranges), m, n), dtype=torch.float32, device=device) if len(ranges) > 1 else None
    table = (ctypes.c_int * (2 * len(ranges)))(*(v for r in ranges for v in r))
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _lib()
    err = lib.int8_rowquant(xin.data_ptr(), xq.data_ptr(), row_scale.data_ptr(), m, k, _OUT_KINDS[xin.dtype], stream)
    if err != 0:
        raise RuntimeError(f"int8_rowquant launch failed with CUDA error {err}")
    err = lib.int4_gemm(xq.data_ptr(), row_scale.data_ptr(), qw.packed.data_ptr(), qw.scale.data_ptr(),
                        None if part is None else part.data_ptr(), out.data_ptr(), m, k, n, ld,
                        qw.scale.stride(0), _OUT_KINDS[out_dtype], len(ranges), table, stream)
    if err != 0:
        raise RuntimeError(f"int4_gemm launch failed with CUDA error {err}")
    int4_decode_matmul.launches += 1
    return out.reshape(*batch_shape, n)


int4_decode_matmul.launches = 0


# --------------------------------------------------------------------------
# routing and the parameter-store helpers
# --------------------------------------------------------------------------
def int8_decode_matmul(x, qw: QuantizedWeight, out_dtype=torch.bfloat16):
    """x @ dequant(wq), routed by row count: m <= 128 streams the weight
    (K6), larger m runs K9 for int8 weights and a plain matmul for bf16."""
    k, n = qw.wq.shape
    batch_shape = x.shape[:-1]
    x2d = _rows(x, k)
    m = x2d.shape[0]
    if m <= M_DECODE_MAX:
        out = w8_stream(x2d, qw.wq, qw.scale, out_dtype)
    elif qw.wq.dtype != torch.int8:
        # bf16 2-D weights at prefill/scoring sizes: a plain matmul with f32
        # sums, as the JAX package leaves to XLA
        out = (matmul_f32(x2d.to(qw.wq.dtype), qw.wq) * _scale_row(qw.scale, n)).to(out_dtype)
    else:
        out = int8_matmul(x2d, qw, out_dtype=out_dtype)
    return out.reshape(*batch_shape, n)


def has_q8(store, name: str) -> bool:
    """True when ``store`` holds ``name`` quantized (int8 / bf16 ``<name>@q8``
    or int4 ``<name>@q4``)."""
    return store is not None and (f"{name}@q8" in store or f"{name}@q4" in store)


def q8_dot(store, name: str, x, out_dtype=None):
    """x @ dequant(store[name]) (int8, bf16 or int4 scheme)."""
    if f"{name}@q4" in store:
        qw4 = QuantizedWeight4(store[f"{name}@q4"], store[f"{name}@s4g"])
        return int4_decode_matmul(x, qw4, out_dtype=out_dtype or x.dtype)
    qw = QuantizedWeight(store[f"{name}@q8"], store[f"{name}@s"])
    return int8_decode_matmul(x, qw, out_dtype=out_dtype or x.dtype)


def q8_col_slice_dot(store, name: str, x, lo: int, hi: int, out_dtype=None):
    """x @ dequant(store[name][:, lo:hi]): one part of an N-concat weight."""
    qw = QuantizedWeight(store[f"{name}@q8"][:, lo:hi], store[f"{name}@s"][:, lo:hi])
    return int8_decode_matmul(x, qw, out_dtype=out_dtype or x.dtype)


def q8_row_part_dot(store, name: str, x, part: str, out_dtype=None):
    """x @ dequant(Wa or Wb) of a K-concat weight ``[Wa; Wb]``: ``part="a"``
    takes the first x.shape[-1] rows, ``"b"`` the last."""
    wq = store[f"{name}@q8"]
    kx = x.shape[-1]
    if part == "a":
        qw = QuantizedWeight(wq[:kx], store[f"{name}@sa"])
    else:
        qw = QuantizedWeight(wq[wq.shape[0] - kx:], store[f"{name}@sb"])
    return int8_decode_matmul(x, qw, out_dtype=out_dtype or x.dtype)


def q8_dual_in_dot(store, name: str, x1, x2, n_split: int, out_dtype=None):
    """(x1 @ W[:, :n_split], x2 @ W[:, n_split:]) of an N-concat weight.

    At m <= 128 one K6 launch streams W once, its column blocks below
    n_split reading x1 and the rest x2 (no stacked rows and no cross terms,
    which the TPU's resident block needed). Larger m: two column-slice dots."""
    wq, sc = store[f"{name}@q8"], store[f"{name}@s"]
    k, n = wq.shape
    if x1.shape != x2.shape or x1.shape[-1] != k:
        raise ValueError(f"inputs {tuple(x1.shape)} / {tuple(x2.shape)} do not match weight {tuple(wq.shape)}")
    batch_shape = x1.shape[:-1]
    dt = out_dtype or x1.dtype
    m = x1.reshape(-1, k).shape[0]
    if m <= M_DECODE_MAX:
        out = w8_stream(x1.reshape(m, k), wq, sc, dt, x2=x2.reshape(m, k), n_split=n_split)
        return (out[:, :n_split].reshape(*batch_shape, n_split),
                out[:, n_split:].reshape(*batch_shape, n - n_split))
    return (q8_col_slice_dot(store, name, x1, 0, n_split, out_dtype=dt),
            q8_col_slice_dot(store, name, x2, n_split, n, out_dtype=dt))


def q8_splitk_dot(store, name: str, xa, xb, out_dtype=None):
    """xa @ dequant(Wa) + xb @ dequant(Wb) with ``[Wa; Wb]`` streamed once
    (K7) at m <= 128; larger m: two row-part dots summed in f32."""
    wq, sa, sb = store[f"{name}@q8"], store[f"{name}@sa"], store[f"{name}@sb"]
    k, n = wq.shape
    ka = xa.shape[-1]
    batch_shape = xa.shape[:-1]
    if xb.shape[:-1] != batch_shape or ka + xb.shape[-1] != k:
        raise ValueError(f"inputs {tuple(xa.shape)} / {tuple(xb.shape)} do not match weight {tuple(wq.shape)}")
    dt = out_dtype or xa.dtype
    m = xa.reshape(-1, ka).shape[0]
    if m <= M_DECODE_MAX:
        out = w8_splitk(xa.reshape(m, ka), xb.reshape(m, k - ka), wq, sa, sb, dt)
        return out.reshape(*batch_shape, n)
    ya = int8_decode_matmul(xa, QuantizedWeight(wq[:ka], sa), out_dtype=dt)
    yb = int8_decode_matmul(xb, QuantizedWeight(wq[ka:], sb), out_dtype=dt)
    return (ya.float() + yb.float()).to(dt)
