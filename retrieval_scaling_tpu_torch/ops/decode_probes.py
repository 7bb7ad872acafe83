"""The decode probes: hand-written Hopper kernels S1, S2 and S5 and their
plain versions.

Ports the Pallas kernels of three measurement scripts of the JAX package,
which split a Pythia-1B decode step (D 2048, FF 8192, qkv 6144, vocab 50304,
16 layers, 8 rows) into its weight streams and its launches:

* ``weight_stream`` (``csrc/decode_probes.cu``): ``out[l] = act(x) @ W[l] *
  s[l]`` over L >= 1 stacked weights, the layer axis in the grid. Its modes
  are the S1 variants of ``scripts/ablate_decode.py``: ``"cur"``
  (``stream_cur`` :147, x quantised inside the kernel once per column
  block, as ``kern_cur`` does), ``"preq"`` (``stream_preq`` :162, x
  quantised once per matmul by ``rowquant_xla``), ``"w8bf16"``
  (``stream_w8bf16`` :213, int8 W widened to bf16, K6's function) and
  ``"bf16"`` (``stream_bf16`` :287); and S2 of
  ``scripts/ablate_launch_overhead.py``: ``stream_one`` (:57) is 16
  ``"w8bf16"`` launches with L = 1, ``one16`` (:84) one launch with L = 16.
* ``dual_stream``: ``res + a @ Wo + h @ W2`` in one pass over both weights,
  int8 with the row and column scales (``stream_dual`` :178) or bf16
  (``stream_dual_bf16`` :301).
* ``tiny_copy``: S5, the near-empty launch of ``scripts/profile_decode_gap.py``
  (``launch_loop`` :144), a [8, 128] f32 copy.
* S1's ``stream_touch`` (:233) is K13 (``ops.stream_probe``), launched once
  per weight buffer by ``touch_step``: on the TPU the BlockSpec DMAs the
  whole [K, bn] block whatever the kernel body reads, so copying 8 rows of
  it measured the stream; a CUDA kernel reads only what it loads, so the
  port's probe has to read every byte, which is what K13 does.

``rowquant_xla`` is the plain torch counterpart of the script's XLA row
quantisation (``ablate_decode.py:104-109``) as XLA computes it inside the
script's jit: scale = max(|x|) * f32(1 / 127) (XLA rewrites the division by
the constant) clamped at 1e-30, then ``round(x / scale)`` clipped to +-127.
It is not ``ops.quant_matmul._rowquant`` (127 / absmax, clamped at 1e-12).

Each wrapper takes its plain version only for a CPU tensor and launches its
kernel for a CUDA tensor or raises; ``.launches`` counts kernel launches
and ``.cuda_calls`` on a plain version its calls on CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from retrieval_scaling_tpu_torch.ops import stream_probe as sp

MODES = {"cur": 0, "preq": 1, "w8bf16": 2, "bf16": 3}
_ROWS = 8     # the kernels' resident activation rows (the decode batch)
_BK, _BN = 128, 32
_RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()  # f32(1/127), as XLA folds it


def rowquant_xla(x: torch.Tensor):
    """(int8 [M, K], f32 row scales [M]): ``rowquant_xla`` of
    ``scripts/ablate_decode.py`` under XLA's jit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax * torch.full_like(amax, _RECIP_127), min=1e-30)
    xq = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return xq, scale


def _layers(w: torch.Tensor) -> torch.Tensor:
    return w if w.dim() == 3 else w[None]


def _scales(s, n_layers: int, n: int):
    return None if s is None else s.float().reshape(n_layers, n)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def _exact_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] . int8 [L, K, N] -> f32 [L, M, N], the int32 sums exactly
    (float64 holds them at every K the probes use)."""
    return torch.matmul(xq.double()[None], wq.double()).float()


def weight_stream_reference(x, w, scale, mode: str, xs=None, out_dtype=torch.bfloat16):
    """``weight_stream``'s plain version: [L, M, N] (or [M, N] for a 2-D w)."""
    if x.is_cuda:
        weight_stream_reference.cuda_calls += 1
    if mode not in MODES:
        raise ValueError(f"unknown weight_stream mode {mode!r}")
    wl = _layers(w)
    n_layers, _, n = wl.shape
    sc = _scales(scale, n_layers, n)
    if mode in ("cur", "preq"):
        if mode == "cur":
            x, xs = rowquant_xla(x.to(torch.bfloat16))
        y = _exact_dot(x, wl) * xs.float()[None, :, None] * sc[:, None, :]
    else:
        y = torch.matmul(x.to(torch.bfloat16).float()[None], wl.to(torch.bfloat16).float())
        if sc is not None:
            y = y * sc[:, None, :]
    y = y.to(out_dtype)
    return y if w.dim() == 3 else y[0]


weight_stream_reference.cuda_calls = 0


def dual_stream_reference(a, h, res, wo, w2, so=None, s2=None, a_scale=None, h_scale=None,
                          out_dtype=torch.bfloat16):
    """``dual_stream``'s plain version: int8 a / h (with their row scales and
    the weights' column scales) or bf16, in the kernel's order of sums."""
    if a.is_cuda:
        dual_stream_reference.cuda_calls += 1
    n = wo.shape[1]
    if a.dtype == torch.int8:
        y_o = _exact_dot(a, wo[None])[0] * a_scale.float()[:, None] * so.float().reshape(1, n)
        y_2 = _exact_dot(h, w2[None])[0] * h_scale.float()[:, None] * s2.float().reshape(1, n)
    else:
        y_o = a.to(torch.bfloat16).float() @ wo.float()
        y_2 = h.to(torch.bfloat16).float() @ w2.float()
    return (res.float() + y_o + y_2).to(out_dtype)


dual_stream_reference.cuda_calls = 0


def tiny_copy_reference(src: torch.Tensor) -> torch.Tensor:
    """``tiny_copy``'s plain version."""
    if src.is_cuda:
        tiny_copy_reference.cuda_calls += 1
    return src.clone()


tiny_copy_reference.cuda_calls = 0


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------
def _lib():
    from retrieval_scaling_tpu_torch.ops._build import load_library

    lib = load_library("decode_probes")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.weight_stream.restype = i
        lib.weight_stream.argtypes = [i] + [p] * 5 + [i] * 5 + [p]
        lib.dual_stream.restype = i
        lib.dual_stream.argtypes = [i] + [p] * 10 + [i] * 5 + [p]
        lib.tiny_copy.restype = i
        lib.tiny_copy.argtypes = [p, p, i, p]
        lib._bound = True
    return lib


def _on(device, **tensors):
    for name, t in tensors.items():
        if t is not None and (not t.is_cuda or t.device != device):
            raise ValueError(f"{name} must be on {device}")


def _check_shape(m: int, k: int, n: int) -> None:
    if not 1 <= m <= _ROWS or k % _BK or n % _BN:
        raise ValueError(f"the probes take 1..{_ROWS} rows, K % {_BK} == 0 and N % {_BN} == 0; "
                         f"got M {m}, K {k}, N {n}")


def _out_kind(out_dtype) -> int:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"output dtype {out_dtype} not supported (bf16 or f32)")
    return int(out_dtype == torch.float32)


def weight_stream(x, w, scale, mode: str, xs=None, out_dtype=torch.bfloat16):
    """S1 / S2 wrapper: ``act(x) @ W[l] * s[l]`` for each of the L stacked
    weights ``w`` [L, K, N] (or one [K, N]) with scales [L, N] (None in mode
    "bf16"); [L, M, N] (or [M, N]). ``mode`` "preq" takes x quantised
    (``rowquant_xla``) with its row scales ``xs``; the others take x in
    bf16 (converted). One launch; CPU tensors take the plain version."""
    if mode not in MODES:
        raise ValueError(f"unknown weight_stream mode {mode!r}")
    if mode == "preq" and (x.dtype != torch.int8 or xs is None):
        raise TypeError("mode 'preq' takes int8 x and its row scales xs (rowquant_xla)")
    if scale is None and mode != "bf16":
        raise ValueError(f"mode {mode!r} needs column scales")
    if x.device.type == "cpu":
        return weight_stream_reference(x, w, scale, mode, xs, out_dtype)
    wl = _layers(w)
    n_layers, k, n = wl.shape
    m = x.shape[0]
    _check_shape(m, k, n)
    if x.shape != (m, k):
        raise ValueError(f"x {tuple(x.shape)} does not match W [{k}, {n}]")
    want_w = torch.bfloat16 if mode == "bf16" else torch.int8
    if wl.dtype != want_w or not wl.is_contiguous():
        raise TypeError(f"mode {mode!r} takes a contiguous {want_w} weight, got {wl.dtype}")
    if mode == "preq":
        xin, xs_in = x.contiguous(), xs.float().reshape(m).contiguous()
    else:
        xin, xs_in = x.to(torch.bfloat16).contiguous(), None
    sc = _scales(scale, n_layers, n)
    sc = None if sc is None else sc.contiguous()
    _on(x.device, w=wl, scale=sc, xs=xs_in)
    out = torch.empty((n_layers, m, n), dtype=out_dtype, device=x.device)
    err = _lib().weight_stream(
        MODES[mode], xin.data_ptr(), None if xs_in is None else xs_in.data_ptr(), wl.data_ptr(),
        None if sc is None else sc.data_ptr(), out.data_ptr(), m, k, n, n_layers, _out_kind(out_dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"weight_stream launch failed with CUDA error {err}")
    weight_stream.launches += 1
    return out if w.dim() == 3 else out[0]


weight_stream.launches = 0


def dual_stream(a, h, res, wo, w2, so=None, s2=None, a_scale=None, h_scale=None, out_dtype=torch.bfloat16):
    """S1-dual wrapper: ``res + a @ Wo * a_scale * so + h @ W2 * h_scale * s2``
    with int8 a / h (``rowquant_xla``) and int8 weights, or ``res + a @ Wo +
    h @ W2`` with bf16 ones; [M, N] in one launch."""
    if a.device.type == "cpu":
        return dual_stream_reference(a, h, res, wo, w2, so, s2, a_scale, h_scale, out_dtype)
    m, ka = a.shape
    kh, n = w2.shape
    _check_shape(m, ka, n)
    _check_shape(m, kh, n)
    if h.shape != (m, kh) or wo.shape != (ka, n) or res.shape != (m, n):
        raise ValueError(f"a {tuple(a.shape)}, h {tuple(h.shape)}, res {tuple(res.shape)}, Wo {tuple(wo.shape)}, "
                         f"W2 {tuple(w2.shape)} do not match")
    int8 = a.dtype == torch.int8
    want = torch.int8 if int8 else torch.bfloat16
    for name, t in (("h", h), ("wo", wo), ("w2", w2)):
        if t.dtype != want or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {want} tensor like a, got {t.dtype}")
    if int8 and any(t is None for t in (so, s2, a_scale, h_scale)):
        raise ValueError("the int8 dual stream needs so, s2, a_scale and h_scale")
    vecs = [None if t is None else t.float().reshape(-1).contiguous() for t in (a_scale, h_scale, so, s2)]
    res_in = res.to(torch.bfloat16).contiguous()
    _on(a.device, h=h, wo=wo, w2=w2, res=res_in, **{f"scale{i}": t for i, t in enumerate(vecs)})
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    ptr = [None if t is None else t.data_ptr() for t in vecs]
    err = _lib().dual_stream(
        MODES["preq" if int8 else "bf16"], a.contiguous().data_ptr(), ptr[0], h.data_ptr(), ptr[1],
        res_in.data_ptr(), wo.data_ptr(), ptr[2], w2.data_ptr(), ptr[3], out.data_ptr(), m, ka, kh, n,
        _out_kind(out_dtype), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dual_stream launch failed with CUDA error {err}")
    dual_stream.launches += 1
    return out


dual_stream.launches = 0


def tiny_copy(src: torch.Tensor, dst: torch.Tensor | None = None) -> torch.Tensor:
    """S5 wrapper: a copy of the f32 tensor ``src`` (into ``dst``) by one
    CTA, the least work a launch can carry."""
    if src.device.type == "cpu":
        out = tiny_copy_reference(src)
        return out if dst is None else dst.copy_(out)
    if src.dtype != torch.float32 or not src.is_contiguous():
        raise TypeError("tiny_copy takes a contiguous f32 tensor")
    dst = torch.empty_like(src) if dst is None else dst
    _on(src.device, dst=dst)
    err = _lib().tiny_copy(src.data_ptr(), dst.data_ptr(), src.numel(),
                           torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiny_copy launch failed with CUDA error {err}")
    tiny_copy.launches += 1
    return dst


tiny_copy.launches = 0


def touch_probes(buffers):
    """S1-touch: one prepared K13 launch per weight buffer (the script's
    ``step_dma`` touches each of its 65 buffers with its own launch)."""
    return [sp._Probe([b]) for b in buffers]


def touch_step(probes) -> None:
    """Launch every prepared K13 probe once (counted on ``stream_probe``)."""
    for probe in probes:
        probe.launch()
