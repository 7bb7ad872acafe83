"""Port parity: the int8 / bf16 decode matmuls (retrieval_scaling_tpu_torch.ops.quant_matmul).

The plain versions of K6, K7 and K9 are held to the JAX package's Pallas
kernels in interpret mode on the same numpy inputs; the CUDA kernels run
only on the card (``cuda`` marker). Tolerances:
  * K9: rows quantise identically and the int8 dot is exact, so the f32
    result agrees to 1e-6 of max |y| (the activations' erf / tanh aside);
  * K6 / K7: bf16 operands with f32 sums taken in another order, 1e-5 of
    max |y|;
  * K10: the int8 dot is exact, the LayerNorm's f32 sums run in another
    order: 1e-5 of max |y| in f32, one ulp in bf16 on the CPU; on the card
    1e-4 of max |y| (f32) or one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_scaling_tpu.ops import quant_matmul as jqm
from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)


def _weights(rng, k, n):
    return (0.05 * rng.randn(k, n)).astype(np.float32)


def _close(out, ref, rel):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max(), np.abs(out - ref).max() / np.abs(ref).max()


def test_quantize_weight_matches_jax_bit_for_bit():
    w = _weights(np.random.RandomState(0), 256, 384)
    w[:, 5] = 0.0  # an all-zero column takes the 1e-12 floor
    jw = jqm.quantize_weight(jnp.asarray(w))
    pw = qm.quantize_weight(torch.from_numpy(w))
    assert np.array_equal(pw.wq.numpy(), np.asarray(jw.wq))
    np.testing.assert_array_max_ulp(pw.scale.numpy(), np.asarray(jw.scale), maxulp=1)


@pytest.mark.parametrize("activation", ["none", "gelu_tanh", "gelu_exact"])
def test_k9_plain_matches_jax_kernel(activation):
    rng = np.random.RandomState(1)
    x = rng.randn(256, 256).astype(np.float32)
    w, bias = _weights(rng, 256, 384), rng.randn(384).astype(np.float32)
    jw = jqm.quantize_weight(jnp.asarray(w))
    ref = jqm.int8_matmul(jnp.asarray(x), jw, jnp.asarray(bias), activation=activation, impl="pallas",
                          interpret=True, out_dtype=jnp.float32)
    pw = qm.QuantizedWeight(torch.from_numpy(np.array(jw.wq)), torch.from_numpy(np.array(jw.scale)))
    out = qm.int8_matmul(torch.from_numpy(x), pw, torch.from_numpy(bias), activation=activation,
                         out_dtype=torch.float32)
    _close(out.numpy(), ref, 1e-6)


def _store(rng, k, n, scheme):
    w = _weights(rng, k, n)
    if scheme == "bf16":
        return {"W@q8": jnp.asarray(w, jnp.bfloat16), "W@s": jnp.ones((1, n), jnp.float32)}
    jw = jqm.quantize_weight(jnp.asarray(w))
    return {"W@q8": jw.wq, "W@s": jw.scale}


def _port_store(store):
    out = {}
    for key, val in store.items():
        a = np.asarray(val)
        out[key] = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) if a.dtype.name == "bfloat16"
                    else torch.from_numpy(np.array(a)))
    return out


@pytest.mark.parametrize("scheme", ["int8", "bf16"])
def test_k6_plain_matches_jax_kernel(scheme):
    rng = np.random.RandomState(2)
    store = _store(rng, 256, 384, scheme)
    x = rng.randn(8, 256).astype(np.float32)
    qw = jqm.QuantizedWeight(store["W@q8"], store["W@s"])
    ref = jqm.int8_decode_matmul(jnp.asarray(x), qw, impl="pallas", interpret=True, out_dtype=jnp.float32)
    out = qm.q8_dot(_port_store(store), "W", torch.from_numpy(x), out_dtype=torch.float32)
    _close(out.numpy(), ref, 1e-5)


def test_k6_dual_input_matches_jax_kernel():
    rng = np.random.RandomState(3)
    store = _store(rng, 128, 512, "int8")
    x1, x2 = rng.randn(2, 3, 128).astype(np.float32), rng.randn(2, 3, 128).astype(np.float32)
    ref = jqm.q8_dual_in_dot(store, "W", jnp.asarray(x1), jnp.asarray(x2), 384, interpret=True)
    out = qm.q8_dual_in_dot(_port_store(store), "W", torch.from_numpy(x1), torch.from_numpy(x2), 384)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        _close(o.numpy(), r, 1e-5)


@pytest.mark.parametrize("scheme", ["int8", "bf16"])
def test_k7_plain_matches_jax_kernel(scheme):
    rng = np.random.RandomState(4)
    a, b = _store(rng, 128, 256, scheme), _store(rng, 384, 256, scheme)
    store = {"W@q8": jnp.concatenate([a["W@q8"], b["W@q8"]]), "W@sa": a["W@s"], "W@sb": b["W@s"]}
    xa, xb = rng.randn(1, 5, 128).astype(np.float32), rng.randn(1, 5, 384).astype(np.float32)
    ref = jqm.q8_splitk_dot(store, "W", jnp.asarray(xa), jnp.asarray(xb), interpret=True)
    out = qm.q8_splitk_dot(_port_store(store), "W", torch.from_numpy(xa), torch.from_numpy(xb))
    _close(out.numpy(), ref, 1e-5)


def test_rows_above_128_route_to_k9_or_a_plain_matmul():
    """m > 128: int8 weights row-quantise (K9, as JAX's CPU route does) and
    bf16 weights take a plain f32-summed matmul; m <= 128 never row-quantises."""
    rng = np.random.RandomState(5)
    x = rng.randn(200, 128).astype(np.float32)
    for scheme in ("int8", "bf16"):
        store = _store(rng, 128, 256, scheme)
        ref = jqm.q8_dot(store, "W", jnp.asarray(x), out_dtype=jnp.float32)
        out = qm.q8_dot(_port_store(store), "W", torch.from_numpy(x), out_dtype=torch.float32)
        _close(out.numpy(), ref, 1e-5)
    store = _port_store(_store(rng, 128, 256, "int8"))
    small = qm.q8_dot(store, "W", torch.from_numpy(x[:8]), out_dtype=torch.float32)
    plain = qm.w8_stream_reference(torch.from_numpy(x[:8]), store["W@q8"], store["W@s"], torch.float32)
    assert torch.equal(small, plain)


@pytest.mark.parametrize("x_dtype", [np.float32, "bfloat16"])
def test_k10_plain_matches_jax_kernel(x_dtype):
    """int8_res_ln_reference against the JAX K10 (Pallas, interpret mode)
    on the same int8 weight: LayerNorm(x + dequant(rowquant(h) . wq) + bias)."""
    rng = np.random.RandomState(6)
    m, k, n = 256, 512, 128
    h = rng.randn(m, k).astype(np.float32)
    x = rng.randn(m, n).astype(np.float32)
    bias, g, beta = (rng.randn(n).astype(np.float32) for _ in range(3))
    jw = jqm.quantize_weight(jnp.asarray(_weights(rng, k, n)))
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)
    ref = jqm._int8_res_ln_jit(jnp.asarray(h), jx, jw, jnp.asarray(bias), jnp.asarray(g), jnp.asarray(beta),
                               eps=1e-12, impl="pallas", interpret=True)
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16 if x_dtype == "bfloat16" else
                                                                  torch.float32)
    pw = qm.res_ln_layout(qm.QuantizedWeight(torch.from_numpy(np.array(jw.wq)), torch.from_numpy(np.array(jw.scale))))
    out = qm.int8_matmul_residual_ln(torch.from_numpy(h), px, pw, torch.from_numpy(bias), torch.from_numpy(g),
                                     torch.from_numpy(beta))
    assert out.dtype == px.dtype
    ref_t = torch.from_numpy(np.asarray(ref.astype(jnp.float32))).to(px.dtype)
    if x_dtype == "bfloat16":
        assert _ulps(out, ref_t) <= 1
    else:
        _close(out.numpy(), np.asarray(ref), 1e-5)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6, K7 and K9 have no CPU or interpret mode")
    return torch.device("cuda")


def _ulps(out, ref):
    """Largest |out - ref| in units of ref's dtype spacing at |ref|."""
    spacing = torch.finfo(ref.dtype).eps * torch.maximum(ref.float().abs(), torch.tensor(1e-30, device=ref.device))
    return ((out.float() - ref.float()).abs() / spacing).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,activation,out_dtype", [
    (1024, 2048, 1024, "none", torch.float32), (200, 2048, 768, "none", torch.bfloat16),
    (300, 512, 3072, "gelu_tanh", torch.bfloat16), (130, 768, 512, "gelu_exact", torch.float32),
])
def test_k9_kernel_matches_plain_on_cuda(cuda_device, m, k, n, activation, out_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    qw = qm.quantize_weight(0.05 * torch.randn(k, n, generator=gen, device=cuda_device))
    bias = torch.randn(n, generator=gen, device=cuda_device)
    out = qm.int8_matmul(x, qw, bias, activation=activation, out_dtype=out_dtype)
    ref = qm.int8_matmul_reference(x, qw.wq, qw.scale, bias, activation, out_dtype)
    torch.cuda.synchronize()
    limit = 0 if activation == "none" and out_dtype == torch.float32 else 1
    assert _ulps(out, ref) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["qkv", "mlp_in", "ao", "mo"])
def test_k9_kernel_on_store_views_matches_plain_on_cuda(cuda_device, view):
    """K9 through the store helpers on strided views of the fused weights:
    column slices (row stride N, nonzero column offset) and row parts."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    m, d, nqkv, ff = 300, 256, 768, 1024
    mi = qm.quantize_weight(0.05 * torch.randn(d, nqkv + ff, generator=gen, device=cuda_device))
    wa, wb = (qm.quantize_weight(0.05 * torch.randn(k, d, generator=gen, device=cuda_device)) for k in (d, ff))
    ao_mo = torch.cat([wa.wq, wb.wq])
    store = {"qkv_mi@q8": mi.wq, "qkv_mi@s": mi.scale, "ao_mo@q8": ao_mo, "ao_mo@sa": wa.scale, "ao_mo@sb": wb.scale}
    x = torch.randn(m, ff if view == "mo" else d, generator=gen, device=cuda_device)
    out, wq, scale = {
        "qkv": lambda: (qm.q8_col_slice_dot(store, "qkv_mi", x, 0, nqkv), mi.wq[:, :nqkv], mi.scale[:, :nqkv]),
        "mlp_in": lambda: (qm.q8_col_slice_dot(store, "qkv_mi", x, nqkv, nqkv + ff), mi.wq[:, nqkv:],
                           mi.scale[:, nqkv:]),
        "ao": lambda: (qm.q8_row_part_dot(store, "ao_mo", x, "a"), ao_mo[:d], wa.scale),
        "mo": lambda: (qm.q8_row_part_dot(store, "ao_mo", x, "b"), ao_mo[d:], wb.scale),
    }[view]()
    ref = qm.int8_matmul_reference(x, wq, scale, None, "none", torch.float32)
    torch.cuda.synchronize()
    assert _ulps(out, ref) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64, 128])
@pytest.mark.parametrize("wdtype", [torch.int8, torch.bfloat16])
def test_k6_k7_kernels_match_plain_on_cuda(cuda_device, m, wdtype):
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    k, n, ka = 1024, 1536, 256

    def weight(rows):
        w = 0.05 * torch.randn(rows, n, generator=gen, device=cuda_device)
        return qm.quantize_weight(w) if wdtype == torch.int8 else qm.QuantizedWeight(
            w.to(torch.bfloat16), torch.ones(1, n, device=cuda_device))

    x, x2 = (torch.randn(m, k, generator=gen, device=cuda_device) for _ in range(2))
    qw = weight(k)
    y = qm.w8_stream(x, qw.wq, qw.scale, torch.float32)
    y_dual = qm.w8_stream(x, qw.wq, qw.scale, torch.float32, x2=x2, n_split=512)
    wa, wb = weight(ka), weight(k - ka)
    w_cat = torch.cat([wa.wq, wb.wq])
    y_k7 = qm.w8_splitk(x[:, :ka], x[:, ka:], w_cat, wa.scale, wb.scale, torch.float32)
    refs = (qm.w8_stream_reference(x, qw.wq, qw.scale, torch.float32),
            qm.w8_stream_reference(x, qw.wq, qw.scale, torch.float32, x2=x2, n_split=512),
            qm.w8_splitk_reference(x[:, :ka], x[:, ka:], w_cat, wa.scale, wb.scale, torch.float32))
    torch.cuda.synchronize()
    for out, ref in zip((y, y_dual, y_k7), refs):
        assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,x_dtype", [
    (4096, 3072, 768, torch.bfloat16), (1000, 3072, 768, torch.float32), (77, 1536, 384, torch.bfloat16),
    (300, 4096, 1024, torch.float32), (64, 512, 128, torch.float16),
])
def test_k10_kernel_matches_plain_on_cuda(cuda_device, m, k, n, x_dtype):
    """K10 against int8_res_ln_reference on the same inputs: 1e-4 of max |y|
    with f32 out; with 16-bit out, within one ulp of the 16-bit type of the
    plain version's f32 result, or 1e-5 of max |y| where the LayerNorm's
    + beta cancels (there f32 rounding alone exceeds an ulp); counted once."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    h = torch.randn(m, k, generator=gen, device=cuda_device).to(x_dtype)
    x = torch.randn(m, n, generator=gen, device=cuda_device).to(x_dtype)
    qw = qm.res_ln_layout(qm.quantize_weight(0.02 * torch.randn(k, n, generator=gen, device=cuda_device)))
    bias, g, beta = (torch.randn(n, generator=gen, device=cuda_device) for _ in range(3))
    before = qm.int8_matmul_residual_ln.launches
    out = qm.int8_matmul_residual_ln(h, x, qw, bias, g, beta, eps=1e-12)
    ref = qm.int8_res_ln_reference(h, x.float(), qw.wq, qw.scale, bias, g, beta, 1e-12)
    torch.cuda.synchronize()
    assert qm.int8_matmul_residual_ln.launches == before + 1
    assert out.dtype == x_dtype and out.shape == (m, n)
    top = ref.abs().max().item()
    if x_dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-4 * top
    else:
        limit = torch.finfo(x_dtype).eps * ref.abs() + 1e-5 * top
        assert ((out.float() - ref).abs() <= limit).all(), ((out.float() - ref).abs() / limit).max().item()
