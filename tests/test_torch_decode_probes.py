"""Port parity: the decode probes S1, S2 and S5
(retrieval_scaling_tpu_torch.ops.decode_probes).

The Pallas kernels are closures inside each script's ``main()`` and cannot
be imported without running it, so their bodies are transcribed here in jnp
(file and line cited at each) and run under ``jax.jit``, as the scripts run
them. The port's plain versions get the same numpy inputs at small shapes
(K 256, N 512, M 8, L 3):
  * the s8 variants (S1-cur, S1-preq, S1-dual) exactly: the int32 sums are
    exact and the scaling runs in the same order; ``rowquant_xla`` equals
    the script's XLA row quantisation bit for bit (XLA turns its division by
    127 into a multiplication by f32(1/127) under jit);
  * the bf16-product variants (S1-w8bf16, S1-bf16, S1-dual-bf16, S2) in f32
    within 1e-5 of max |y|: f32 sums in another order;
  * S5's copy exactly.
The kernels themselves run only on the card: those tests carry the ``cuda``
marker and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_scaling_tpu_torch.ops import decode_probes as dp

K, N, M, L = 256, 512, 8, 3
NEG = 1e-30
F32 = jnp.float32


def _dot(a, b, out):
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), preferred_element_type=out)


# ---------------------------------------------------------------- jnp transcriptions
def rowquant_xla(x):  # scripts/ablate_decode.py:104-109
    xf = x.astype(F32)
    s = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
    s = jnp.maximum(s, NEG)
    return jnp.clip(jnp.round(xf / s), -127, 127).astype(jnp.int8), s


def kern_cur(x, wq, s):  # scripts/ablate_decode.py:112-120 (o_ref dtype bf16)
    xf = x.astype(F32)
    sc = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, NEG)
    xq = jnp.clip(jnp.round(xf / sc), -127, 127).astype(jnp.int8)
    return (_dot(xq, wq, jnp.int32).astype(F32) * sc * s).astype(jnp.bfloat16)


def kern_preq(xq, xs, wq, s):  # scripts/ablate_decode.py:122-127
    return (_dot(xq, wq, jnp.int32).astype(F32) * xs * s).astype(jnp.bfloat16)


def kern_dual(aq, asc, hq, hsc, res, wo, so, w2, s2):  # scripts/ablate_decode.py:129-146
    a1, a2 = _dot(aq, wo, jnp.int32), _dot(hq, w2, jnp.int32)
    return (res.astype(F32) + a1.astype(F32) * asc * so + a2.astype(F32) * hsc * s2).astype(jnp.bfloat16)


def kern_w8bf16(x, wq, s):  # scripts/ablate_decode.py:202-209, before the cast to bf16
    return _dot(x, wq.astype(jnp.bfloat16), F32) * s


def kern_preq_bf16(x, w):  # scripts/ablate_decode.py:268-272, before the cast
    return _dot(x, w, F32)


def kern_dual_bf16(a, h, res, wo, w2):  # scripts/ablate_decode.py:274-283, before the cast
    return res.astype(F32) + _dot(a, wo, F32) + _dot(h, w2, F32)


def kern3(x, w, s):  # scripts/ablate_launch_overhead.py:76-81 (kern, :49-54, is its L = 1 case)
    return _dot(x, w.astype(x.dtype), F32) * s


def touch_kernel(x):  # scripts/profile_decode_gap.py:134-135
    return x


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(M, K).astype(np.float32)
    x[3] *= 40.0  # rows of other scales
    x[5] = 0.0    # an all-zero row: the scale's 1e-30 floor
    x_bf = torch.from_numpy(x).to(torch.bfloat16)
    wq = rng.randint(-127, 128, (L, K, N)).astype(np.int8)
    s = (np.abs(rng.randn(L, N)) * 1e-3).astype(np.float32)
    h = rng.randn(M, 4 * K).astype(np.float32)
    w2 = rng.randint(-127, 128, (4 * K, N)).astype(np.int8)
    res = rng.randn(M, N).astype(np.float32)
    return dict(x_bf=x_bf, x_j=jnp.asarray(x_bf.float().numpy(), jnp.bfloat16), wq=wq, s=s, h=h, w2=w2, res=res)


def test_rowquant_matches_the_scripts_xla_bit_for_bit(inputs):
    xq, xs = dp.rowquant_xla(inputs["x_bf"])
    jq, js = jax.jit(rowquant_xla)(inputs["x_j"])
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(js)[:, 0])
    assert xs[5].item() == np.float32(NEG) and (xq[5] == 0).all()


def test_s8_variants_match_the_script_kernels_exactly(inputs):
    wq, s = inputs["wq"], inputs["s"]
    cur = dp.weight_stream(inputs["x_bf"], torch.from_numpy(wq), torch.from_numpy(s), "cur")
    xq, xs = dp.rowquant_xla(inputs["x_bf"])
    preq = dp.weight_stream(xq, torch.from_numpy(wq), torch.from_numpy(s), "preq", xs=xs)
    jq, js = jax.jit(rowquant_xla)(inputs["x_j"])
    assert cur.shape == preq.shape == (L, M, N) and cur.dtype == torch.bfloat16
    for li in range(L):
        want_cur = jax.jit(kern_cur)(inputs["x_j"], wq[li], s[li][None])
        want_preq = jax.jit(kern_preq)(jq, js, wq[li], s[li][None])
        np.testing.assert_array_equal(cur[li].float().numpy(), np.asarray(want_cur.astype(F32)))
        np.testing.assert_array_equal(preq[li].float().numpy(), np.asarray(want_preq.astype(F32)))
    # the dual stream: attn_out [K, N] and mlp_out [4K, N] with the residual
    hq, hs = dp.rowquant_xla(torch.from_numpy(inputs["h"]).to(torch.bfloat16))
    res = torch.from_numpy(inputs["res"]).to(torch.bfloat16)
    wo, so, w2, s2 = wq[0][:, :N], s[1], inputs["w2"], s[2]
    got = dp.dual_stream(xq, hq, res, torch.from_numpy(wo), torch.from_numpy(w2), torch.from_numpy(so),
                         torch.from_numpy(s2), xs, hs)
    want = jax.jit(kern_dual)(jq, js, jnp.asarray(hq.numpy()), jnp.asarray(hs.numpy())[:, None],
                              jnp.asarray(res.float().numpy(), jnp.bfloat16), wo, so[None], w2, s2[None])
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(F32)))


def test_bf16_product_variants_match_the_script_kernels(inputs):
    wq, s, x_j = inputs["wq"], inputs["s"], inputs["x_j"]
    w_bf = torch.from_numpy(wq[0]).to(torch.bfloat16) * 1e-3
    cases = [
        (dp.weight_stream(inputs["x_bf"], torch.from_numpy(wq), torch.from_numpy(s), "w8bf16",
                          out_dtype=torch.float32),
         np.stack([np.asarray(jax.jit(kern_w8bf16)(x_j, wq[li], s[li][None])) for li in range(L)])),
        (dp.weight_stream(inputs["x_bf"], w_bf, None, "bf16", out_dtype=torch.float32),
         np.asarray(jax.jit(kern_preq_bf16)(x_j, jnp.asarray(w_bf.float().numpy(), jnp.bfloat16)))),
        # S2: the same function, one launch over the stacked weights
        (dp.weight_stream(inputs["x_bf"], torch.from_numpy(wq), torch.from_numpy(s), "w8bf16",
                          out_dtype=torch.float32),
         np.stack([np.asarray(jax.jit(kern3)(x_j, wq[li], s[li][None])) for li in range(L)])),
    ]
    h_bf = torch.from_numpy(inputs["h"]).to(torch.bfloat16)
    res = torch.from_numpy(inputs["res"]).to(torch.bfloat16)
    w2_bf = torch.from_numpy(inputs["w2"]).to(torch.bfloat16) * 1e-3
    cases.append((dp.dual_stream(inputs["x_bf"], h_bf, res, w_bf, w2_bf, out_dtype=torch.float32),
                  np.asarray(jax.jit(kern_dual_bf16)(x_j, jnp.asarray(h_bf.float().numpy(), jnp.bfloat16),
                                                     jnp.asarray(res.float().numpy(), jnp.bfloat16),
                                                     jnp.asarray(w_bf.float().numpy(), jnp.bfloat16),
                                                     jnp.asarray(w2_bf.float().numpy(), jnp.bfloat16)))))
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_tiny_copy_and_the_touch_step_on_the_cpu():
    src = torch.from_numpy(np.random.RandomState(1).randn(8, 128).astype(np.float32))
    np.testing.assert_array_equal(dp.tiny_copy(src).numpy(), np.asarray(jax.jit(touch_kernel)(src.numpy())))
    dst = torch.empty_like(src)
    assert dp.tiny_copy(src, dst) is dst and torch.equal(dst, src)


@pytest.mark.parametrize("kwargs", [dict(mode="int4"), dict(mode="preq")])
def test_bad_probe_calls_raise(kwargs):
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        dp.weight_stream(x, torch.zeros(K, N, dtype=torch.int8), torch.ones(N), **kwargs)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode probe kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cur", "preq", "w8bf16", "bf16"])
@pytest.mark.parametrize("m,k,n,layers", [(8, 2048, 6144, 1), (8, 8192, 2048, 1), (5, 2048, 6144, 16),
                                          (8, 2048, 50304, 1)])
def test_weight_stream_matches_plain_on_cuda(cuda_device, mode, m, k, n, layers):
    """S1 / S2 at Pythia-1B's shapes against the plain version: the s8 modes
    within one bf16 ulp of the plain f32 result (exact int32 sums), the bf16
    products in f32 within 1e-4 of max |y|; one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(k + n)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (layers, k, n), generator=gen, device=cuda_device, dtype=torch.int8)
    s = torch.rand(layers, n, generator=gen, device=cuda_device) * 1e-3
    w = (wq.to(torch.bfloat16) * 1e-3) if mode == "bf16" else wq
    sc = None if mode == "bf16" else s
    xin, xs = dp.rowquant_xla(x) if mode == "preq" else (x, None)
    before = dp.weight_stream.launches
    out_dtype = torch.bfloat16 if mode in ("cur", "preq") else torch.float32
    y = dp.weight_stream(xin, w, sc, mode, xs=xs, out_dtype=out_dtype)
    ref = dp.weight_stream_reference(xin, w, sc, mode, xs=xs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert dp.weight_stream.launches == before + 1
    if mode in ("cur", "preq"):
        assert ((y.float() - ref).abs() <= torch.finfo(torch.bfloat16).eps * ref.abs()).all()
    else:
        assert (y - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
def test_dual_stream_and_tiny_copy_match_plain_on_cuda(cuda_device, int8):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = torch.randn(8, 2048, generator=gen, device=cuda_device).to(torch.bfloat16)
    h = torch.randn(8, 8192, generator=gen, device=cuda_device).to(torch.bfloat16)
    res = torch.randn(8, 2048, generator=gen, device=cuda_device).to(torch.bfloat16)
    wo = torch.randint(-127, 128, (2048, 2048), generator=gen, device=cuda_device, dtype=torch.int8)
    w2 = torch.randint(-127, 128, (8192, 2048), generator=gen, device=cuda_device, dtype=torch.int8)
    so, s2 = (torch.rand(2048, generator=gen, device=cuda_device) * 1e-3 for _ in range(2))
    if int8:
        (aq, asc), (hq, hsc) = dp.rowquant_xla(a), dp.rowquant_xla(h)
        y = dp.dual_stream(aq, hq, res, wo, w2, so, s2, asc, hsc)
        ref = dp.dual_stream_reference(aq, hq, res, wo, w2, so, s2, asc, hsc, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert ((y.float() - ref).abs() <= torch.finfo(torch.bfloat16).eps * ref.abs()).all()
    else:
        wob, w2b = wo.to(torch.bfloat16) * 1e-3, w2.to(torch.bfloat16) * 1e-3
        y = dp.dual_stream(a, h, res, wob, w2b, out_dtype=torch.float32)
        ref = dp.dual_stream_reference(a, h, res, wob, w2b, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert (y - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    src = torch.randn(8, 128, generator=gen, device=cuda_device)
    before = dp.tiny_copy.launches
    assert torch.equal(dp.tiny_copy(src), src) and dp.tiny_copy.launches == before + 1
