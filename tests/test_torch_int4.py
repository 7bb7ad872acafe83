"""Port parity: the int4 weight scheme (kernel K8) and the stream probe (K13).

The JAX package and the port get the same numpy weights and activations.
Tolerances:
  * ``quantize_weight_int4``: packed bytes and scales bit for bit;
  * ``int4_matmul_reference`` against the JAX ``int4_decode_matmul``
    (interpret mode at m <= 128, the XLA route above): 1e-6 of max |y|. The
    int32 group dots are exact in both; XLA's fused ``acc + part * scale``
    may contract into a fused multiply-add, so the f32 sums may differ in
    the last bit;
  * K8 and K13 run only on the card (``cuda`` marker): K8 within 1e-5 of
    max |y| of its plain version (the kernel adds the groups in another
    order), K13's byte sum exactly equal to the plain version's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_scaling_tpu.ops import quant_matmul as jqm
from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
from retrieval_scaling_tpu_torch.ops.stream_probe import stream_floor, stream_probe, stream_probe_reference

torch.set_num_threads(1)


def _weight(seed, k, n):
    return (0.02 * np.random.RandomState(seed).randn(k, n)).astype(np.float32)


@pytest.mark.parametrize("k,n", [(256, 64), (384, 48), (1024, 160)])
def test_quantize_weight_int4_matches_jax_bit_for_bit(k, n):
    w = _weight(k + n, k, n)
    ours = qm.quantize_weight_int4(torch.from_numpy(w))
    theirs = jqm.quantize_weight_int4(jnp.asarray(w))
    assert ours.packed.dtype == torch.uint8 and ours.scale.dtype == torch.float32
    np.testing.assert_array_equal(ours.packed.numpy(), np.asarray(theirs.packed))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(theirs.scale))
    np.testing.assert_array_equal(qm._int4_unpack(ours.packed).numpy(), np.asarray(jqm._int4_unpack(theirs.packed)))


@pytest.mark.parametrize("m", [1, 8, 130])
@pytest.mark.parametrize("k,n", [(256, 128), (384, 48)])
def test_int4_plain_matches_jax_kernel(m, k, n):
    w = _weight(1, k, n)
    x = np.random.RandomState(m).randn(m, k).astype(np.float32)
    qw = jqm.quantize_weight_int4(jnp.asarray(w))
    ref = np.asarray(jqm.int4_decode_matmul(jnp.asarray(x), qw, interpret=True, out_dtype=jnp.float32))
    ours = qm.int4_decode_matmul(torch.from_numpy(x), qm.quantize_weight_int4(torch.from_numpy(w)),
                                 out_dtype=torch.float32).numpy()
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


def test_int4_store_dispatch_and_cpu_route():
    """``has_q8`` / ``q8_dot`` take the ``@q4`` / ``@s4g`` pair; a CPU tensor
    takes the plain version and launches nothing."""
    w = torch.from_numpy(_weight(2, 256, 64))
    qw = qm.quantize_weight_int4(w)
    store = {"w@q4": qw.packed, "w@s4g": qw.scale}
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 5, 256).astype(np.float32))
    launches, calls = qm.int4_decode_matmul.launches, qm.int4_matmul_reference.cuda_calls
    assert qm.has_q8(store, "w") and not qm.has_q8(store, "v")
    y = qm.q8_dot(store, "w", x)
    assert y.shape == (2, 5, 64) and y.dtype == torch.float32
    np.testing.assert_array_equal(
        y.reshape(10, 64).numpy(), qm.int4_matmul_reference(x.reshape(10, 256), qw.packed, qw.scale,
                                                            torch.float32).numpy())
    assert (qm.int4_decode_matmul.launches, qm.int4_matmul_reference.cuda_calls) == (launches, calls)
    # the product follows the float one: int4 steps are 1/7 of a group's
    # absmax, so rows are held by direction (cosine > 0.97)
    ref = (x @ w).reshape(10, 64)
    cos = (y.reshape(10, 64) * ref).sum(-1) / (y.reshape(10, 64).norm(dim=-1) * ref.norm(dim=-1))
    assert cos.min() > 0.97


def test_stream_probe_plain_sums_every_byte():
    bufs = [torch.arange(64, dtype=torch.uint8), torch.full((4, 8), -1, dtype=torch.int8),
            torch.ones(16, dtype=torch.bfloat16)]
    want = sum(range(64)) + 32 * 255 + 16 * 0x3F80.to_bytes(2, "little")[0] + 16 * 0x3F80.to_bytes(2, "little")[1]
    assert stream_probe_reference(bufs) == want
    assert stream_probe(bufs) == want  # CPU tensors take the plain version
    with pytest.raises(ValueError):
        stream_floor(bufs)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K8 / K13 kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 33, 64, 200])
@pytest.mark.parametrize("k,n", [(4096, 1024), (384, 48), (14336, 256), (2048, 50304)])
def test_k8_matches_plain_on_cuda(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(m + k)
    w = 0.02 * torch.randn(k, n, generator=gen, device=cuda_device)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    qw = qm.quantize_weight_int4(w)
    before = qm.int4_decode_matmul.launches
    y = qm.int4_decode_matmul(x, qw, out_dtype=torch.float32)
    ref = qm.int4_matmul_reference(x, qw.packed, qw.scale, torch.float32)
    torch.cuda.synchronize()
    assert qm.int4_decode_matmul.launches == before + 1
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    y16 = qm.int4_decode_matmul(x.to(torch.bfloat16), qw, out_dtype=torch.bfloat16)
    ref16 = qm.int4_matmul_reference(x.to(torch.bfloat16), qw.packed, qw.scale, torch.float32)
    torch.cuda.synchronize()
    assert (y16.float() - ref16).abs().max().item() <= 1e-2 * ref16.abs().max().item()


@pytest.mark.cuda
def test_k13_sums_every_byte_on_cuda(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    bufs = [torch.randint(-128, 128, (n,), generator=gen, device=cuda_device, dtype=torch.int8)
            for n in (16, 4096, 3 << 20, (1 << 20) + 48)]
    bufs.append(torch.randn(4096, 1024, generator=gen, device=cuda_device).to(torch.bfloat16))
    before = stream_probe.launches
    assert stream_probe(bufs) == stream_probe_reference(bufs)
    assert stream_probe.launches == before + 1
    floor = stream_floor(bufs, reps=3)
    assert floor["checksum"] == stream_probe_reference(bufs) and floor["ms"] > 0
