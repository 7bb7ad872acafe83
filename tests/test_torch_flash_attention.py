"""Port parity: attention (retrieval_scaling_tpu_torch.ops.flash_attention).

The port's plain attention is held to the JAX package's Pallas kernel (run
in interpret mode, as tests/test_ops.py runs it) and to ``xla_attention``
on the same numpy inputs, in f32 at the tests/test_ops.py tolerance, with
and without K2's window and soft-cap. The CUDA kernel itself runs only on
the card: those tests carry the ``cuda`` marker and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_scaling_tpu.ops.flash_attention import flash_attention as jax_flash
from retrieval_scaling_tpu.ops.flash_attention import xla_attention
from retrieval_scaling_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    multi_head_attention,
)

torch.set_num_threads(1)
TOL = 2e-5  # tests/test_ops.py's f32 parity tolerance


def _inputs(seed, b, h, hkv, sq, sk, d, masked):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hkv, sk, d).astype(np.float32)
    v = rng.randn(b, hkv, sk, d).astype(np.float32)
    mask = None
    if masked:
        lengths = np.array([sk, max(3, sk - 21)][:b])
        mask = np.arange(sk)[None, :] < lengths[:, None]
    return q, k, v, mask


def _port(q, k, v, mask, causal):
    tmask = None if mask is None else torch.from_numpy(mask)
    return flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_mask=tmask, causal=causal
    ).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "sq,sk,h,hkv,masked",
    [(40, 40, 4, 4, True), (64, 128, 4, 4, False), (32, 64, 4, 2, True), (64, 64, 4, 1, False)],
)
def test_plain_matches_jax_kernel_and_xla(causal, sq, sk, h, hkv, masked):
    q, k, v, mask = _inputs(0, 2, h, hkv, sq, sk, 32, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_kernel = np.asarray(jax_flash(*args, kv_mask=jmask, causal=causal, interpret=True))
    ref_xla = np.asarray(xla_attention(*args, kv_mask=jmask, causal=causal))
    out = _port(q, k, v, mask, causal)
    np.testing.assert_allclose(out, ref_kernel, atol=TOL, rtol=TOL)
    # every row here sees at least one key, where xla_attention agrees too
    np.testing.assert_allclose(out, ref_xla, atol=TOL, rtol=TOL)


def test_fully_masked_row_is_exactly_zero():
    """A padded batch row (no visible key) gives exactly 0, as the Pallas
    kernels do; xla_attention differs there (uniform average), so only the
    real row is held to it."""
    q, k, v, _ = _inputs(1, 2, 2, 2, 48, 48, 16, False)
    mask = np.zeros((2, 48), bool)
    mask[0, :30] = True
    out = _port(q, k, v, mask, False)
    assert (out[1] == 0).all()
    jmask = jnp.asarray(mask)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_kernel = np.asarray(jax_flash(*args, kv_mask=jmask, interpret=True))
    np.testing.assert_allclose(out, ref_kernel, atol=TOL, rtol=TOL)
    ref_xla = np.asarray(xla_attention(*args, kv_mask=jmask))
    np.testing.assert_allclose(out[0], ref_xla[0], atol=TOL, rtol=TOL)


def test_causal_rows_before_the_first_key_are_zero():
    """sq > sk causal: rows aligned before the key row's start see nothing."""
    q, k, v, _ = _inputs(2, 1, 2, 2, 24, 16, 16, False)
    out = _port(q, k, v, None, True)
    assert (out[:, :, :8] == 0).all()
    ref = np.asarray(
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, interpret=True)
    )
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_cpu_tensors_take_the_plain_version():
    launches, cuda_calls = flash_attention.launches, attention_reference.cuda_calls
    q, k, v, mask = _inputs(3, 2, 2, 2, 16, 16, 8, True)
    out = _port(q, k, v, mask, True)
    ref = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask), True
    ).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (flash_attention.launches, attention_reference.cuda_calls) == (launches, cuda_calls)


def _packed_segments(rng, b, s, lo=20, hi=150):
    """Contiguous segments of random lengths and a pad tail (tests/test_ops.py's layout)."""
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        posn, sid = 0, 1
        while posn < s - 40:
            ln = rng.randint(lo, hi)
            seg[r, posn : posn + ln] = sid
            posn += ln
            sid += 1
    return seg


@pytest.mark.parametrize(
    "kwargs", [{}, {"window": 4}, {"logit_cap": 30.0}]
)
def test_unported_kernel_features_raise(kwargs):
    """Packed rows (K2s), alone and beside K2's window and cap, against the
    JAX package (its Pallas kernel in interpret mode; segments with a window
    go to its ``xla_attention``) on the real rows, with the packed path's key
    mask. Pad rows are exactly 0. (The name is the one this test had while
    K2s was not ported and these three cases raised.)"""
    rng = np.random.RandomState(11)
    b, h, s, d = 2, 2, 300, 32
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    cap = kwargs.get("logit_cap")
    if cap:
        q = q * np.float32(cap / 2)
    seg = _packed_segments(rng, b, s)
    mask = seg > 0
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    if "window" in kwargs:
        ref = np.asarray(xla_attention(*jargs, jnp.asarray(mask), False, None, None, kwargs["window"],
                                       jnp.asarray(seg)))
    else:
        ref = np.asarray(jax_flash(*jargs, kv_mask=jnp.asarray(mask), segment_ids=jnp.asarray(seg), interpret=True,
                                   block_q=128, block_k=128, logit_cap=cap))
    out = multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
                               segment_ids=torch.from_numpy(seg), **kwargs).numpy()
    np.testing.assert_allclose(out.transpose(0, 2, 1, 3)[mask], ref.transpose(0, 2, 1, 3)[mask], atol=TOL, rtol=TOL)
    assert (out.transpose(0, 2, 1, 3)[~mask] == 0).all()


def test_segment_bounds_match_jax():
    from retrieval_scaling_tpu.ops.flash_attention import segment_bounds as jax_bounds
    from retrieval_scaling_tpu_torch.ops.flash_attention import segment_bounds

    seg = np.concatenate([_packed_segments(np.random.RandomState(12), 3, 400),
                          np.asarray([[1, 1, 2, 2, 2, 3, 0, 0] * 50], np.int32)])
    lo, hi = segment_bounds(torch.from_numpy(seg))
    jlo, jhi = jax_bounds(jnp.asarray(seg))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert lo.dtype == hi.dtype == torch.int32


@pytest.mark.parametrize("masked", [False, True])
def test_segmented_plain_matches_jax_kernel_and_xla(masked):
    """Segmented attention (tests/test_ops.py's case) against the JAX kernel
    in interpret mode at 128-row blocks and ``xla_attention``, on the real
    rows at 2e-5; pad rows are exactly 0 (with or without the key mask)."""
    rng = np.random.RandomState(0)
    b, h, s, d = 2, 3, 512, 32
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    seg = _packed_segments(rng, b, s)
    real = seg > 0
    jmask = jnp.asarray(real) if masked else None
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_kernel = np.asarray(jax_flash(*jargs, kv_mask=jmask, segment_ids=jnp.asarray(seg), interpret=True,
                                      block_q=128, block_k=128))
    ref_xla = np.asarray(xla_attention(*jargs, jmask, segment_ids=jnp.asarray(seg)))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          kv_mask=torch.from_numpy(real) if masked else None,
                          segment_ids=torch.from_numpy(seg)).numpy()
    sel = np.broadcast_to(real[:, None, :, None], out.shape)
    np.testing.assert_allclose(out[sel], ref_kernel[sel], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out[sel], ref_xla[sel], atol=TOL, rtol=TOL)
    assert (out[~sel] == 0).all()


# ---------------------------------------------------------------- K2: window and soft-cap
@pytest.mark.parametrize(
    "sq,sk,h,hkv,d,window,cap,masked",
    [
        (40, 40, 4, 2, 32, 8, None, False),      # Mistral / Phi-3: window only
        (40, 40, 4, 2, 32, None, 20.0, True),    # Gemma-2's global layers: cap only
        (24, 64, 4, 1, 64, 16, 30.0, True),      # Sq < Sk: the band on end-aligned positions
        (300, 300, 2, 2, 64, 100, 50.0, False),  # several key blocks of the looped Pallas kernel
        (40, 40, 4, 2, 96, 8, 50.0, False),      # Phi-3-mini's head dim
    ],
)
def test_window_and_cap_match_jax_kernel_and_xla(sq, sk, h, hkv, d, window, cap, masked):
    """With a cap, q is scaled so that the scores spread to about cap / 2 and
    the cap changes the output (checked against the uncapped plain version)."""
    q, k, v, mask = _inputs(5, 2, h, hkv, sq, sk, d, masked)
    if cap:
        q = q * np.float32(cap / 2)
    jmask = None if mask is None else jnp.asarray(mask)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(kv_mask=jmask, causal=True, window=window, logit_cap=cap)
    # 128-row blocks so that S = 300 runs the looped kernel's band skipping
    ref_kernel = np.asarray(jax_flash(*args, interpret=True, block_q=128, block_k=128, **kw))
    ref_xla = np.asarray(xla_attention(*args, jmask, True, None, cap, window))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tmask, causal=True,
                               window=window, logit_cap=cap).numpy()
    np.testing.assert_allclose(out, ref_kernel, atol=TOL, rtol=TOL)
    # rows that see no key (the band above a padded row's end) are 0 here and
    # in the kernel; xla_attention averages V there, so it holds the others
    seen = np.abs(ref_kernel).sum(-1) > 0
    np.testing.assert_allclose(out[seen], ref_xla[seen], atol=TOL, rtol=TOL)
    if cap:
        uncapped = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tmask,
                                        causal=True, window=window).numpy()
        assert np.abs(uncapped - out).max() > 0.1


def test_window_implies_causal_and_hides_old_keys():
    """window without causal is causal; with window 1 a row sees only itself."""
    q, k, v, _ = _inputs(6, 1, 2, 2, 16, 16, 16, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_array_equal(flash_attention(tq, tk, tv, window=5).numpy(),
                                  flash_attention(tq, tk, tv, causal=True, window=5).numpy())
    np.testing.assert_allclose(flash_attention(tq, tk, tv, window=1).numpy(), v, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,d,causal,masked",
    [
        (4, 12, 12, 256, 256, 64, False, True),
        (2, 8, 8, 1024, 1024, 256, True, False),
        (1, 8, 2, 100, 300, 128, True, True),
        (2, 4, 4, 33, 33, 64, True, True),
    ],
)
def test_kernel_matches_plain_on_cuda(cuda_device, dtype, b, h, hkv, sq, sk, d, causal, masked):
    """K1 against the plain version (f32 math on the same 16-bit inputs),
    within the bf16 envelope pinned by tests/test_ops.py."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(b, h, sq, d, generator=gen, device=cuda_device).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=cuda_device).to(dtype)
    mask = None
    if masked:
        lengths = torch.randint(1, sk + 1, (b,), generator=gen, device=cuda_device)
        lengths[-1] = 0
        mask = torch.arange(sk, device=cuda_device)[None, :] < lengths[:, None]
    before = flash_attention.launches
    out = flash_attention(q, k, v, kv_mask=mask, causal=causal)
    ref = attention_reference(q.float(), k.float(), v.float(), kv_mask=mask, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert (out.float() - ref).abs().max().item() <= 2e-2
    if masked:
        assert (out[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,d,window,cap,masked",
    [
        (1, 16, 8, 1100, 1100, 256, 300, 50.0, False),  # Gemma-2 heads, band skipping
        (2, 16, 8, 512, 512, 256, None, 50.0, True),    # Gemma-2 global layers: cap only
        (1, 32, 8, 700, 700, 128, 256, None, True),     # Mistral heads: window only
        (2, 8, 2, 100, 350, 96, 64, 30.0, True),        # Phi-3 head dim, Sq < Sk
        (1, 4, 4, 70, 70, 64, 1, None, False),          # each row sees itself only
    ],
)
def test_k2_window_and_cap_match_plain_on_cuda(cuda_device, dtype, b, h, hkv, sq, sk, d, window, cap, masked):
    """K2 against the plain version (f32 math on the same 16-bit inputs),
    within K1's bf16 envelope; a fully masked batch row is exactly 0. With a
    cap, q is scaled so that the scores spread to about cap / 2 and the
    largest pass the cap: there the plain version's capped and uncapped
    outputs differ by more than ten times the limit, so a kernel without
    the cap fails."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = (torch.randn(b, h, sq, d, generator=gen, device=cuda_device) * (cap / 2 if cap else 1.0)).to(dtype)
    k = torch.randn(b, hkv, sk, d, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(b, hkv, sk, d, generator=gen, device=cuda_device).to(dtype)
    mask = None
    if masked:
        lengths = torch.randint(sk // 2, sk + 1, (b,), generator=gen, device=cuda_device)
        lengths[-1] = 0
        mask = torch.arange(sk, device=cuda_device)[None, :] < lengths[:, None]
    before = (flash_attention.launches, flash_attention.window_launches, flash_attention.cap_launches)
    out = flash_attention(q, k, v, kv_mask=mask, causal=True, window=window, logit_cap=cap)
    ref = attention_reference(q.float(), k.float(), v.float(), kv_mask=mask, causal=True, window=window,
                              logit_cap=cap)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.window_launches, flash_attention.cap_launches) == (
        before[0] + 1, before[1] + (window is not None), before[2] + (cap is not None))
    assert (out.float() - ref).abs().max().item() <= 2e-2
    if cap:
        uncapped = attention_reference(q.float(), k.float(), v.float(), kv_mask=mask, causal=True, window=window)
        assert (uncapped - ref).abs().max().item() > 10 * 2e-2
    if masked:
        assert (out[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal", [(64, False), (256, True)])
def test_kernel_reads_strided_views_on_cuda(cuda_device, d, causal):
    """Q/K/V as views of one fused [B, S, 3, H, D] projection (the models'
    layout) give the same result as contiguous copies, and the result is a
    [B, H, S, D] view of a [B, S, H, D] buffer."""
    b, s, h = 2, 200, 4
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    fused = torch.randn(b, s, 3, h, d, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = fused.permute(2, 0, 3, 1, 4)
    mask = torch.arange(s, device=cuda_device)[None, :] < torch.tensor([[s], [s - 37]], device=cuda_device)
    out = flash_attention(q, k, v, kv_mask=mask, causal=causal)
    ref = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_mask=mask, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert out.transpose(1, 2).is_contiguous()


def _cuda_segments(gen, b, s, mean_len, device):
    """Best-fit-like packed rows: segments of lengths around ``mean_len``
    placed with no alignment, a pad tail, and one all-pad row."""
    seg = torch.zeros(b, s, dtype=torch.int32)
    for r in range(b - 1):
        posn, sid = 0, 1
        while True:
            ln = int(torch.randint(max(1, mean_len // 4), 2 * mean_len, (1,), generator=gen))
            if posn + ln > s:
                break
            seg[r, posn : posn + ln] = sid
            posn, sid = posn + ln, sid + 1
    return seg.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize(
    "b,h,s,d,mean_len,masked,causal,window,cap",
    [
        (8, 12, 256, 64, 40, True, False, None, None),    # the packed encoder's shape
        (4, 12, 512, 64, 24, True, False, None, None),    # packed queries at question_maxlength 512
        (4, 4, 300, 64, 150, False, False, None, None),   # long segments: whole tiles inside one run
        (2, 8, 256, 128, 40, True, True, 32, 30.0),       # segments with a window and a cap
        (2, 4, 200, 256, 30, False, True, None, None),    # causal segments, d = 256
    ],
)
def test_k2s_segments_match_plain_on_cuda(cuda_device, dtype, b, h, s, d, mean_len, masked, causal, window, cap):
    """K2s against the plain version (f32 math on the same 16-bit inputs),
    within K1's bf16 envelope; pad rows (and the all-pad batch row) exactly
    0; the launch counted as a segment launch."""
    gen = torch.Generator().manual_seed(3)
    seg = _cuda_segments(gen, b, s, mean_len, cuda_device)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(cuda_device, dtype) for _ in range(3))
    mask = (seg > 0) if masked else None
    before = (flash_attention.launches, flash_attention.segment_launches)
    out = flash_attention(q, k, v, kv_mask=mask, causal=causal, window=window, logit_cap=cap, segment_ids=seg)
    ref = attention_reference(q.float(), k.float(), v.float(), kv_mask=mask, causal=causal, window=window,
                              logit_cap=cap, segment_ids=seg)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.segment_launches) == (before[0] + 1, before[1] + 1)
    assert (out.float() - ref).abs().max().item() <= 2e-2
    pad = (seg == 0)[:, None, :, None].expand_as(out)
    assert (out[pad] == 0).all()


# ---------------------------------------------------------------- K3 with per-query positions
@pytest.mark.parametrize("h,hkv,d,window,cap", [(4, 4, 64, None, None), (8, 2, 32, None, None),
                                                (4, 2, 64, 6, None), (8, 4, 32, 5, 20.0)])
def test_decode_per_query_positions_match_jax_attention_over_a_filled_cache(h, hkv, d, window, cap):
    """``flash_decode_reference`` with ``q_pos`` / ``window`` (a verify segment
    over a filled cache: query j at position n + j) against the JAX
    ``_attention_with_cache`` the verify forward runs (causal by position,
    ``all_visible`` false), GQA, window and cap: 2e-5. Every query sees at
    least its own slot, where the two packages' conventions agree."""
    from retrieval_scaling_tpu.models.generate import _attention_with_cache

    from retrieval_scaling_tpu_torch.ops.flash_attention import flash_decode, flash_decode_reference

    rng = np.random.RandomState(h + d)
    b, sq, m = 3, 8, 40
    q = (rng.randn(b, h, sq, d) * (3.0 if cap else 1.0)).astype(np.float32)
    k, v = (rng.randn(b, hkv, m, d).astype(np.float32) for _ in range(2))
    n = np.array([5, 20, 31])
    q_pos = n[:, None] + np.arange(sq)[None, :]
    valid = np.arange(m)[None, :] < (n + sq)[:, None]
    want = np.asarray(_attention_with_cache(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
                                            jnp.asarray(valid), logit_cap=cap, window=window))
    args = [torch.from_numpy(t) for t in (q, k, v, valid)]
    got = flash_decode_reference(*args, logit_cap=cap, q_pos=torch.from_numpy(q_pos), window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the wrapper takes the plain version on the CPU; the last query of a row
    # with q_pos at n + sq - 1 is the whole-mask decode row
    wrapped = flash_decode(*args, logit_cap=cap, q_pos=torch.from_numpy(q_pos), window=window)
    assert torch.equal(wrapped, got)
    if window is None:
        whole = flash_decode_reference(*args, logit_cap=cap)
        np.testing.assert_allclose(got[:, :, -1].numpy(), whole[:, :, -1].numpy(), atol=TOL, rtol=TOL)


def test_decode_window_needs_positions():
    from retrieval_scaling_tpu_torch.ops.flash_attention import flash_decode

    q, k = torch.zeros(1, 2, 1, 64), torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        flash_decode(q, k, k, window=4)
    with pytest.raises(ValueError):
        flash_decode(q, k, k, q_pos=torch.zeros(1, 2, dtype=torch.long))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,m,d,window,cap", [
    (8, 8, 8, 8, 1032, 256, None, None),       # Pythia-1B verify, draft 7
    (8, 32, 8, 8, 340, 128, None, None),       # Llama-3.1-8B widths: 32 rows per KV head
    (8, 16, 8, 8, 4500, 256, 4096, 50.0),      # Gemma-2: the window's edge inside the segment
    (2, 4, 2, 16, 300, 64, 7, None),           # draft_len 15: Sq 16 in one launch
])
def test_k3_per_query_bounds_match_plain_and_one_token_steps_on_cuda(cuda_device, dtype, b, h, hkv, sq, m, d,
                                                                      window, cap):
    """K3 with ``q_pos`` against its plain version (1e-4 of max |y| in f32,
    1e-2 in bf16), counted as a verify launch; and each verify row equal bit
    for bit to a one-token launch at that row's position over a cache of
    another capacity (the fixed key splits)."""
    from retrieval_scaling_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=cuda_device).manual_seed(m)
    q = (torch.randn(b, h, sq, d, generator=gen, device=cuda_device) * (3.0 if cap else 1.0)).to(dtype)
    k, v = (torch.randn(b, hkv, m, d, generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    n = torch.randint(m // 2, m - sq - 8, (b,), generator=gen, device=cuda_device)
    q_pos = n[:, None] + torch.arange(sq, device=cuda_device)[None, :]
    mask = torch.arange(m, device=cuda_device)[None, :] < (n + sq)[:, None]
    before = fa.flash_decode.verify_launches
    out = fa.flash_decode(q, k, v, kv_mask=mask, logit_cap=cap, q_pos=q_pos, window=window)
    ref = fa.flash_decode_reference(q.float(), k.float(), v.float(), kv_mask=mask, logit_cap=cap, q_pos=q_pos,
                                    window=window)
    torch.cuda.synchronize()
    assert fa.flash_decode.verify_launches == before + 1
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol
    m2 = m - 8
    k2, v2 = k[:, :, :m2].contiguous(), v[:, :, :m2].contiguous()
    for j in range(sq):
        mj = torch.arange(m2, device=cuda_device)[None, :] < (n + j + 1)[:, None]
        step = fa.flash_decode(q[:, :, j:j + 1].contiguous(), k2, v2, kv_mask=mj, logit_cap=cap,
                               q_pos=q_pos[:, j:j + 1], window=window)
        assert torch.equal(step[:, :, 0], out[:, :, j])
