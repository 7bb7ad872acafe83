"""Port parity: the fused exact scan (ops/fused_scan.py, K11) and the Flat
SQ8 datastore with ``approx_recall`` (ops/topk.py, index/flat.py).

The same numpy inputs, made from a seed, go through the JAX package and the
port on the CPU. The JAX Pallas kernel runs in interpret mode, as
tests/test_ops.py runs it. Tolerances: segment maxima are f32 sums of the
same products taken in another order, 1e-5 relative; ids are equal (random
floats have no ties). The SQ8 scan is an exact int32 product scaled in the
same order in both packages, so its scores are equal to the bit. The CUDA
kernel runs only on the card: those tests carry the ``cuda`` marker and skip
here.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_scaling_tpu.index.flat import FlatIndex as JaxFlat
from retrieval_scaling_tpu.ops import fused_scan as jfused
from retrieval_scaling_tpu.ops.topk import chunked_topk_scores as jax_chunked_topk
from retrieval_scaling_tpu_torch.index.flat import FlatIndex, quantize_rows_sq8
from retrieval_scaling_tpu_torch.ops import fused_scan
from retrieval_scaling_tpu_torch.ops.ivf_gather import gather_score_tiles
from retrieval_scaling_tpu_torch.ops.topk import chunked_topk_scores

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL = 1e-5
T = torch.from_numpy


def _scan_case(seed, n_pad=2 * fused_scan.BLOCK, d=32, b=3):
    rng = np.random.RandomState(seed)
    return rng.randn(n_pad, d).astype(np.float32), rng.randn(b, d).astype(np.float32)


# ---------------------------------------------------------------- K11's plain route
def test_segmax_scan_plain_matches_jax_pallas():
    """The shapes of tests/test_ops.py::test_fused_segmax_scan_exact."""
    db, q = _scan_case(0)
    n_valid = db.shape[0] - 77
    ref = np.asarray(jfused.segmax_scan(jnp.asarray(q), jnp.asarray(db), n_valid, interpret=True))
    ours = fused_scan.segmax_scan(T(q), T(db), n_valid).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=RTOL * np.abs(ref[ref > -1e29]).max())
    assert ours[:, -1].min() > -1e29  # the last segment keeps 51 valid rows


@pytest.mark.parametrize("n_valid,k", [(2 * 2048 - 77, 10), (300, 10), (100, 300), (2 * 2048, 5000)])
def test_flat_topk_fused_plain_matches_jax_pallas(n_valid, k):
    """Ids equal JAX's, including masked tails (k beyond n_valid) and the
    (NEG_INF, -1) padding past k_seg * SEG candidates."""
    db, q = _scan_case(1)
    s_ref, i_ref = jfused.flat_topk_fused(jnp.asarray(q), jnp.asarray(db), n_valid, k, interpret=True)
    s, i = fused_scan.flat_topk_fused(T(q), T(db), n_valid, k)
    i_ref, s_ref = np.asarray(i_ref), np.asarray(s_ref)
    real = min(k, n_valid)
    np.testing.assert_allclose(s.numpy()[:, :real], s_ref[:, :real], rtol=RTOL, atol=1e-5)
    # the full sort (k = n_valid) meets scores one f32 rounding apart, which
    # the two summation orders may swap: an id may differ only there
    for row in range(len(q)):
        score_of = dict(zip(i_ref[row].tolist(), s_ref[row].tolist()))
        for p in np.flatnonzero(i.numpy()[row, :real] != i_ref[row, :real]):
            assert abs(score_of[int(i[row, p])] - s_ref[row, p]) <= 1e-5, (row, p)
    if k <= 10:
        np.testing.assert_array_equal(i.numpy(), i_ref)
    assert (i.numpy()[:, real:] == -1).all() and (s.numpy()[:, real:] == fused_scan.NEG_INF).all()
    exact = q @ db[:n_valid].T
    assert i.numpy()[0, :5].tolist() == np.argsort(-exact[0])[:5].tolist()


def test_segmax_scan_rejects_a_ragged_database():
    db, q = _scan_case(2, n_pad=fused_scan.BLOCK + 128)
    with pytest.raises(ValueError):
        fused_scan.segmax_scan(T(q), T(db), 10)


# ---------------------------------------------------------------- SQ8 and approx_recall
@pytest.mark.parametrize("chunk,k,approx", [(256, 7, None), (1 << 20, 7, None), (128, 600, None), (384, 9, 0.95)])
def test_sq8_chunked_topk_matches_jax_to_the_bit(chunk, k, approx):
    rng = np.random.RandomState(3)
    rows, scales = quantize_rows_sq8(rng.randn(768, 64).astype(np.float16))
    q = rng.randn(5, 64).astype(np.float32)
    n_valid = 700
    s_ref, i_ref = jax_chunked_topk(jnp.asarray(q), jnp.asarray(rows), n_valid, k, chunk_size=chunk,
                                    approx_recall=approx, row_scales=jnp.asarray(scales))
    s, i = chunked_topk_scores(T(q), T(rows), n_valid, k, chunk, approx_recall=approx, row_scales=T(scales))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_approx_recall_gives_jax_ids_on_a_float_datastore():
    rng = np.random.RandomState(4)
    db = rng.randn(1024, 32).astype(np.float32)
    q = rng.randn(4, 32).astype(np.float32)
    _, i_ref = jax_chunked_topk(jnp.asarray(q), jnp.asarray(db), 1000, 50, chunk_size=512, approx_recall=0.95)
    _, i = chunked_topk_scores(T(q), T(db), 1000, 50, 512, approx_recall=0.95)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.fixture(scope="module")
def flat_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("flat_sq8")
    rng = np.random.RandomState(5)
    paths = []
    for shard, n in enumerate((300, 211)):
        path = root / f"passages_{shard:02d}.pkl"
        with open(path, "wb") as f:
            pickle.dump((list(range(n)), rng.randn(n, 48).astype(np.float16)), f)
        paths.append(str(path))
    return root, paths, rng.randn(6, 48).astype(np.float32)


@pytest.mark.parametrize("approx", [None, 0.95])
def test_sq8_flat_index_matches_jax_across_files(flat_shards, approx):
    """Each package builds its SQ8 Flat index and loads the other's fp16
    files: ids and scores equal to the bit, and a few exact winners. The
    JAX index runs exact: its ``approx_recall`` route raises on this JAX
    (``sharded_flat_search`` traces the recall target, which
    ``lax.approx_max_k`` needs static); the port's ``approx_recall`` runs
    the exact top-k, so its ids must equal the exact JAX ids."""
    root, paths, q = flat_shards
    jkw = dict(dimension=48, quantization="int8")
    kw = dict(jkw, approx_recall=approx)
    files = {name: dict(index_path=str(root / name / "index_Flat.tpu.npz"),
                        meta_file=str(root / name / "index_Flat.tpu.ids.npy")) for name in ("jax", "port")}
    JaxFlat(embed_paths=paths, **files["jax"], **jkw)
    FlatIndex(CPU, embed_paths=paths, **files["port"], **kw)
    runs = [JaxFlat(**files["port"], **jkw).search_ids(q, 9), FlatIndex(CPU, **files["jax"], **kw).search_ids(q, 9),
            FlatIndex(CPU, **files["port"], **kw).search_ids(q, 9)]
    ref_s, ref_i = JaxFlat(**files["jax"], **jkw).search_ids(q, 9)
    for s, i in runs:
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_array_equal(s, ref_s)
    emb = np.load(files["port"]["index_path"])["embeddings"].astype(np.float32)
    np.testing.assert_array_equal(emb, np.load(files["jax"]["index_path"])["embeddings"].astype(np.float32))
    top = np.argsort(-(q @ emb.T), axis=1)[:, :3]
    assert np.mean([len(set(top[b]) & set(ref_i[b][:3].tolist())) / 3 for b in range(len(q))]) >= 0.8


# ---------------------------------------------------------------- the kernel on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K11 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 64, 80])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("cut", [77, 2048 + 130, 5 * 2048])
def test_segmax_kernel_matches_plain_on_cuda(cuda_device, b, dtype, cut):
    """n_valid cuts mid-segment, mid-block (and whole segments), or leaves a
    whole block empty; masked segments are exactly NEG_INF."""
    db, q = _scan_case(6 + b, n_pad=6 * fused_scan.BLOCK, d=200 if dtype == torch.float32 else 264, b=b)
    dbd, qd = T(db).to(cuda_device, dtype), T(q).to(cuda_device)
    n_valid = db.shape[0] - cut
    launches, plain = fused_scan.segmax_scan.launches, fused_scan.segmax_scan_reference.cuda_calls
    out = fused_scan.segmax_scan(qd, dbd, n_valid)
    torch.cuda.synchronize()
    assert fused_scan.segmax_scan.launches == launches + 1
    assert fused_scan.segmax_scan_reference.cuda_calls == plain
    ref = fused_scan.segmax_scan_reference(qd.to(dtype), dbd, n_valid)
    live = ref > -1e29
    err = (out - ref)[live].abs().max().item() / ref[live].abs().max().item()
    assert err <= RTOL, err
    assert bool((out[~live] == fused_scan.NEG_INF).all())
    assert int(live[0].sum()) == -(-n_valid // fused_scan.SEG)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n_valid", [(1, 100, 3 * 2048 - 77), (64, 100, 3 * 2048 - 77), (3, 700, 500)])
def test_flat_topk_fused_matches_the_plain_route_on_cuda(cuda_device, b, k, n_valid):
    """K11 + K4 against the same function on the CPU; k > n_valid pads."""
    db, q = _scan_case(9, n_pad=3 * fused_scan.BLOCK, d=768, b=b)
    dbd = T(db).to(cuda_device, torch.bfloat16)
    k4 = gather_score_tiles.launches
    s, i = fused_scan.flat_topk_fused(T(q).to(cuda_device), dbd, n_valid, k)
    torch.cuda.synchronize()
    assert gather_score_tiles.launches == k4 + 1
    s_ref, i_ref = fused_scan.flat_topk_fused(T(q), dbd.cpu(), n_valid, k)
    real = min(k, n_valid)
    tol = RTOL * s_ref[:, 0].abs().max().item()
    np.testing.assert_allclose(s.cpu().numpy(), s_ref.numpy(), rtol=0, atol=tol)
    for row in range(b):  # equal sets apart from ties at the cut
        score_of = dict(zip(i_ref[row].tolist(), s_ref[row].tolist()))
        score_of.update(zip(i[row].tolist(), s[row].tolist()))
        diff = set(i[row, :real].tolist()) ^ set(i_ref[row, :real].tolist())
        assert all(abs(score_of[j] - s_ref[row, real - 1].item()) <= 2 * tol for j in diff), diff
    assert (i[:, real:] == -1).all()


@pytest.mark.cuda
def test_sq8_flat_scan_on_cuda_matches_the_cpu(cuda_device):
    """torch._int_mm on the card against the CPU scan, the same int8 rows."""
    rng = np.random.RandomState(10)
    rows, scales = quantize_rows_sq8(rng.randn(4096, 768).astype(np.float16))
    q = rng.randn(5, 768).astype(np.float32)
    s, i = chunked_topk_scores(T(q).to(cuda_device), T(rows).to(cuda_device), 4000, 10, 1024,
                               row_scales=T(scales).to(cuda_device))
    s_ref, i_ref = chunked_topk_scores(T(q), T(rows), 4000, 10, 1024, row_scales=T(scales))
    np.testing.assert_array_equal(i.cpu().numpy(), i_ref.numpy())
    np.testing.assert_allclose(s.cpu().numpy(), s_ref.numpy(), rtol=1e-6)
