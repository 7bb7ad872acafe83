"""Port parity: IVF-Flat and IVF-PQ (ops/kmeans.py, index/ivf_common.py,
ops/ivf_gather.py, index/ivf_flat.py, index/ivf_pq.py, data/native_io.py).

The same numpy inputs, made from a seed, go through the JAX package and the
port on the CPU. Tolerances: f32 sums taken in another order agree to 1e-5
relative (scores, sums, objectives); ids and assignments agree exactly
(random floats have no ties here). The JAX Pallas kernels run in interpret
mode, as tests/test_ivf.py runs them. The CUDA kernels run only on the card:
those tests carry the ``cuda`` marker and skip here.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_scaling_tpu.index import ivf_common as jcommon
from retrieval_scaling_tpu.index.ivf_flat import IVFFlatIndex as JaxIVFFlat
from retrieval_scaling_tpu.index.ivf_pq import IVFPQIndex as JaxIVFPQ
from retrieval_scaling_tpu.index.ivf_pq import pq_scan_topk as jax_pq_scan_topk
from retrieval_scaling_tpu.ops import ivf_gather as jgather
from retrieval_scaling_tpu.ops import kmeans as jkmeans
from retrieval_scaling_tpu_torch.index import ivf_common
from retrieval_scaling_tpu_torch.index.flat import quantize_rows_sq8
from retrieval_scaling_tpu_torch.index.ivf_flat import IVFFlatIndex
from retrieval_scaling_tpu_torch.index.ivf_pq import IVFPQIndex, pq_scan_topk
from retrieval_scaling_tpu_torch.ops import ivf_gather, kmeans

torch.set_num_threads(1)
CPU = torch.device("cpu")
RTOL = 1e-5
T = torch.from_numpy


def _clustered(rng, n, d, c, spread=0.2):
    centers = rng.randn(c, d).astype(np.float32)
    labels = rng.randint(0, c, n)
    return centers[labels] + spread * rng.randn(n, d).astype(np.float32), centers


# ---------------------------------------------------------------- ops/kmeans.py
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_assign_clusters_matches_jax(metric):
    rng = np.random.RandomState(0)
    data, cents = rng.randn(700, 16).astype(np.float32), rng.randn(9, 16).astype(np.float32)
    ref = np.asarray(jkmeans.assign_clusters(jnp.asarray(data), jnp.asarray(cents), 9, chunk_size=256, metric=metric))
    got = kmeans.assign_clusters(T(data), T(cents), 9, chunk_size=256, metric=metric).numpy()
    np.testing.assert_array_equal(got, ref)


def test_lloyd_iteration_matches_jax():
    rng = np.random.RandomState(1)
    data, cents = rng.randn(700, 16).astype(np.float32), rng.randn(12, 16).astype(np.float32)
    ref = [np.asarray(x) for x in jkmeans._lloyd_iteration(jnp.asarray(data), jnp.asarray(cents), 12, 256)]
    got = [x.numpy() for x in kmeans._lloyd_iteration(T(data), T(cents), 12, 256)]
    np.testing.assert_array_equal(got[1], ref[1])  # counts
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], rtol=RTOL)


def test_pq_encode_decode_match_jax():
    rng = np.random.RandomState(2)
    data, books = rng.randn(300, 32).astype(np.float32), rng.randn(4, 64, 8).astype(np.float32)
    ref = np.asarray(jkmeans.pq_encode(jnp.asarray(data), jnp.asarray(books), chunk_size=128))
    got = kmeans.pq_encode(T(data), T(books), chunk_size=128)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        kmeans.pq_decode(got, T(books)).numpy(), np.asarray(jkmeans.pq_decode(jnp.asarray(ref), jnp.asarray(books)))
    )


def test_opq_eig_init_matches_jax():
    rng = np.random.RandomState(3)
    data = (rng.randn(500, 16) * np.linspace(3, 0.1, 16)).astype(np.float32)
    ref = jkmeans.opq_eig_init(data, 4)
    got = kmeans.opq_eig_init(T(data), 4).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got.T @ got, np.eye(16), atol=1e-5)


def test_kmeans_objective_decreases_and_recovers_clusters():
    data, centers = _clustered(np.random.RandomState(4), 2000, 32, 16, spread=0.15)
    centroids, history = kmeans.kmeans(T(data), 16, iters=15, seed=0)
    assert history[-1] <= history[0]
    d2 = ((centroids.numpy()[None] - centers[:, None]) ** 2).sum(-1)
    assert np.median(d2.min(axis=1)) < 0.5
    # more clusters than points: empty clusters reseed from the largest
    few, _ = kmeans.kmeans(T(data[:40]), 32, iters=5, seed=0)
    assert torch.isfinite(few).all()


def test_opq_train_lowers_pq_error():
    data, _ = _clustered(np.random.RandomState(5), 1000, 16, 8)
    data = data @ np.linalg.qr(np.random.RandomState(6).randn(16, 16))[0].astype(np.float32)
    x = T(data)
    r, books = kmeans.opq_train(x, 4, n_bits=4, opq_iters=3, pq_iters=5, init="auto")
    np.testing.assert_allclose((r.T @ r).numpy(), np.eye(16), atol=1e-4)
    z = x @ r
    err_opq = float(((kmeans.pq_decode(kmeans.pq_encode(z, books), books) - z) ** 2).mean())
    plain = kmeans.pq_train_codebooks(x, 4, n_bits=4, iters=5)
    err_pq = float(((kmeans.pq_decode(kmeans.pq_encode(x, plain), plain) - x) ** 2).mean())
    assert err_opq <= err_pq * 1.05, (err_opq, err_pq)


# ---------------------------------------------------------------- index/ivf_common.py
@pytest.mark.parametrize("nlist,payload", [(7, "rows"), (12, "codes")])
def test_build_list_layout_matches_jax(nlist, payload):
    rng = np.random.RandomState(7)
    n = 600
    data = rng.randn(n, 8).astype(np.float32) if payload == "rows" else rng.randint(0, 256, (n, 8)).astype(np.uint8)
    assign = rng.randint(0, nlist - 2, n)  # the last two lists stay empty
    assign[:150] = 0                       # a list longer than one tile
    ref, got = jcommon.build_list_layout(data, assign, nlist), ivf_common.build_list_layout(data, assign, nlist)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ivf_common.default_max_tiles(got.list_len, 3) == jcommon.default_max_tiles(ref.list_len, 3)


@pytest.mark.parametrize("nprobe,max_tiles", [(3, 8), (6, 5), (20, 40)])
def test_select_probes_and_schedule_match_jax(nprobe, max_tiles):
    rng = np.random.RandomState(8)
    q, cents = rng.randn(5, 16).astype(np.float32), rng.randn(10, 16).astype(np.float32)
    counts = rng.randint(0, 4, 10).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    jc, jp = jcommon.select_probes(jnp.asarray(q), jnp.asarray(cents), nprobe)
    pc, pp = ivf_common.select_probes(T(q), T(cents), nprobe)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=RTOL, atol=1e-5)
    ref = jcommon.probe_tile_schedule(jp, jnp.asarray(starts), jnp.asarray(counts), max_tiles)
    got = ivf_common.probe_tile_schedule(pp, T(starts), T(counts), max_tiles)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------- ops/ivf_gather.py
def _tiles_case(seed, dtype):
    rng = np.random.RandomState(seed)
    b, t, t_total, d = 3, 8, 6, 32
    q = rng.randn(b, d).astype(np.float32)
    rows = rng.randn(t_total * 128, d).astype(np.float32)
    scales = None
    if dtype == "int8":
        rows, scales = quantize_rows_sq8(rows)
    tiles = rows.reshape(t_total, 128, d)
    ids = rng.randint(0, t_total, (b, t)).astype(np.int32)
    ids[0, 0] = 0  # a slot pointing at tile 0
    return q, tiles, ids, scales


@pytest.mark.parametrize("grouped,dtype", [(False, "bf16"), (False, "int8"), (False, "f32"), (True, "f32"), (True, "bf16")])
def test_score_tiles_plain_matches_jax_pallas(grouped, dtype):
    """K4 / K12's plain versions against the Pallas kernels in interpret mode."""
    q, tiles, ids, _ = _tiles_case(9, dtype)
    jdt = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32}[dtype]
    tdt = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}[dtype]
    jfn = jgather.gather_score_tiles_grouped if grouped else jgather.gather_score_tiles
    ref = np.asarray(jfn(jnp.asarray(q), jnp.asarray(tiles, jdt), jnp.asarray(ids), interpret=True))
    pfn = ivf_gather.gather_score_tiles_grouped if grouped else ivf_gather.gather_score_tiles
    got = pfn(T(q), T(tiles).to(tdt), T(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _adc_case(seed, m=8, ksub=256):
    rng = np.random.RandomState(seed)
    b, t, t_total = 3, 8, 6
    lut = rng.randn(b, m, ksub).astype(np.float32)
    codes = rng.randint(0, ksub, (t_total, 128, m)).astype(np.uint8)
    ids = rng.randint(0, t_total, (b, t)).astype(np.int32)
    ids[0, 0] = 0
    return lut, codes, ids


@pytest.mark.parametrize("grouped", [False, True])
def test_adc_tiles_plain_matches_jax_pallas(grouped):
    """K5a / K5b's plain versions against the Pallas kernels in interpret mode
    (the JAX kernels read the transposed code layout; the port the row one)."""
    lut, codes, ids = _adc_case(10)
    jfn = jgather.gather_adc_tiles_grouped if grouped else jgather.gather_adc_tiles
    codes_t = jnp.asarray(jgather.transpose_code_tiles(codes, codes.shape[2]))
    ref = np.asarray(jfn(jnp.asarray(lut), codes_t, jnp.asarray(ids), interpret=True))
    pfn = ivf_gather.gather_adc_tiles_grouped if grouped else ivf_gather.gather_adc_tiles
    got = pfn(T(lut), T(codes), T(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _schedule_case(seed, n=900, d=32, nlist=9):
    rng = np.random.RandomState(seed)
    data = rng.randn(n, d).astype(np.float32)
    assign = rng.randint(0, nlist, n)
    assign[:20] = nlist - 1  # nothing else lands in the last list: shorter than one tile
    assign[20:] = np.where(assign[20:] == nlist - 1, 0, assign[20:])
    layout = jcommon.build_list_layout(data, assign, nlist)
    q = rng.randn(4, d).astype(np.float32)
    probe_ids = np.stack([rng.permutation(nlist)[:4] for _ in range(4)]).astype(np.int32)
    probe_ids[0, 0] = nlist - 1
    jt, jv, jp = jcommon.probe_tile_schedule(
        jnp.asarray(probe_ids), jnp.asarray(layout.tile_start), jnp.asarray(layout.tile_count), 9
    )
    return rng, layout, q, probe_ids, np.asarray(jt), np.asarray(jv), np.asarray(jp)


@pytest.mark.parametrize("grouped,sq8", [(False, False), (True, False), (False, True)])
def test_ivf_scan_wrapper_matches_plain_scans(grouped, sq8):
    """``ivf_scan_topk_tiles`` (the K4/K12 route) against the port's plain
    ``ivf_scan_topk`` and the JAX ``ivf_scan_topk``, at k beyond the probed rows."""
    _, layout, q, _, tile_ids, valid, _ = _schedule_case(11)
    d = q.shape[1]
    rows, scales = layout.sorted_rows, None
    if sq8:
        rows, scales = quantize_rows_sq8(rows)
        scales = scales.reshape(-1, 128)
    tiles = rows.reshape(-1, 128, d)
    jscales = None if scales is None else jnp.asarray(scales)
    for k in (10, 900):
        ref_s, ref_i = jcommon.ivf_scan_topk(
            jnp.asarray(q), jnp.asarray(tiles), jnp.asarray(layout.row_flat_ids, jnp.int32),
            jnp.asarray(tile_ids), jnp.asarray(valid), k, tile_row_scales=jscales,
        )
        args = (T(q), T(tiles), T(layout.row_flat_ids), T(tile_ids), T(valid), k)
        pscales = None if scales is None else T(scales)
        for s, i in (ivf_gather.ivf_scan_topk_tiles(*args, grouped=grouped, tile_row_scales=pscales),
                     ivf_common.ivf_scan_topk(*args, tile_row_scales=pscales)):
            np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
            np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("grouped", [False, True])
def test_pq_scan_wrapper_matches_plain_scans(grouped):
    """``pq_scan_topk_tiles`` (the K5a/K5b route) against the port's plain
    ``pq_scan_topk`` and the JAX ``pq_scan_topk`` (gather ADC)."""
    rng, layout, _, probe_ids, tile_ids, valid, probe_of = _schedule_case(12)
    m, ksub = 8, 64
    codes = rng.randint(0, ksub, (len(layout.row_flat_ids), m)).astype(np.uint8).reshape(-1, 128, m)
    lut = rng.randn(4, m, ksub).astype(np.float32)
    coarse = rng.randn(4, probe_ids.shape[1]).astype(np.float32)
    for k in (10, 900):
        ref_s, ref_i = jax_pq_scan_topk(
            jnp.asarray(lut), jnp.asarray(coarse), jnp.asarray(codes), jnp.asarray(layout.row_flat_ids, jnp.int32),
            jnp.asarray(tile_ids), jnp.asarray(valid), jnp.asarray(probe_of), k,
        )
        args = (T(lut), T(coarse), T(codes), T(layout.row_flat_ids), T(tile_ids), T(valid), T(probe_of), k)
        for s, i in (ivf_gather.pq_scan_topk_tiles(*args, grouped=grouped), pq_scan_topk(*args)):
            np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
            np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=RTOL, atol=1e-5)


# ---------------------------------------------------------------- the indexes
N_PER, DIM, NLIST = 500, 32, 16


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("ivf_shards")
    data, _ = _clustered(np.random.RandomState(13), 2 * N_PER, DIM, NLIST)
    paths = []
    for shard in range(2):
        path = root / f"passages_{shard:02d}.pkl"
        with open(path, "wb") as f:
            pickle.dump((list(range(N_PER)), data[shard * N_PER : (shard + 1) * N_PER].astype(np.float16)), f)
        paths.append(str(path))
    queries = data[np.random.RandomState(14).randint(0, len(data), 12)] + 0.02
    return root, paths, data, queries.astype(np.float32)


def _files(root, name):
    d = root / name
    return dict(
        index_path=str(d / "index.npz"), meta_file=str(d / "index.ids.npy"),
        trained_index_path=str(d / "index.trained.npz"),
    )


FLAT_KW = dict(dimension=DIM, sample_train_size=800, ncentroids=NLIST, probe=6, kmeans_iters=8)
PQ_KW = dict(FLAT_KW, n_subquantizers=8, n_bits=6, refine_factor=4, opq=True, pq_iters=6)
LAYOUT_KEYS = ("row_flat_ids", "tile_start", "tile_count", "list_len", "n_valid")


# kind -> (JAX class, port class, JAX kwargs, port kwargs); the SQ8 kinds
# are IVF-Flat with int8 tiles (configs/ivf_flat.yaml, configs/serving.yaml)
# over rows assigned in bf16 or f32
KINDS = {
    "flat": (JaxIVFFlat, IVFFlatIndex, dict(FLAT_KW, dtype=jnp.float32), dict(FLAT_KW, dtype=torch.float32)),
    "pq": (JaxIVFPQ, IVFPQIndex, PQ_KW, PQ_KW),
    "flat_sq8_bf16": (JaxIVFFlat, IVFFlatIndex, dict(FLAT_KW, quantization="int8"),
                      dict(FLAT_KW, quantization="int8")),
    "flat_sq8_f32": (JaxIVFFlat, IVFFlatIndex, dict(FLAT_KW, quantization="int8", dtype=jnp.float32),
                     dict(FLAT_KW, quantization="int8", dtype=torch.float32)),
}


@pytest.fixture(scope="module")
def built(shards):
    """Each index kind built once by each package, from the same shards, at
    first use."""
    root, paths, _, _ = shards
    out = {}

    def get(kind):
        if kind not in out:
            jcls, pcls, jkw, pkw = KINDS[kind]
            jax_built = jcls(embed_paths=paths, **_files(root, f"jax_{kind}"), **jkw)
            port_built = pcls(CPU, embed_paths=paths, **_files(root, f"port_{kind}"), **pkw)
            out[kind] = (jcls, pcls, jkw, pkw, jax_built, port_built)
        return out[kind]

    return get


@pytest.mark.parametrize("kind", ["flat", "pq", "flat_sq8_bf16", "flat_sq8_f32"])
def test_index_files_load_across_packages(shards, built, kind):
    """Files written by either package load in the other and give the same ids."""
    root, _, _, queries = shards
    jcls, pcls, jkw, pkw, jax_built, port_built = built(kind)
    port_loads_jax = pcls(CPU, **_files(root, f"jax_{kind}"), **pkw)
    jax_loads_port = jcls(**_files(root, f"port_{kind}"), **jkw)
    for writer, reader in ((jax_built, port_loads_jax), (port_built, jax_loads_port)):
        ref_s, ref_i = writer.search_ids(queries, 10)
        s, i = reader.search_ids(queries, 10)
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(s, ref_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_build_from_jax_trained_file_is_byte_equal(shards, built, kind, tmp_path):
    """Given the JAX package's ``.trained.npz``, the port lays out the same
    rows (or PQ codes) in the same lists."""
    root, paths, _, _ = shards
    _, pcls, _, pkw, _, _ = built(kind)
    files = _files(tmp_path, "from_jax")
    (tmp_path / "from_jax").mkdir()
    trained = _files(root, f"jax_{kind}")["trained_index_path"]
    with open(trained, "rb") as src, open(files["trained_index_path"], "wb") as dst:
        dst.write(src.read())
    pcls(CPU, embed_paths=paths, **files, **pkw)
    ours, theirs = np.load(files["index_path"]), np.load(_files(root, f"jax_{kind}")["index_path"])
    payload = ("sorted_rows",) if kind == "flat" else ("codes", "refine_rows_i8", "refine_scales", "opq_rotation")
    for key in LAYOUT_KEYS + payload:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    np.testing.assert_array_equal(np.load(files["meta_file"]), np.load(_files(root, f"jax_{kind}")["meta_file"]))


def test_ivf_flat_recall_and_sq8(shards, built):
    _, _, data, queries = shards
    port = built("flat")[5]
    exact = queries @ data.astype(np.float16).astype(np.float32).T
    _, ids = port.search_ids(queries, 10, nprobe=NLIST)  # every list: exact
    for b in range(len(queries)):
        assert ids[b].tolist() == np.argsort(-exact[b])[:10].tolist()
    _, ids = port.search_ids(queries, 10)
    recall = np.mean([len(set(ids[b]) & set(np.argsort(-exact[b])[:10])) / 10 for b in range(len(queries))])
    assert recall >= 0.85, recall


def test_pq_refine_host_equals_device(shards, built):
    root, _, data, queries = shards
    _, pcls, _, pkw, _, port = built("pq")
    host = pcls(CPU, **_files(root, "port_pq"), **dict(pkw, refine_mode="host"))
    assert host.refine_row_file is not None and host.refine_rows_dev is None
    s_dev, i_dev = port.search_ids(queries, 10)
    s_host, i_host = host.search_ids(queries, 10)
    np.testing.assert_array_equal(i_host, i_dev)
    np.testing.assert_allclose(s_host, s_dev, rtol=1e-5, atol=1e-5)
    exact = queries @ data.T
    recall = np.mean([len(set(i_dev[b]) & set(np.argsort(-exact[b])[:10])) / 10 for b in range(len(queries))])
    assert recall >= 0.59, recall


def test_indexer_raises_for_what_waits(tmp_path):
    from retrieval_scaling_tpu_torch.config import load_config
    from retrieval_scaling_tpu_torch.index.base import Indexer

    base = ["datastore.domain=d", "evaluation.domain=e", "evaluation.data.eval_data=e.jsonl",
            "evaluation.results_only_log_file=r.log", f"datastore.datastore_root_dir={tmp_path}"]
    for overrides, err in (
        (["datastore.index.index_type=IVFPQ", "datastore.index.pq_aniso=true"], NotImplementedError),
        (["datastore.index.index_type=IVFPQ", "datastore.index.quantization=int8"], ValueError),
        (["datastore.index.index_type=HNSW"], NotImplementedError),
    ):
        with pytest.raises(err):
            Indexer(load_config("default", overrides=base + overrides), CPU)


# ---------------------------------------------------------------- the kernels on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the IVF kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("K4", torch.bfloat16), ("K4", torch.int8), ("K4", torch.float32), ("K12", torch.bfloat16), ("K12", torch.int8),
])
def test_score_kernels_match_plain_on_cuda(cuda_device, kernel, dtype):
    _, layout, q, _, tile_ids, valid, _ = _schedule_case(15, d=256)
    rows = layout.sorted_rows if dtype != torch.int8 else quantize_rows_sq8(layout.sorted_rows)[0]
    tiles = T(rows.reshape(-1, 128, q.shape[1])).to(cuda_device).to(dtype)
    t = tile_ids.shape[1] - tile_ids.shape[1] % 4 if kernel == "K12" else tile_ids.shape[1]
    safe = T(np.where(valid, tile_ids, 0)[:, :t].astype(np.int32)).to(cuda_device).contiguous()
    qd = T(q).to(cuda_device)
    fn = ivf_gather.gather_score_tiles_grouped if kernel == "K12" else ivf_gather.gather_score_tiles
    launches = fn.launches
    out = fn(qd, tiles, safe)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    q_ref = qd.float() if kernel == "K12" or dtype == torch.int8 else qd.to(dtype).float()
    ref = ivf_gather.gather_score_tiles_reference(q_ref, tiles, safe)
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,ksub", [("K5a", 16, 256), ("K5b", 16, 256), ("K5a", 8, 64), ("K5b", 32, 256)])
def test_adc_kernels_match_plain_on_cuda(cuda_device, kernel, m, ksub):
    rng, layout, _, _, tile_ids, valid, _ = _schedule_case(16)
    codes = T(rng.randint(0, ksub, (len(layout.row_flat_ids), m)).astype(np.uint8).reshape(-1, 128, m)).to(cuda_device)
    lut = T(rng.randn(4, m, ksub).astype(np.float32)).to(cuda_device)
    t = tile_ids.shape[1] - tile_ids.shape[1] % 8 if kernel == "K5b" else tile_ids.shape[1]
    safe = T(np.where(valid, tile_ids, 0)[:, :t].astype(np.int32)).to(cuda_device).contiguous()
    fn = ivf_gather.gather_adc_tiles_grouped if kernel == "K5b" else ivf_gather.gather_adc_tiles
    out = fn(lut, codes, safe)
    torch.cuda.synchronize()
    ref = ivf_gather.gather_adc_tiles_reference(lut, codes, safe)
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    assert err <= 1e-5, err


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
def test_scan_wrappers_match_plain_scans_on_cuda(cuda_device, grouped):
    """The masked top-k around the kernels on the card, against the plain
    scans, with pad slots mapped to tile 0 and a list shorter than a tile."""
    rng, layout, q, probe_ids, tile_ids, valid, probe_of = _schedule_case(17)
    dev = cuda_device
    tiles = T(layout.sorted_rows.reshape(-1, 128, q.shape[1])).to(dev).to(torch.bfloat16)
    # K12 keeps the query in f32 where K4 and the plain scan round it to the
    # tiles' type: a query that is bf16 already is the same to all three
    q_bf16 = T(q).to(torch.bfloat16).float()
    args = (q_bf16.to(dev), tiles, T(layout.row_flat_ids).to(dev), T(tile_ids).to(dev), T(valid).to(dev), 50)
    _, i = ivf_gather.ivf_scan_topk_tiles(*args, grouped=grouped)
    _, ref_i = ivf_common.ivf_scan_topk(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    np.testing.assert_array_equal(np.sort(i.cpu().numpy(), 1), np.sort(ref_i.numpy(), 1))
    m, ksub = 16, 256
    codes = T(rng.randint(0, ksub, (len(layout.row_flat_ids), m)).astype(np.uint8).reshape(-1, 128, m))
    lut, coarse = rng.randn(4, m, ksub).astype(np.float32), rng.randn(4, probe_ids.shape[1]).astype(np.float32)
    pargs = (T(lut), T(coarse), codes, T(layout.row_flat_ids), T(tile_ids), T(valid), T(probe_of), 50)
    _, i = ivf_gather.pq_scan_topk_tiles(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in pargs),
                                         grouped=grouped)
    _, ref_i = pq_scan_topk(*pargs)
    np.testing.assert_array_equal(np.sort(i.cpu().numpy(), 1), np.sort(ref_i.numpy(), 1))
