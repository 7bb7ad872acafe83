"""Port parity: exact top-k (ops/topk.py) and the Flat index (index/flat.py).

The same numpy datastores and queries go through the JAX package and the
port; ids must agree apart from ties (random floats have none here).
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_scaling_tpu.index.flat import FlatIndex as JaxFlatIndex
from retrieval_scaling_tpu.ops import topk as jtopk
from retrieval_scaling_tpu_torch.index.flat import FlatIndex, filter_pad_hits
from retrieval_scaling_tpu_torch.ops import topk

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("chunk,k", [(128, 5), (1 << 20, 5), (256, 700), (128, 1000)])
def test_chunked_topk_matches_jax(chunk, k):
    rng = np.random.RandomState(0)
    db = rng.randn(768, 16).astype(np.float32)
    q = rng.randn(4, 16).astype(np.float32)
    n_valid = 700
    ref_s, ref_i = jtopk.chunked_topk_scores(jnp.asarray(q), jnp.asarray(db), n_valid, k, chunk_size=chunk)
    s, i = topk.chunked_topk_scores(torch.from_numpy(q), torch.from_numpy(db), n_valid, k, chunk_size=chunk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-5, atol=1e-5)
    assert (i.numpy() < n_valid).all()


def test_merge_topk_and_pick_chunk_size_match_jax():
    rng = np.random.RandomState(1)
    sa, sb = rng.randn(3, 6).astype(np.float32), rng.randn(3, 4).astype(np.float32)
    ia, ib = rng.randint(0, 100, (3, 6)), rng.randint(100, 200, (3, 4))
    ref_s, ref_i = jtopk.merge_topk(jnp.asarray(sa), jnp.asarray(ia), jnp.asarray(sb), jnp.asarray(ib), 5)
    s, i = topk.merge_topk(*(torch.from_numpy(x) for x in (sa, ia, sb, ib)), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    for n, b in ((10, 1), (1 << 20, 64), (5000, 3), (1 << 24, 1)):
        assert topk.pick_chunk_size(n, b) == jtopk.pick_chunk_size(n, b)


def _datastore(tmp_path, num_shards=2, per_shard=150, dim=32):
    rng = np.random.RandomState(0)
    emb_dir, psg_dir = tmp_path / "embeddings", tmp_path / "passages"
    emb_dir.mkdir()
    psg_dir.mkdir()
    for shard in range(num_shards):
        with open(emb_dir / f"passages_{shard:02d}.pkl", "wb") as f:
            pickle.dump((list(range(per_shard)), rng.randn(per_shard, dim).astype(np.float16)), f)
        with open(psg_dir / f"raw_passages-{shard}-of-{num_shards}.jsonl", "w") as f:
            for i in range(per_shard):
                f.write(json.dumps({"text": f"passage-{shard}-{i}", "id": i}) + "\n")
    paths = [str(emb_dir / f"passages_{s:02d}.pkl") for s in range(num_shards)]
    return paths, str(psg_dir)


def test_flat_index_reads_and_writes_the_jax_artifacts(tmp_path):
    paths, psg_dir = _datastore(tmp_path)
    jax_files = dict(index_path=str(tmp_path / "jax" / "index_Flat.tpu.npz"),
                     meta_file=str(tmp_path / "jax" / "index_Flat.tpu.ids.npy"))
    port_files = dict(index_path=str(tmp_path / "port" / "index_Flat.tpu.npz"),
                      meta_file=str(tmp_path / "port" / "index_Flat.tpu.ids.npy"))
    jax_index = JaxFlatIndex(embed_paths=paths, passage_dir=psg_dir, dimension=32, **jax_files)
    built = FlatIndex(CPU, embed_paths=paths, dimension=32, **port_files)
    # the port writes the same files the JAX package writes ...
    np.testing.assert_array_equal(
        np.load(port_files["index_path"])["embeddings"], np.load(jax_files["index_path"])["embeddings"]
    )
    np.testing.assert_array_equal(np.load(port_files["meta_file"]), np.load(jax_files["meta_file"]))
    # ... and loads the JAX-written ones (no embed_paths needed)
    loaded = FlatIndex(CPU, passage_dir=psg_dir, dimension=32, **jax_files)

    q = np.random.RandomState(2).randn(5, 32).astype(np.float16)
    ref_s, ref_i = jax_index.search_ids(q, 10)
    for index in (built, loaded):
        s, i = index.search_ids(q, 10)
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(s, ref_s, rtol=1e-5, atol=1e-5)
    ref = jax_index.search(q, 4)
    got = loaded.search(q, 4)
    assert got[1] == ref[1] and got[2] == ref[2]
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)


def test_flat_index_k_beyond_datastore_pads_then_filters(tmp_path):
    paths, psg_dir = _datastore(tmp_path, num_shards=1, per_shard=6)
    index = FlatIndex(CPU, embed_paths=paths, passage_dir=psg_dir, dimension=32)
    q = np.random.RandomState(3).randn(2, 32).astype(np.float16)
    s, i = topk.chunked_topk_scores(
        torch.from_numpy(q.astype(np.float32)), index.embeddings.float(), index.n_valid, 9
    )
    assert (i[:, 6:] == -1).all() and (i[:, :6] >= 0).all()
    scores, ids = filter_pad_hits(s.numpy(), i.numpy())
    assert all(len(r) == 6 for r in ids) and all(len(r) == 6 for r in scores)
    _, passages, db_ids = index.search(q, 9)
    assert all(len(p) == 6 for p in passages) and all(len(d) == 6 for d in db_ids)
