"""K-means, PQ and OPQ training on one device: the FAISS ``Clustering`` replacement.

Ports ``retrieval_scaling_tpu/ops/kmeans.py`` (``assign_clusters``,
``_lloyd_iteration``, ``kmeans``, ``pq_train_codebooks``, ``pq_encode``,
``pq_decode``, ``opq_eig_init``, ``opq_train``). The JAX package leaves these
to XLA matmuls, so here they are plain torch on the data's device, with every
product in full f32. That is PyTorch's default (``float32_matmul_precision``
"highest", TF32 off); a caller must not turn TF32 on, since its three digits
move near-tied assignments. Where the port differs from the JAX module:

* the centroid update adds each row into its cluster with ``index_add_``, the
  same sum as the one-hot matmul;
* the random draws (the init sample and the reseed noise of empty clusters)
  come from a ``torch.Generator`` seeded with ``seed``: not JAX's numbers;
* OPQ's products ``x @ R`` and its Procrustes SVD run on the device, where the
  JAX module runs them in host numpy.

The anisotropic codebooks (``aniso_*``) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _as_tensor(data) -> torch.Tensor:
    return data if isinstance(data, torch.Tensor) else torch.from_numpy(np.asarray(data))


def _chunks(n: int, chunk_size: int):
    for start in range(0, n, chunk_size):
        yield start, min(start + chunk_size, n)


def assign_clusters(data, centroids, k: int, chunk_size: int = 65536, metric: str = "l2") -> torch.Tensor:
    """Nearest-centroid id per row ([N] int64), in f32, streamed in chunks.
    ``metric="ip"`` takes the largest inner product."""
    data, centroids = _as_tensor(data), _as_tensor(centroids).float()
    if centroids.shape[0] != k:
        raise ValueError(f"{centroids.shape[0]} centroids for k={k}")
    c_norms = (centroids**2).sum(-1)
    out = torch.empty(data.shape[0], dtype=torch.int64, device=data.device)
    for lo, hi in _chunks(data.shape[0], chunk_size):
        ip = data[lo:hi].float() @ centroids.T
        score = 2.0 * ip - c_norms[None, :] if metric == "l2" else ip
        out[lo:hi] = score.argmax(-1)
    return out


def _lloyd_iteration(data: torch.Tensor, centroids: torch.Tensor, k: int, chunk_size: int):
    """One Lloyd step: (sums [k, D], counts [k], objective) in f32."""
    d = data.shape[1]
    c_norms = (centroids**2).sum(-1)
    sums = torch.zeros((k, d), dtype=torch.float32, device=data.device)
    counts = torch.zeros(k, dtype=torch.float32, device=data.device)
    obj = torch.zeros((), dtype=torch.float32, device=data.device)
    for lo, hi in _chunks(data.shape[0], chunk_size):
        x = data[lo:hi].float()
        dist = c_norms[None, :] - 2.0 * (x @ centroids.T)  # + ||x||^2 (constant per row)
        best = dist.argmin(-1)
        sums.index_add_(0, best, x)
        counts.index_add_(0, best, torch.ones_like(best, dtype=torch.float32))  # bincount would sync
        obj += (dist.gather(1, best[:, None])[:, 0] + (x**2).sum(-1)).sum()
    return sums, counts, obj


def kmeans(
    data,
    k: int,
    iters: int = 20,
    seed: int = 1,
    chunk_size: int = 65536,
    spherical: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train k-means on ``data``'s device. Returns (centroids [k, D] f32,
    objective history [iters]). Empty clusters take a perturbed copy of the
    largest cluster's centroid (FAISS's policy)."""
    data = _as_tensor(data)
    n, d = data.shape
    gen = torch.Generator(device=data.device).manual_seed(seed)
    init_idx = torch.randperm(n, generator=gen, device=data.device)[: min(k, n)]
    centroids = data[init_idx].float()
    if k > n:  # degenerate: duplicate
        centroids = torch.cat([centroids, centroids[: k - n]], dim=0)

    history = []
    for _ in range(iters):
        sums, counts, obj = _lloyd_iteration(data, centroids, k, chunk_size)
        history.append(obj)
        new_centroids = sums / counts.clamp_min(1.0)[:, None]
        empty = counts < 0.5
        n_empty = int(empty.sum())
        if n_empty:
            donor = new_centroids[counts.argmax()]
            noise = 1e-4 * torch.randn((n_empty, d), generator=gen, device=data.device)
            new_centroids[empty] = donor[None, :] * (1.0 + noise)
        if spherical:
            new_centroids = new_centroids / new_centroids.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        centroids = new_centroids
    return centroids, torch.stack(history)


def pq_train_codebooks(data, n_subquantizers: int, n_bits: int = 8, iters: int = 20, seed: int = 1) -> torch.Tensor:
    """PQ codebooks [m, 2^bits, D/m]: an independent k-means per subspace."""
    data = _as_tensor(data)
    n, d = data.shape
    m = n_subquantizers
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    dsub = d // m
    books = [
        kmeans(data[:, j * dsub : (j + 1) * dsub].contiguous(), 1 << n_bits, iters=iters, seed=seed + j)[0]
        for j in range(m)
    ]
    return torch.stack(books)


def pq_encode(data, codebooks, chunk_size: int = 65536) -> torch.Tensor:
    """uint8 codes [N, m]: the nearest codeword of each subspace."""
    data, books = _as_tensor(data), _as_tensor(codebooks).float()
    m, ksub, dsub = books.shape
    cb_norms = (books**2).sum(-1)  # [m, ksub]
    out = torch.empty((data.shape[0], m), dtype=torch.uint8, device=data.device)
    for lo, hi in _chunks(data.shape[0], chunk_size):
        x = data[lo:hi].float().reshape(hi - lo, m, dsub)
        dist = cb_norms[None] - 2.0 * torch.einsum("cmd,mkd->cmk", x, books)
        out[lo:hi] = dist.argmin(-1).to(torch.uint8)
    return out


def pq_decode(codes, codebooks) -> torch.Tensor:
    """Rows [N, D] rebuilt from their codes."""
    codes, books = _as_tensor(codes), _as_tensor(codebooks)
    return torch.cat([books[j][codes[:, j].long()] for j in range(books.shape[0])], dim=-1)


def _covariance_f64(x: torch.Tensor, chunk_size: int = 65536) -> torch.Tensor:
    """``np.cov(x, rowvar=False)`` in f64 on x's device, two passes over chunks."""
    n, d = x.shape
    mean = torch.zeros(d, dtype=torch.float64, device=x.device)
    for lo, hi in _chunks(n, chunk_size):
        mean += x[lo:hi].double().sum(0)
    mean /= n
    cov = torch.zeros((d, d), dtype=torch.float64, device=x.device)
    for lo, hi in _chunks(n, chunk_size):
        xc = x[lo:hi].double() - mean
        cov += xc.T @ xc
    return cov / (n - 1)


def opq_eig_init(data, n_subquantizers: int) -> torch.Tensor:
    """Eigenvalue-allocation OPQ init (Ge et al.'s parametric OPQ): the
    covariance's eigenvectors, in descending eigenvalue order, each given to
    the subspace with the smallest log-eigenvalue sum that has a free slot.
    Returns an orthogonal R [D, D] f32 on data's device. The covariance is
    taken on the device; the [D, D] eigendecomposition runs in host numpy,
    as in the JAX module, so both packages pick the same eigenvector signs."""
    x = _as_tensor(data)
    d = x.shape[1]
    m = n_subquantizers
    dsub = d // m
    evals, evecs = np.linalg.eigh(_covariance_f64(x).cpu().numpy())  # ascending
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    logs = np.log(np.maximum(evals, 1e-12))
    bucket_log = np.zeros(m)
    bucket_fill: list[list[int]] = [[] for _ in range(m)]
    for i in range(d):
        free = [b for b in range(m) if len(bucket_fill[b]) < dsub]
        b = min(free, key=lambda b: bucket_log[b])
        bucket_fill[b].append(i)
        bucket_log[b] += logs[i]
    perm = [i for b in range(m) for i in bucket_fill[b]]
    return torch.from_numpy(np.ascontiguousarray(evecs[:, perm], np.float32)).to(x.device)


def opq_train(
    data,
    n_subquantizers: int,
    n_bits: int = 8,
    opq_iters: int = 8,
    pq_iters: int = 10,
    seed: int = 1,
    init: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """OPQ (Ge et al.; FAISS's 'OPQ{m}'): an orthogonal rotation R that
    lowers the PQ error, by alternating codebook training on ``x @ R`` with
    the Procrustes solve R = U V^T of the SVD of x^T x_hat. ``init``
    "identity", "eig" (``opq_eig_init``) or "auto" (both; keep the pair with
    the lower final quantization error). Returns (R [D, D], codebooks
    [m, ksub, dsub] trained on ``x @ R``), both f32 on data's device."""
    x = _as_tensor(data).float()
    d = x.shape[1]

    def train_from(r):
        for _ in range(max(opq_iters, 1)):
            z = x @ r
            codebooks = pq_train_codebooks(z, n_subquantizers, n_bits, iters=pq_iters, seed=seed)
            z_hat = pq_decode(pq_encode(z, codebooks), codebooks)
            u, _, vt = torch.linalg.svd(x.T @ z_hat, full_matrices=False)
            r = u @ vt
        # refit the codebooks on the final rotation, so (R, codebooks) match
        z = x @ r
        codebooks = pq_train_codebooks(z, n_subquantizers, n_bits, iters=pq_iters, seed=seed)
        err = float(((pq_decode(pq_encode(z, codebooks), codebooks) - z) ** 2).mean())
        return r, codebooks, err

    inits = []
    if init in ("identity", "auto"):
        inits.append(torch.eye(d, dtype=torch.float32, device=x.device))
    if init in ("eig", "auto"):
        inits.append(opq_eig_init(x, n_subquantizers))
    if not inits:
        raise ValueError(f"unknown OPQ init {init!r}")
    best = min((train_from(r0) for r0 in inits), key=lambda t: t[2])
    return best[0], best[1]
