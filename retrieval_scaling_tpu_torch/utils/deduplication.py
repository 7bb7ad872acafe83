"""MinHash-LSH near-duplicate removal for retrieved contexts.

A copy of ``retrieval_scaling_tpu/utils/deduplication.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_offline.py`` holds it to the original.

From-scratch replacement for the reference's datasketch dependency
(reference: utils/deduplication.py:28-104), same semantics:

  * 13-word shingles, 128 permutations, Jaccard threshold 0.8;
  * the eval query is inserted first so contaminated docs are dropped
    ("query decontamination");
  * the first (highest-scored) representative of each duplicate group
    survives; survivors get ``quality score`` 1, removed docs 0;
  * chunks shorter than 13 words (no shingles) are removed.

Implementation: shingles hash to 64-bit fingerprints; signatures are
``min((a * x + b) mod p)`` over a Mersenne prime (vectorized numpy);
candidate pairs come from banded LSH buckets and are confirmed by exact
signature-estimated Jaccard — the same pipeline datasketch runs.
"""

from __future__ import annotations

import hashlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

_MERSENNE_PRIME = np.uint64((1 << 61) - 1)
_MAX_HASH = np.uint64((1 << 32) - 1)
_NUM_PERM = 128


def _permutations(num_perm: int = _NUM_PERM, seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    a = rng.randint(1, _MERSENNE_PRIME, size=num_perm, dtype=np.uint64)
    b = rng.randint(0, _MERSENNE_PRIME, size=num_perm, dtype=np.uint64)
    return a, b


_A, _B = _permutations()


def shingle_document(text: str, shingle_size: int = 13) -> set:
    words = text.split()
    return {
        " ".join(words[i : i + shingle_size])
        for i in range(len(words) - shingle_size + 1)
    }


def _hash_shingles(shingles: set) -> np.ndarray:
    out = np.empty(len(shingles), dtype=np.uint64)
    for i, s in enumerate(shingles):
        out[i] = np.frombuffer(
            hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), dtype=np.uint64
        )[0]
    return out


def minhash_signature(shingles: set, num_perm: int = _NUM_PERM) -> np.ndarray:
    """[num_perm] uint64 signature (empty set -> all MAX_HASH)."""
    if not shingles:
        return np.full(num_perm, _MAX_HASH, dtype=np.uint64)
    x = _hash_shingles(shingles)
    # (a * x + b) mod p, folded to 32 bits like datasketch
    prods = (_A[:num_perm, None] * x[None, :] + _B[:num_perm, None]) % _MERSENNE_PRIME
    return np.bitwise_and(prods.min(axis=1), _MAX_HASH)


def estimate_jaccard(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
    return float(np.mean(sig_a == sig_b))


def _optimal_bands(threshold: float, num_perm: int) -> Tuple[int, int]:
    """Pick (bands, rows) minimizing FP+FN probability mass at ``threshold``
    (the datasketch integration, trapezoid-approximated)."""
    best, best_err = (1, num_perm), float("inf")
    xs = np.linspace(0, 1, 101)
    for b in range(1, num_perm + 1):
        if num_perm % b:
            continue
        r = num_perm // b
        prob = 1.0 - (1.0 - xs**r) ** b
        fp = np.trapezoid(prob[xs <= threshold], xs[xs <= threshold])
        fn = np.trapezoid(1 - prob[xs >= threshold], xs[xs >= threshold])
        err = fp + fn
        if err < best_err:
            best, best_err = (b, r), err
    return best


def _abstain_decon_string(text: str) -> bool:
    # MMLU reading-comprehension prompts quote a Wikipedia paragraph; do not
    # treat that as contamination (reference: utils/deduplication.py:24-26).
    return "refers to the following information" in text


def remove_duplicates_with_minhash(
    documents: List[dict],
    string_for_decontamination: Optional[str] = None,
    threshold: float = 0.8,
    num_perm: int = _NUM_PERM,
    text_key: str = "retrieval text",
) -> List[dict]:
    bands, rows = _optimal_bands(threshold, num_perm)

    sigs: List[np.ndarray] = []
    has_shingles: List[bool] = []
    decon_count = 0
    if string_for_decontamination is not None and not _abstain_decon_string(
        string_for_decontamination
    ):
        sigs.append(minhash_signature(shingle_document(string_for_decontamination), num_perm))
        has_shingles.append(True)
        decon_count = 1

    for ctx in documents:
        sh = shingle_document(ctx[text_key])
        sigs.append(minhash_signature(sh, num_perm))
        has_shingles.append(bool(sh))

    # LSH buckets: band -> hash(bytes of band slice) -> doc ids
    buckets: Dict[Tuple[int, bytes], List[int]] = {}
    for idx, sig in enumerate(sigs):
        for band in range(bands):
            key = (band, sig[band * rows : (band + 1) * rows].tobytes())
            buckets.setdefault(key, []).append(idx)

    survivors: List[int] = []
    for idx in range(decon_count, len(sigs)):
        sig = sigs[idx]
        candidates = set()
        for band in range(bands):
            key = (band, sig[band * rows : (band + 1) * rows].tobytes())
            candidates.update(buckets.get(key, ()))
        is_dup = any(
            other < idx and estimate_jaccard(sigs[other], sig) > threshold
            for other in candidates
        )
        if not is_dup and has_shingles[idx]:
            survivors.append(idx - decon_count)

    survivor_set = set(survivors)
    deduped = []
    for i, doc in enumerate(documents):
        doc["quality score"] = 1 if i in survivor_set else 0
        if i in survivor_set:
            deduped.append(doc)
    return deduped


def _process_item(item):
    idx, ex = item
    ex["ctxs"] = remove_duplicates_with_minhash(
        ex["ctxs"], string_for_decontamination=ex.get("raw_query")
    )
    return idx, ex


def multiprocess_deduplication(data: List[dict], processes: int = 16) -> List[dict]:
    """Parallel per-example dedup (reference: utils/deduplication.py:98-104).

    The workers are spawned, not forked (the JAX package's pool forks): the
    caller may hold CUDA state and threads, which a fork copies unsafely.
    The result is the same."""
    if len(data) < 4:
        for idx, ex in enumerate(data):
            _, data[idx] = _process_item((idx, ex))
        return data
    with ProcessPoolExecutor(max_workers=processes, mp_context=multiprocessing.get_context("spawn")) as pool:
        for idx, ex in pool.map(_process_item, list(enumerate(data)), chunksize=8):
            data[idx] = ex
    return data
