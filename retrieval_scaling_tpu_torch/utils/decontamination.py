"""Lexical-overlap decontamination between retrieved docs and gold text.

A copy of ``retrieval_scaling_tpu/utils/decontamination.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_offline.py`` holds it to the original.

Behavioral parity with the reference (reference: src/decontamination.py:4-79):

  * ``longest``: maximum contiguous word-overlap between doc and gold text;
    the threshold is a word *count* when >= 1 or a *ratio* of the gold length
    when < 1. The reference scans all start pairs (O(n*m*L)); here the same
    quantity is computed with an O(n*m) suffix-match dynamic program.
  * ``jaccard``: Jaccard similarity over 13-word shingles <= threshold.

Returns True when the doc is "clean" (below the threshold) — same polarity
as the reference helper.
"""

from __future__ import annotations

from typing import List


def max_contiguous_overlap(words_a: List[str], words_b: List[str]) -> int:
    """Length of the longest common contiguous word run (O(n*m) DP)."""
    n, m = len(words_a), len(words_b)
    if n == 0 or m == 0:
        return 0
    best = 0
    prev = [0] * (m + 1)
    for i in range(1, n + 1):
        cur = [0] * (m + 1)
        wa = words_a[i - 1]
        for j in range(1, m + 1):
            if wa == words_b[j - 1]:
                cur[j] = prev[j - 1] + 1
                if cur[j] > best:
                    best = cur[j]
        prev = cur
    return best


def shingles_13(text: str) -> set:
    words = text.split()
    return {" ".join(words[i : i + 13]) for i in range(len(words) - 12)}


def jaccard_similarity(a: set, b: set) -> float:
    union = a | b
    return len(a & b) / len(union) if union else 0.0


def check_below_lexical_overlap_threshold(
    doc: str,
    gold_text: str,
    threshold: float = 0.25,
    mode: str = "longest",
) -> bool:
    if threshold == 1:
        return True

    if mode == "longest":
        doc_words = doc.split(" ")
        gold_words = gold_text.split(" ")
        overlap = max_contiguous_overlap(doc_words, gold_words)
        if threshold < 1:
            return overlap < int(len(gold_words) * threshold)
        return overlap < threshold

    if mode == "jaccard":
        assert threshold < 1, "jaccard mode requires a ratio threshold in [0, 1)"
        return jaccard_similarity(shingles_13(doc), shingles_13(gold_text)) <= threshold

    raise ValueError(f"Unknown decontamination mode: {mode!r}")
