"""Text chunking strategies for datastore construction.

A copy of ``retrieval_scaling_tpu/data/chunking.py``: the port never imports
the JAX package. ``tests/test_torch_pipeline.py`` holds it to the original.

Behavioral parity with the reference chunkers (reference: src/data.py:246-267):

  * ``fixed_size`` — whitespace word split into chunks of ``chunk_size`` words;
    a trailing chunk shorter than ``min_chunk_size`` words is merged into the
    previous chunk; ``keep_last=False`` drops the ragged tail.
  * ``semantic``  — the reference shells out to the Rust
    ``semantic_text_splitter`` wheel with a tiktoken budget. That wheel is not
    available here, so we re-implement greedy sentence packing under a token
    budget with recursive fallback splitting (paragraph -> sentence -> word),
    which is the same algorithm class the wheel implements.
  * ``None``      — passthrough.
"""

from __future__ import annotations

import re
from typing import Callable, List

_SENTENCE_RE = re.compile(r"(?<=[.!?。！？])\s+")
_PARAGRAPH_RE = re.compile(r"\n\s*\n")


def _whitespace_token_count(text: str) -> int:
    return len(text.split())


def fixed_size_chunks(
    text: str,
    chunk_size: int,
    min_chunk_size: int = 0,
    keep_last: bool = True,
) -> List[str]:
    words = text.split()
    limit = len(words) if keep_last else len(words) - len(words) % chunk_size
    chunks = [" ".join(words[i : i + chunk_size]) for i in range(0, limit, chunk_size)]
    if len(chunks) > 1 and len(chunks[-1].split(" ")) < min_chunk_size:
        last = chunks.pop()
        chunks[-1] += " " + last
    return chunks


def semantic_chunks(
    text: str,
    chunk_size: int,
    count_tokens: Callable[[str], int] | None = None,
) -> List[str]:
    """Greedy semantic packing: keep sentences together under a token budget.

    Splits at the coarsest boundary that fits (paragraphs, then sentences,
    then words) and greedily packs consecutive units into chunks whose token
    count stays within ``chunk_size``.
    """
    count = count_tokens or _whitespace_token_count

    def pack(units: List[str], joiner: str) -> List[str]:
        chunks: List[str] = []
        current = ""
        for unit in units:
            candidate = unit if not current else current + joiner + unit
            if count(candidate) <= chunk_size:
                current = candidate
                continue
            if current:
                chunks.append(current)
            if count(unit) <= chunk_size:
                current = unit
            else:
                chunks.extend(split_unit(unit))
                current = ""
        if current:
            chunks.append(current)
        return chunks

    def split_unit(unit: str) -> List[str]:
        sentences = [s for s in _SENTENCE_RE.split(unit) if s.strip()]
        if len(sentences) > 1:
            return pack(sentences, " ")
        # A single over-budget sentence: fall back to word windows.
        words = unit.split()
        out, cur = [], []
        for w in words:
            cur.append(w)
            if count(" ".join(cur)) >= chunk_size:
                out.append(" ".join(cur))
                cur = []
        if cur:
            out.append(" ".join(cur))
        return out

    paragraphs = [p for p in _PARAGRAPH_RE.split(text) if p.strip()]
    if not paragraphs:
        return []
    return pack(paragraphs, "\n\n")


def split_text_into_chunks(
    text: str,
    chunk_size: int | None,
    min_chunk_size: int = 0,
    keep_last: bool = True,
    strategy: str | None = "fixed_size",
    count_tokens: Callable[[str], int] | None = None,
) -> List[str]:
    if chunk_size is None or strategy is None:
        return [text]
    if strategy == "fixed_size":
        return fixed_size_chunks(text, chunk_size, min_chunk_size, keep_last)
    if strategy == "semantic":
        return semantic_chunks(text, chunk_size, count_tokens)
    raise ValueError(f"Unknown chunking strategy: {strategy!r}")
