"""BM25 sparse retrieval (Okapi BM25 over numpy postings), host-only.

Ports ``retrieval_scaling_tpu/search/bm25.py``, which has no device code:
the same analyzer, index layout, scores and on-disk files
(``bm25_index.npz``, ``bm25_docs.jsonl``), so each package loads the
other's index. The port caches the Porter stem of each distinct token and
counts a document's terms with a ``Counter``; both give the JAX build's
vocabulary ids, postings and scores. ``tests/test_torch_offline.py``
holds it to the original.

BM25 sparse retrieval — from-scratch replacement for pyserini/Lucene.

The reference shells out to ``pyserini.index.lucene`` to build a Lucene
index over ``{id, contents}`` jsonl and searches via ``LuceneSearcher``
(reference: src/index.py:82-202, src/search.py:763-807). Java is not in
this stack, so this module implements Okapi BM25 (k1=0.9, b=0.4 — the
pyserini defaults) over a compact numpy postings layout:

  * CSR postings: one ``int32`` doc-id array + ``uint16`` term-frequency
    array per vocabulary slice, concatenated with offsets — memory-lean and
    mmap-able from ``.npz``.
  * Lucene-style analysis: lowercase, split on non-alphanumerics, the
    full Porter stemmer (utils/porter.py) + Lucene's english stopwords.
  * Query scoring accumulates ``idf * tf*(k1+1) / (tf + k1*(1-b+b*len/avg))``
    over posting lists with numpy scatter-adds.

The index stays host-side: BM25 is out of the TPU hot path (SURVEY §2.6).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from retrieval_scaling_tpu_torch.utils.porter import porter_stem

logger = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# Bump whenever the analysis chain (tokenizer / stemmer / stopwords)
# changes: a persisted index stores analyzed terms, so loading one built
# with a different analyzer silently breaks term matching. 2 = full
# Porter stemmer (1 was the round-1 light suffix-stripper).
ANALYZER_VERSION = 2

_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


# a corpus has far fewer distinct tokens than tokens; the stemmer is pure
_stem = functools.lru_cache(maxsize=1 << 20)(porter_stem)


def analyze(text: str) -> List[str]:
    return [
        _stem(tok)
        for tok in _TOKEN_RE.findall(text.lower())
        if tok not in _STOPWORDS
    ]


class BM25Index:
    def __init__(
        self,
        vocab: Dict[str, int],
        offsets: np.ndarray,      # [V+1] postings offsets
        post_docs: np.ndarray,    # [P] doc ids
        post_tfs: np.ndarray,     # [P] term frequencies
        doc_lens: np.ndarray,     # [N]
        k1: float = 0.9,
        b: float = 0.4,
    ):
        self.vocab = vocab
        self.offsets = offsets
        self.post_docs = post_docs
        self.post_tfs = post_tfs
        self.doc_lens = doc_lens.astype(np.float32)
        self.avg_len = float(doc_lens.mean()) if len(doc_lens) else 1.0
        self.n_docs = len(doc_lens)
        self.k1 = k1
        self.b = b

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, texts: Sequence[str], k1: float = 0.9, b: float = 0.4) -> "BM25Index":
        vocab: Dict[str, int] = {}
        doc_term_pairs: List[Tuple[int, int, int]] = []  # (term, doc, tf)
        doc_lens = np.zeros(len(texts), np.int32)
        for doc_id, text in enumerate(texts):
            tokens = analyze(text)
            doc_lens[doc_id] = len(tokens)
            # first-seen order within the document, as the JAX loop assigns ids
            for tok, tf in Counter(tokens).items():
                doc_term_pairs.append((vocab.setdefault(tok, len(vocab)), doc_id, tf))

        v = len(vocab)
        pairs = np.asarray(doc_term_pairs, np.int64).reshape(-1, 3)
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        pairs = pairs[order]
        counts_per_term = np.bincount(pairs[:, 0], minlength=v)
        offsets = np.zeros(v + 1, np.int64)
        offsets[1:] = np.cumsum(counts_per_term)
        return cls(
            vocab,
            offsets,
            pairs[:, 1].astype(np.int32),
            np.minimum(pairs[:, 2], 65535).astype(np.uint16),
            doc_lens,
            k1,
            b,
        )

    # ------------------------------------------------------------ io
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        vocab_blob = json.dumps(self.vocab).encode()
        np.savez(
            path[:-4] if path.endswith(".npz") else path,
            vocab=np.frombuffer(vocab_blob, np.uint8),
            offsets=self.offsets,
            post_docs=self.post_docs,
            post_tfs=self.post_tfs,
            doc_lens=self.doc_lens,
            params=np.asarray([self.k1, self.b], np.float32),
            analyzer_version=np.int64(ANALYZER_VERSION),
        )

    @classmethod
    def load(cls, path: str) -> "BM25Index":
        data = np.load(path)
        saved_version = int(data["analyzer_version"]) if "analyzer_version" in data else 1
        if saved_version != ANALYZER_VERSION:
            raise ValueError(
                f"BM25 index at {path} was built with analyzer version "
                f"{saved_version}, but this build analyzes queries with "
                f"version {ANALYZER_VERSION} (Porter stemmer) — stored terms "
                "would not match query terms. Rebuild the index."
            )
        vocab = json.loads(bytes(data["vocab"]).decode())
        k1, b = data["params"]
        return cls(
            vocab, data["offsets"], data["post_docs"], data["post_tfs"],
            data["doc_lens"], float(k1), float(b),
        )

    # ------------------------------------------------------------ search
    def _idf(self, df: int) -> float:
        # Lucene BM25 idf
        return float(np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5)))

    def search(self, query: str, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (scores [<=k], doc_ids [<=k]) sorted descending."""
        scores = np.zeros(self.n_docs, np.float32)
        norm = self.k1 * (1.0 - self.b + self.b * self.doc_lens / self.avg_len)
        for tok in analyze(query):
            tid = self.vocab.get(tok)
            if tid is None:
                continue
            s, e = self.offsets[tid], self.offsets[tid + 1]
            docs = self.post_docs[s:e]
            tfs = self.post_tfs[s:e].astype(np.float32)
            idf = self._idf(e - s)
            scores[docs] += idf * tfs * (self.k1 + 1.0) / (tfs + norm[docs])
        k = min(k, self.n_docs)
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        top = top[scores[top] > 0]
        return scores[top], top


class BM25Searcher:
    """Doc-store-backed searcher with the reference's full option surface.

    Mirrors ``BM25Index.search(query, k, continuation=, shift=, raw_only=)``
    (reference: src/index.py:118-155), which the tokenized-datastore path
    uses via src/search.py:763-807:

      * ``shift``      — return doc ``id+1`` instead of the hit itself
        (next-block retrieval).
      * ``continuation`` — concatenate the NEXT doc block onto each hit.
        Reference quirk preserved: the "next" block is always
        ``original_docid + 1`` even when ``shift`` already moved the hit
        there (src/index.py:130), so shift+continuation doubles the block.
        On the last block the reference logs and skips the concat
        (src/index.py:136) — same here.
      * ``raw_only=False`` — parse each raw jsonl doc and return its
        ``input_ids`` (token-level datastores) instead of raw text.

    ``raw_docs`` are the stored jsonl lines, in docid order — the analog of
    Lucene's ``--storeRaw`` field.
    """

    def __init__(self, index: BM25Index, raw_docs: Sequence[str]):
        if len(raw_docs) != index.n_docs:
            raise ValueError(
                f"doc store has {len(raw_docs)} rows but the index scores "
                f"{index.n_docs} docs"
            )
        self.index = index
        self.raw_docs = list(raw_docs)

    def doc_raw(self, docid: int):
        """Raw stored doc, or None when out of range (Lucene doc() analog)."""
        if 0 <= docid < len(self.raw_docs):
            return self.raw_docs[docid]
        return None

    def search(
        self,
        query: str,
        k: int = 10,
        continuation: bool = False,
        shift: bool = False,
        raw_only: bool = True,
    ) -> List:
        _, ids = self.index.search(query, k)
        out: List = []
        for hit in ids:
            hit = int(hit)
            docid = hit + 1 if shift else hit
            raw = self.doc_raw(docid)
            if raw is None:
                # the reference would crash on .raw() of a missing shifted
                # doc; skipping the hit with a warning is the sane analog
                logger.warning(
                    "shifted docid %d past the last block — dropping hit", docid
                )
                continue
            next_raw = self.doc_raw(hit + 1) if continuation else None
            if continuation and next_raw is None:
                logger.info("The last block retrieved, so skipping continuation...")
            if raw_only:
                out.append(raw + next_raw if next_raw is not None else raw)
            else:
                input_ids = list(json.loads(raw)["input_ids"])
                if next_raw is not None:
                    input_ids += json.loads(next_raw)["input_ids"]
                out.append(input_ids)
        return out


# ---------------------------------------------------------------- pipeline
def get_bm25_index_dir(cfg, index_shard_ids: Sequence[int]) -> str:
    """Reference path scheme (reference: src/index.py:59-79)."""
    postfix = "_".join(str(s) for s in sorted(int(i) for i in index_shard_ids))
    return os.path.join(
        cfg.datastore.datastore_root_dir,
        "bm25",
        cfg.datastore.domain,
        f"{cfg.datastore.embedding.num_shards}-shards",
        postfix,
    )


def _flatten_shard_ids(index_shard_ids) -> List[int]:
    ids = list(index_shard_ids)
    if ids and isinstance(ids[0], (list, tuple)):
        return [int(i) for group in ids for i in group]
    return [int(i) for i in ids]


def build_bm25_index(cfg) -> BM25Index:
    """Build (or load) the BM25 index over the configured passage shards."""
    from retrieval_scaling_tpu_torch.data.sharding import load_jsonl_shard

    shard_ids = _flatten_shard_ids(cfg.datastore.index.index_shard_ids)
    index_dir = get_bm25_index_dir(cfg, shard_ids)
    index_path = os.path.join(index_dir, "bm25_index.npz")
    docs_path = os.path.join(index_dir, "bm25_docs.jsonl")

    if os.path.exists(index_path) and os.path.exists(docs_path):
        logger.info("BM25 index exists at %s", index_path)
        return BM25Index.load(index_path)

    texts, metas = [], []
    for shard_id in shard_ids:
        passages = load_jsonl_shard(cfg.datastore.embedding, shard_id)
        for p in passages:
            texts.append(p["text"])
            metas.append({"id": [p.get("shard_id", shard_id), p["id"]], "contents": p["text"]})

    logger.info("Building BM25 index over %d passages", len(texts))
    index = BM25Index.build(texts)
    index.save(index_path)
    os.makedirs(index_dir, exist_ok=True)
    with open(docs_path, "w") as f:
        for meta in metas:
            f.write(json.dumps(meta) + "\n")
    return index


def search_sparse_topk(cfg, tokenizer=None) -> None:
    """BM25 search task (reference: src/search.py:763-807)."""
    from retrieval_scaling_tpu_torch.data.eval_data import load_eval_data
    from retrieval_scaling_tpu_torch.search.driver import get_search_output_path, safe_write_jsonl

    shard_ids = _flatten_shard_ids(cfg.datastore.index.index_shard_ids)
    output_path = get_search_output_path(cfg, shard_ids)
    if os.path.exists(output_path) and not cfg.evaluation.search.overwrite:
        logger.info("BM25 results exist: %s", output_path)
        return

    index_dir = get_bm25_index_dir(cfg, shard_ids)
    index_path = os.path.join(index_dir, "bm25_index.npz")
    docs_path = os.path.join(index_dir, "bm25_docs.jsonl")
    if os.path.exists(index_path):
        index = BM25Index.load(index_path)
    else:
        index = build_bm25_index(cfg)
    with open(docs_path) as f:
        docs = [json.loads(line) for line in f]

    data = load_eval_data(cfg, tokenizer=tokenizer)
    n_docs = cfg.evaluation.search.n_docs
    for ex in data:
        query = ex.get("raw_query")
        if query:
            scores, ids = index.search(query, n_docs)
            ex["ctxs"] = [
                {
                    "id": docs[int(i)]["id"],
                    "retrieval text": docs[int(i)]["contents"],
                    "retrieval score": float(s),
                }
                for s, i in zip(scores, ids)
            ]
        else:
            ex["ctxs"] = [None]

    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    safe_write_jsonl(data, output_path)
