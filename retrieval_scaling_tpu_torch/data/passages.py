"""Disk-resident passage store with byte-offset position maps.

A copy of ``retrieval_scaling_tpu/data/passages.py``: the port never imports
the JAX package. ``tests/test_torch_pipeline.py`` holds it to the original.
It reads with plain seek+readline, without the JAX package's native
threaded-pread helper (``native/rstpu_io.cpp``), which is not ported yet.

The reference keeps passages on disk and fetches each retrieval hit with a
``seek()``+``readline()`` via a pickled ``{shard_id: {doc_id: [path, offset]}}``
map (reference: src/indicies/index_utils.py:71-134, src/indicies/flat.py:102-127).

This store keeps that on-disk contract (it reads and writes the reference's
``passage_pos_id_map.pkl``) but holds offsets as one contiguous ``int64``
numpy array per shard instead of a dict of Python ints — ~50x smaller in RAM
at a trillion-token scale and mmap-friendly. A compact ``.npz`` sidecar cache
is written alongside the pickle for fast reloads. Open file handles are kept
per shard so the serving path pays one ``pread`` per hit.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SHARD_FILE_RE = re.compile(r"raw_passages-(\d+)-of-\d+\.jsonl$")


def scan_jsonl_offsets(path: str) -> np.ndarray:
    """Byte offset of every line start in a jsonl file."""
    offsets: List[int] = []
    pos = 0
    with open(path, "rb") as f:
        for line in f:
            offsets.append(pos)
            pos += len(line)
    return np.asarray(offsets, dtype=np.int64)


def build_passage_position_map(
    passages_dir: str,
    save_path: str | None = None,
) -> Dict[int, Dict[int, list]]:
    """Build the reference-format position map over ``raw_passages-*.jsonl``.

    Returns the reference's nested-dict format (and pickles it when
    ``save_path`` is given) so artifacts interoperate; also writes the compact
    ``.npz`` sidecar used by :class:`PassageStore`.
    """
    shard_files = {}
    for filename in os.listdir(passages_dir):
        m = _SHARD_FILE_RE.search(filename)
        if m:
            shard_files[int(m.group(1))] = os.path.join(passages_dir, filename)

    pos_map: Dict[int, Dict[int, list]] = {}
    compact: Dict[str, np.ndarray] = {}
    paths: Dict[int, str] = {}
    for shard_id, path in sorted(shard_files.items()):
        offsets = scan_jsonl_offsets(path)
        compact[str(shard_id)] = offsets
        paths[shard_id] = path
        pos_map[shard_id] = {i: [path, int(off)] for i, off in enumerate(offsets)}

    if save_path is not None:
        with open(save_path, "wb") as f:
            pickle.dump(pos_map, f)
        _save_compact(_compact_sidecar_path(save_path), compact, paths)
    return pos_map


def _compact_sidecar_path(pkl_path: str) -> str:
    return pkl_path[: -len(".pkl")] + ".npz" if pkl_path.endswith(".pkl") else pkl_path + ".npz"


def _save_compact(path: str, compact: Dict[str, np.ndarray], paths: Dict[int, str]) -> None:
    meta = json.dumps({str(k): v for k, v in paths.items()})
    np.savez(path, __paths__=np.frombuffer(meta.encode(), dtype=np.uint8), **compact)


class PassageStore:
    """Random access to passages by ``(shard_id, doc_id)`` with O(1) RAM/doc.

    Thread-safe: each shard keeps a lock-guarded file handle; fetches use
    ``pread``-style seek+read under the shard lock.
    """

    def __init__(self, offsets: Dict[int, np.ndarray], shard_paths: Dict[int, str]):
        self._offsets = offsets
        self._paths = shard_paths
        self._handles: Dict[int, object] = {}
        self._locks: Dict[int, threading.Lock] = {s: threading.Lock() for s in shard_paths}

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_passages_dir(cls, passages_dir: str, pos_map_path: str | None = None) -> "PassageStore":
        pos_map_path = pos_map_path or os.path.join(passages_dir, "passage_pos_id_map.pkl")
        sidecar = _compact_sidecar_path(pos_map_path)
        if os.path.exists(sidecar):
            return cls.from_compact(sidecar)
        if os.path.exists(pos_map_path):
            return cls.from_reference_pickle(pos_map_path)
        build_passage_position_map(passages_dir, pos_map_path)
        return cls.from_compact(sidecar)

    @classmethod
    def from_compact(cls, npz_path: str) -> "PassageStore":
        data = np.load(npz_path)
        meta = json.loads(bytes(data["__paths__"]).decode())
        paths = {int(k): v for k, v in meta.items()}
        offsets = {int(k): data[k] for k in data.files if k != "__paths__"}
        return cls(offsets, paths)

    @classmethod
    def from_reference_pickle(cls, pkl_path: str) -> "PassageStore":
        """Load the reference's nested-dict pickle and compact it."""
        with open(pkl_path, "rb") as f:
            pos_map = pickle.load(f)
        offsets: Dict[int, np.ndarray] = {}
        paths: Dict[int, str] = {}
        for shard_id, docs in pos_map.items():
            n = len(docs)
            arr = np.empty(n, dtype=np.int64)
            path = None
            for doc_id, (p, off) in docs.items():
                arr[int(doc_id)] = off
                path = p
            offsets[int(shard_id)] = arr
            paths[int(shard_id)] = path
        store = cls(offsets, paths)
        sidecar = _compact_sidecar_path(pkl_path)
        if not os.path.exists(sidecar):
            try:
                _save_compact(sidecar, {str(k): v for k, v in offsets.items()}, paths)
            except OSError:
                pass
        return store

    # -- access ------------------------------------------------------------
    def _handle(self, shard_id: int):
        h = self._handles.get(shard_id)
        if h is None:
            h = open(self._paths[shard_id], "rb")
            self._handles[shard_id] = h
        return h

    def fetch_raw(self, shard_id: int, doc_id: int) -> bytes:
        off = int(self._offsets[shard_id][doc_id])
        with self._locks[shard_id]:
            h = self._handle(shard_id)
            h.seek(off)
            return h.readline()

    def fetch(self, shard_id: int, doc_id: int) -> dict:
        return json.loads(self.fetch_raw(shard_id, doc_id))

    def fetch_many(self, ids: Sequence[Tuple[int, int]]) -> List[dict]:
        """Fetch a batch of ``(shard_id, doc_id)`` pairs, reading each shard
        in offset order."""
        out: List[dict] = [None] * len(ids)  # type: ignore[list-item]
        for i in sorted(range(len(ids)), key=lambda j: (ids[j][0], int(self._offsets[ids[j][0]][ids[j][1]]))):
            out[i] = self.fetch(*ids[i])
        return out

    def close(self) -> None:
        for h in self._handles.values():
            try:
                h.close()
            except OSError:
                pass
        self._handles.clear()

