"""Byte-range jsonl sharding for embarrassingly-parallel datastore builds.

A copy of ``retrieval_scaling_tpu/data/sharding.py``: the port never imports
the JAX package. ``tests/test_torch_pipeline.py`` holds it to the original.

Reproduces the reference's shard contract (reference: src/data.py:15-168):
the corpus (one jsonl file or a directory of them) is divided into
``num_shards`` equal **byte** ranges; a worker seeks to its range start,
skips the partial line, and reads/chunks documents until the range end.
Passage records are ``{text, id, shard_id, num_shards, **raw metadata}`` with
ids numbered per shard. Cached artifacts use the same filenames as the
reference (``raw_passages-{i}-of-{n}.jsonl`` / ``.pkl``) so prebuilt
datastores interoperate.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from dataclasses import dataclass
from typing import Iterator, List

from retrieval_scaling_tpu_torch.data.chunking import split_text_into_chunks

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ShardFileRange:
    path: str
    start: int
    end: int


def corpus_files(raw_data_path: str) -> List[str]:
    if os.path.isdir(raw_data_path):
        return [os.path.join(raw_data_path, f) for f in sorted(os.listdir(raw_data_path))]
    return [raw_data_path]


def shard_byte_ranges(raw_data_path: str, num_shards: int, shard_index: int) -> List[ShardFileRange]:
    """Map shard ``shard_index`` of ``num_shards`` to byte ranges over files."""
    files = corpus_files(raw_data_path)
    sizes = [os.path.getsize(f) for f in files]
    total = sum(sizes)
    shard_size = total / num_shards
    shard_start = shard_size * shard_index
    shard_end = total if shard_index == num_shards - 1 else shard_start + shard_size

    ranges: List[ShardFileRange] = []
    pos = 0
    for path, size in zip(files, sizes):
        nxt = pos + size
        if nxt > shard_start and pos < shard_end:
            ranges.append(
                ShardFileRange(path, int(max(shard_start - pos, 0)), int(min(shard_end - pos, size)))
            )
        pos = nxt
    return ranges


def iter_jsonl_range(rng: ShardFileRange) -> Iterator[dict]:
    """Yield json records whose line *starts* inside the byte range.

    Seek to ``start``; when not at file head, skip the partial line (the
    previous shard owns it). Read lines while the read head is before ``end``.
    """
    with open(rng.path, "r", encoding="utf-8") as f:
        f.seek(rng.start)
        if rng.start != 0:
            f.readline()
        while f.tell() < rng.end:
            line = f.readline().strip()
            if not line:
                break
            yield json.loads(line)


def load_jsonl_shard(args, shard_index: int, return_passages: bool = True):
    """Load (or build+cache) the passage list for one shard.

    ``args`` is the ``datastore.embedding`` (or ``.index``) config node. With
    ``use_passage_pos_id_map`` the cache is jsonl (seekable for the serving
    tier); otherwise a pickle. When all shards' jsonl caches exist, the
    position map is built as a side effect (reference: src/data.py:145-163).
    """
    from retrieval_scaling_tpu_torch.data.passages import build_passage_position_map

    num_shards = args.num_shards
    use_pos_map = bool(args.get("use_passage_pos_id_map", False))
    passages_dir = args.get("passages_dir", None)

    if not return_passages and not use_pos_map:
        raise ValueError("use_passage_pos_id_map=True is required for lazy passage loading")

    pos_map_path = os.path.join(passages_dir, "passage_pos_id_map.pkl") if passages_dir else None

    if use_pos_map and passages_dir:
        cache_path = os.path.join(passages_dir, f"raw_passages-{shard_index}-of-{num_shards}.jsonl")
        if not return_passages:
            if os.path.exists(pos_map_path):
                with open(pos_map_path, "rb") as f:
                    return pickle.load(f)
            if _all_shard_caches_exist(passages_dir, num_shards):
                return build_passage_position_map(passages_dir, pos_map_path)
        elif os.path.exists(cache_path):
            with open(cache_path) as f:
                return [json.loads(line) for line in f]
    elif passages_dir:
        cache_path = os.path.join(passages_dir, f"raw_passages-{shard_index}-of-{num_shards}.pkl")
        if os.path.exists(cache_path):
            logger.info("Loading cached passages from %s", cache_path)
            with open(cache_path, "rb") as f:
                return pickle.load(f)

    raw_data_path = args.raw_data_path
    if raw_data_path is None or not os.path.exists(raw_data_path):
        logger.warning("%s does not exist", raw_data_path)
        return None

    passages = _build_shard_passages(args, shard_index)

    if passages_dir:
        os.makedirs(passages_dir, exist_ok=True)
        if use_pos_map:
            with open(cache_path, "w") as f:
                for p in passages:
                    f.write(json.dumps(p) + "\n")
            if _all_shard_caches_exist(passages_dir, num_shards):
                pos_map = build_passage_position_map(passages_dir, pos_map_path)
                if not return_passages:
                    return pos_map
        else:
            with open(cache_path, "wb") as f:
                pickle.dump(passages, f)

    return passages


def _all_shard_caches_exist(passages_dir: str, num_shards: int) -> bool:
    return all(
        os.path.exists(os.path.join(passages_dir, f"raw_passages-{i}-of-{num_shards}.jsonl"))
        for i in range(num_shards)
    )


def _build_shard_passages(args, shard_index: int) -> List[dict]:
    raw_data_key = args.get("raw_data_key", "text")
    chunk_size = args.chunk_size
    min_chunk_size = args.get("min_chunk_sz", 0)
    keep_last = args.get("keep_last_chunk", True)
    strategy = args.get("chunking_strategy", "fixed_size")
    keep_raw_metadata = args.get("keep_raw_metadata", True)

    passages: List[dict] = []
    idx = 0
    for rng in shard_byte_ranges(args.raw_data_path, args.num_shards, shard_index):
        for ex in iter_jsonl_range(rng):
            text = ex.get(raw_data_key)
            if text is None:
                continue
            for chunk in split_text_into_chunks(
                text.strip(), chunk_size, min_chunk_size, keep_last, strategy
            ):
                record = dict(ex) if keep_raw_metadata else {}
                record.update(
                    {
                        "text": chunk,
                        "id": idx,
                        "shard_id": shard_index,
                        "num_shards": args.num_shards,
                    }
                )
                passages.append(record)
                idx += 1
    return passages
