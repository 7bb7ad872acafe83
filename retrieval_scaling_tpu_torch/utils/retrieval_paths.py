"""The per-domain retrieved-results path list for multi-source merging.

A copy of ``retrieval_scaling_tpu/utils/retrieval_paths.py`` (the port imports nothing of the
JAX package); ``tests/test_torch_offline.py`` holds it to the original.

Emit the per-domain retrieved-results path list for multi-source merging.

Reproduces ``scripts/write_retrieval_paths_to_txt.py`` (reference:
scripts/write_retrieval_paths_to_txt.py:27-143): enumerate each domain's
merged search-output path under the datastore root, verify completeness,
and write the txt consumed by ``evaluation.search.paths_to_merge``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Sequence, Tuple

logger = logging.getLogger(__name__)


def merged_result_path(
    root: str,
    encoder: str,
    domain: str,
    chunk_size: int,
    num_shards: int,
    n_docs: int,
    eval_basename: str,
    shard_groups: Sequence[Sequence[int]],
) -> str:
    """The merged search-output path scheme (reference: default.yaml:110 +
    src/search.py get_merged_search_output_path)."""
    postfix = "-".join(
        "_".join(str(s) for s in group)
        for group in sorted(shard_groups, key=lambda g: int(g[0]))
    )
    return os.path.join(
        root,
        "retrieved_results",
        encoder,
        f"{domain}_datastore-{chunk_size}_chunk_size-1of{num_shards}_shards",
        f"top_{n_docs}",
        postfix,
        eval_basename.replace(".jsonl", "_retrieved_results.jsonl"),
    )


def write_retrieval_paths(
    output_txt: str,
    root: str,
    encoder: str,
    eval_basename: str,
    domains: Dict[str, Tuple[int, int]],  # domain -> (num_shards, chunk_size)
    n_docs: int = 1000,
    require_exists: bool = True,
) -> List[str]:
    paths = []
    missing = []
    for domain, (num_shards, chunk_size) in domains.items():
        groups = [[i] for i in range(num_shards)]
        path = merged_result_path(
            root, encoder, domain, chunk_size, num_shards, n_docs, eval_basename, groups
        )
        if require_exists and not os.path.exists(path):
            missing.append(path)
            continue
        paths.append(path)
    if missing:
        logger.warning("missing %d result files, e.g. %s", len(missing), missing[0])
        if require_exists and not paths:
            raise FileNotFoundError(f"no retrieval results found; first missing: {missing[0]}")
    os.makedirs(os.path.dirname(output_txt) or ".", exist_ok=True)
    with open(output_txt, "w") as f:
        for p in paths:
            f.write(p + "\n")
    return paths
