"""Config-driven pipeline entry point (the ``ric/main_ric.py`` analog).

Ports ``retrieval_scaling_tpu/pipeline/main.py``: runs the tasks gated by
``tasks.*`` booleans (datastore embedding -> index build -> search ->
merge_search -> perplexity or its calibration form) on one explicit device, and appends the one-line result record
to ``evaluation.results_only_log_file``.

Usage:
    python -m retrieval_scaling_tpu_torch.pipeline.main --config-name example_config \\
        --device cuda datastore.domain=my_domain evaluation.search.n_docs=5
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import torch

from retrieval_scaling_tpu_torch.config import load_config
from retrieval_scaling_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def run_tasks(cfg, device: torch.device) -> dict:
    """Run the enabled stages; returns ``{"stage_seconds": {...}, "ppl": PplEvalOutput | None}``."""
    seconds = {}
    ppl = None

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        logger.info("stage %s took %.3f s", name, seconds[name])
        return out

    if cfg.tasks.datastore.get("embedding", False):
        from retrieval_scaling_tpu_torch.pipeline.embed import generate_passage_embeddings

        timed("embedding", generate_passage_embeddings, cfg, device)

    if cfg.tasks.datastore.get("index", False):
        from retrieval_scaling_tpu_torch.pipeline.index_build import build_index

        timed("index", build_index, cfg, device)

    if cfg.tasks.eval.get("search", False):
        from retrieval_scaling_tpu_torch.search.driver import search_topk

        timed("search", search_topk, cfg, device)

    if cfg.tasks.eval.get("merge_search", False):
        from retrieval_scaling_tpu_torch.search.postprocess import post_hoc_merge_topk_multi_domain

        timed("merge_search", post_hoc_merge_topk_multi_domain, cfg)

    if cfg.tasks.eval.get("inference", False):
        task_name = cfg.tasks.eval.task_name
        if task_name not in ("perplexity", "perplexity_calibration"):
            raise ValueError(
                f"Inference for task {task_name!r} runs through the RAG evaluation "
                "harness, not copied into the port yet (rag_eval.models holds its reader backend)"
            )
        from retrieval_scaling_tpu_torch.evals.perplexity import evaluate_perplexity

        ppl = timed("inference", evaluate_perplexity, cfg, device)
        log_file = cfg.evaluation.get("results_only_log_file", None)
        if log_file:
            with open(log_file, "a") as f:
                f.write(ppl.log_message() + "\n")
    return {"stage_seconds": seconds, "ppl": ppl}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-name", default="default")
    parser.add_argument("--config-dir", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu; never chosen implicitly")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides key=value")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    fmt = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt, stream=sys.stdout)
    cfg = load_config(args.config_name, config_dir=args.config_dir, overrides=args.overrides)
    log_path = cfg.get("logging", {}).get("file", None)
    if log_path:
        handler = logging.FileHandler(log_path, mode="a")
        handler.setFormatter(logging.Formatter(fmt))
        logging.getLogger().addHandler(handler)
    return run_tasks(cfg, device)


if __name__ == "__main__":
    main()
