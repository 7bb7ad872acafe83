"""One-command serving on an explicit device (the MassiveServe analog).

Ports ``retrieval_scaling_tpu/serve/__main__.py`` (``--mode build``, the
default: fabricate the demo corpus when asked, embed it and build its index
if they are missing, then serve) and the ``worker`` route of
``scripts/serve.py`` (``--mode worker``: serve prebuilt artifacts; the
config takes ``RST_OVERRIDE_*`` variables and the topology variables
DS_DOMAIN, NUM_SHARDS, NUM_SHARDS_PER_WORKER and WORKER_ID):

    python -m retrieval_scaling_tpu_torch.serve --device cuda --domain_name demo
    python -m retrieval_scaling_tpu_torch.serve --device cuda --mode worker \\
        --config-name example_config --port 5000 serve.generation_model=<reader dir>

then ``POST /search {"query": ..., "n_docs": N}`` and, with a generation
model, ``POST /generate {"prompt": ..., "max_tokens": N}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import sys


def write_demo_corpus(path: str, n_docs: int) -> None:
    topics = ["astronomy", "biology", "chemistry", "geology", "history"]
    rng = random.Random(0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(n_docs):
            topic = topics[i % len(topics)]
            words = [f"{topic}_term_{rng.randint(0, 400)}" for _ in range(rng.randint(20, 80))]
            f.write(json.dumps({"text": " ".join(words), "meta": {"topic": topic}}) + "\n")


def main(argv=None, block: bool = True):
    """Parse ``argv``, prepare the datastore (build mode) and serve; returns
    the ``SearchAPIServer`` (at once when ``block`` is False)."""
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mode", choices=("build", "worker"), default="build")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu; never chosen implicitly")
    parser.add_argument("--domain_name", default="demo")
    parser.add_argument("--raw_data", default=None, help="jsonl corpus ({'text': ...} rows), build mode")
    parser.add_argument("--config-name", dest="config_name", default=None,
                        help="serving (build mode) or default (worker mode) when omitted")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--registry", default="running_ports_massiveds.jsonl")
    parser.add_argument("--demo-docs", type=int, default=2000)
    parser.add_argument("overrides", nargs="*", help="config dotlist overrides")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    from retrieval_scaling_tpu_torch.config import config_from_env, load_config
    from retrieval_scaling_tpu_torch.device import resolve_device
    from retrieval_scaling_tpu_torch.serve.http_server import serve_worker_from_config

    device = resolve_device(args.device)
    if args.mode == "worker":
        cfg = load_config(args.config_name or "default", overrides=args.overrides)
        config_from_env(cfg)
        return serve_worker_from_config(cfg, device, port=args.port, registry_path=args.registry, block=block)

    from retrieval_scaling_tpu_torch.pipeline.embed import generate_passage_embeddings
    from retrieval_scaling_tpu_torch.pipeline.index_build import build_index

    raw_data = args.raw_data
    if raw_data is None:
        if args.domain_name != "demo":
            parser.error("--raw_data is required for non-demo domains")
        raw_data = os.path.join("raw_data", "demo-corpus.jsonl")
        if not os.path.exists(raw_data):
            write_demo_corpus(raw_data, args.demo_docs)
            print(f"wrote demo corpus to {raw_data}")
    overrides = [
        f"datastore.domain={args.domain_name}",
        f"datastore.raw_data_path={raw_data}",
        "tasks.datastore.embedding=true",
        "tasks.datastore.index=true",
    ] + list(args.overrides)
    cfg = load_config(args.config_name or "serving", overrides=overrides)
    config_from_env(cfg)
    generate_passage_embeddings(cfg, device)
    build_index(cfg, device)
    return serve_worker_from_config(cfg, device, port=args.port, registry_path=args.registry, block=block)


if __name__ == "__main__":
    main()
