"""HTTP serving frontend (worker).

Ports ``retrieval_scaling_tpu/serve/http_server.py`` with the same API
(reference: api/serve_worker_node.py): ``POST /search {query|queries,
n_docs, domains}`` -> ``{results: {query, n_docs, scores, passages, IDs},
message}``; ``POST /generate {prompt, max_tokens, stop}`` -> ``{text,
n_tokens, message}``; ``GET /current_search``, ``/queue_size`` and
``/health``; the shared-filesystem registry line ``{domain_name, chunk_id,
endpoint}`` (``running_ports_massiveds.jsonl``). The topology variables
DS_DOMAIN, NUM_SHARDS, NUM_SHARDS_PER_WORKER and WORKER_ID select the
worker's shard group. Requests block on the micro-batcher, so concurrency
becomes batching on the worker's device.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

logger = logging.getLogger(__name__)


def find_free_port(start: int = 5000, end: int = 6000) -> int:
    """A port in [start, end) that nothing listens on. The scan starts at an
    offset set by the process id and wraps around, so that processes started
    together (one worker per shard on a host) do not all take the first free
    port and race to bind it."""
    offset = os.getpid() % (end - start)
    for i in range(end - start):
        port = start + (offset + i) % (end - start)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("", port))
                return port
            except OSError:
                continue
    raise RuntimeError("no free port found")


def register_endpoint(registry_path: str, domain_name: str, chunk_id, endpoint: str) -> None:
    os.makedirs(os.path.dirname(registry_path) or ".", exist_ok=True)
    with open(registry_path, "a") as f:
        f.write(json.dumps({"domain_name": domain_name, "chunk_id": chunk_id, "endpoint": endpoint}) + "\n")


class SearchAPIServer:
    """Wraps an engine (or a dict of engines by domain) behind HTTP."""

    def __init__(self, engines: Dict[str, object], default_n_docs: int = 10,
                 log_queries_path: Optional[str] = None, generator=None):
        self.engines = engines
        self.default_n_docs = default_n_docs
        self.log_queries_path = log_queries_path
        self.generator = generator  # optional GenerationService (/generate)
        self._log_lock = threading.Lock()
        self.server: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None

    # ------------------------------------------------------------ logic
    def handle_search(self, payload: dict) -> dict:
        queries = payload.get("queries")
        single = queries is None
        if single:
            queries = [payload.get("query", "")]
        n_docs = int(payload.get("n_docs", self.default_n_docs))
        engine = self._pick_engine(payload.get("domains", None))
        results = [{"query": q, "n_docs": n_docs, **engine.search(q, n_docs)} for q in queries]
        if self.log_queries_path:
            with self._log_lock, open(self.log_queries_path, "a") as f:
                for q in queries:
                    f.write(json.dumps({"query": q, "n_docs": n_docs}) + "\n")
        return {"results": results[0] if single else results, "message": "Search completed successfully"}

    def _pick_engine(self, domains):
        if domains is None or domains == "all" or not self.engines:
            return next(iter(self.engines.values()))
        if isinstance(domains, str):
            domains = [domains]
        for d in domains:
            if d in self.engines:
                return self.engines[d]
        raise KeyError(f"no engine for domains {domains}")

    def handle_generate(self, payload: dict) -> dict:
        """``{prompt, max_tokens, stop}`` -> ``{text, n_tokens, message}``;
        concurrent requests share decode steps in the GenerationService."""
        if self.generator is None:
            raise KeyError("no generation model configured on this worker")
        out = self.generator.generate(payload.get("prompt", ""), max_tokens=payload.get("max_tokens"),
                                      stop=payload.get("stop"))
        return {**out, "message": "Generation completed successfully"}

    def introspection(self) -> dict:
        sizes = {name: e.batcher.queue_size for name, e in self.engines.items()}
        current = {name: e.batcher.current for name, e in self.engines.items()}
        return {"queue_size": sizes, "current_search": current}

    # ------------------------------------------------------------ http
    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def _send(self, code: int, payload: dict):
                blob = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                info = server_self.introspection()
                if self.path.startswith("/current_search"):
                    self._send(200, {"current_search": info["current_search"]})
                elif self.path.startswith("/queue_size"):
                    self._send(200, {"queue_size": info["queue_size"]})
                elif self.path.startswith("/health"):
                    self._send(200, {"status": "ok"})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    if self.path.startswith("/search"):
                        self._send(200, server_self.handle_search(payload))
                    elif self.path.startswith("/generate"):
                        self._send(200, server_self.handle_generate(payload))
                    else:
                        self._send(404, {"error": "not found"})
                except TimeoutError as e:
                    self._send(504, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    logger.exception("request failed")
                    self._send(500, {"error": str(e)})

        return Handler

    def serve(self, port: int | None = None, registry_path: str | None = None, domain_name: str = "default",
              chunk_id=0, block: bool = True) -> int:
        self.port = port or find_free_port()
        self.server = ThreadingHTTPServer(("0.0.0.0", self.port), self._make_handler())
        if registry_path:
            host = socket.gethostbyname(socket.gethostname())
            register_endpoint(registry_path, domain_name, chunk_id, f"http://{host}:{self.port}/search")
        logger.info("Serving on port %d", self.port)
        if block:
            self.server.serve_forever()
        else:
            threading.Thread(target=self.server.serve_forever, daemon=True).start()
        return self.port

    def shutdown(self) -> None:
        """Stop the HTTP loop, the engines' batchers and the generator."""
        if self.server:
            self.server.shutdown()
            self.server.server_close()
        for engine in self.engines.values():
            engine.shutdown()
        if self.generator is not None:
            self.generator.shutdown()


def serve_worker_from_config(cfg, device, port: int | None = None, registry_path: str | None = None,
                             block: bool = True) -> SearchAPIServer:
    """Worker entry point (reference: api/serve_worker_node.py __main__) on
    an explicit ``device``. Returns the server (after it stops when
    ``block``, at once otherwise)."""
    from retrieval_scaling_tpu_torch.serve.engine import RetrievalEngine

    domain = os.environ.get("DS_DOMAIN", cfg.datastore.domain)
    num_shards = int(os.environ.get("NUM_SHARDS", cfg.datastore.embedding.num_shards))
    per_worker = int(os.environ.get("NUM_SHARDS_PER_WORKER", num_shards))
    worker_id = int(os.environ.get("WORKER_ID", 0))
    shard_ids = list(range(worker_id * per_worker, min((worker_id + 1) * per_worker, num_shards)))
    serve_cfg = cfg.get("serve", None) or {}
    if int(serve_cfg.get("generation_tensor_parallel", 1)) > 1:
        raise NotImplementedError("serve.generation_tensor_parallel > 1 waits for module 14")

    engine = RetrievalEngine.from_config(cfg, device, index_shard_ids=shard_ids)
    engine.smoke_test()

    # optional /generate: serve.generation_model names a reader checkpoint
    generator = None
    gen_model = serve_cfg.get("generation_model", None)
    if gen_model:
        from retrieval_scaling_tpu_torch.models.hf_convert import load_hf_reader, load_tokenizer
        from retrieval_scaling_tpu_torch.serve.generation import GenerationService

        model = load_hf_reader(gen_model, device=device)
        generator = GenerationService(
            model, model.cfg, load_tokenizer(gen_model),
            slots=int(serve_cfg.get("generation_slots", 4)),
            max_len=int(serve_cfg.get("generation_max_len", 1024)),
            speculative=bool(serve_cfg.get("generation_speculative", False)),
            draft_len=int(serve_cfg.get("generation_draft_len", 7)),
        )

    server = SearchAPIServer({domain: engine}, default_n_docs=cfg.evaluation.search.n_docs, generator=generator)
    server.serve(
        port=port or (serve_cfg.get("port", 0) or None),
        registry_path=registry_path or serve_cfg.get("registry", "running_ports_massiveds.jsonl"),
        domain_name=domain,
        chunk_id=worker_id,
        block=block,
    )
    return server
