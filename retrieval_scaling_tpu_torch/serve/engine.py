"""Online retrieval engine: micro-batched encode + search + passage fetch.

Ports ``retrieval_scaling_tpu/serve/engine.py``. Concurrent requests are
collected for up to ``max_wait_ms`` (or until ``max_batch``), encoded and
searched as one batch on the worker's device, then fanned back out to their
waiters. With a two-stage index (``search_ids`` + ``get_retrieved_passages``)
the host passage fetch of batch N runs on a second thread while batch N+1
is encoded and scanned. ``RetrievalEngine`` is the ``DatastoreAPI`` analog
(reference: api/api_index.py:21-95).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class _Pending:
    query: str
    n_docs: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


class MicroBatcher:
    """Collect concurrent requests into device-sized batches.

    ``process_fn(queries, n_docs) -> results`` runs on the worker thread;
    a batch is searched at the largest ``n_docs`` asked and each caller's
    result is cut to its own. With ``finish_fn``, ``process_fn`` returns a
    staged intermediate that ``finish_fn`` completes on a second thread.
    """

    def __init__(self, process_fn: Callable[[List[str], int], List[Any]], max_batch: int = 32,
                 max_wait_ms: float = 5.0, timeout_s: float = 60.0,
                 finish_fn: Optional[Callable[[List[str], int, Any], List[Any]]] = None):
        self._process = process_fn
        self._finish = finish_fn
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.timeout_s = timeout_s
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._finish_queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self.current: Optional[str] = None
        self._threads = [threading.Thread(target=self._loop, daemon=True)]
        if finish_fn is not None:
            self._threads.append(threading.Thread(target=self._finish_loop, daemon=True))
        for t in self._threads:
            t.start()

    @property
    def queue_size(self) -> int:
        return self._queue.qsize()

    def submit(self, query: str, n_docs: int) -> Any:
        item = _Pending(query, n_docs)
        self._queue.put(item)
        if not item.done.wait(self.timeout_s):
            raise TimeoutError(f"search timed out after {self.timeout_s}s")
        if item.error is not None:
            raise item.error
        return item.result

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)

    def _collect(self) -> List[_Pending]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _fail(self, batch: List[_Pending], error: BaseException) -> None:
        for item in batch:
            item.error = error
            item.done.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            self.current = batch[0].query
            n_docs = max(item.n_docs for item in batch)
            try:
                staged = self._process([item.query for item in batch], n_docs)
                if self._finish is not None:
                    self._finish_queue.put((batch, n_docs, staged))
                else:
                    self._complete(batch, staged)
            except BaseException as e:  # propagate to the waiters
                logger.exception("batch search failed")
                self._fail(batch, e)
            finally:
                self.current = None

    def _finish_loop(self) -> None:
        while not self._stop.is_set():
            try:
                batch, n_docs, staged = self._finish_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._complete(batch, self._finish([item.query for item in batch], n_docs, staged))
            except BaseException as e:
                logger.exception("batch finish failed")
                self._fail(batch, e)

    def _complete(self, batch: List[_Pending], results: List[Any]) -> None:
        for item, res in zip(batch, results):
            item.result = {key: val[: item.n_docs] for key, val in res.items()}
            item.done.set()


class RetrievalEngine:
    """Encoder + index + passage store for one datastore (or shard group)."""

    def __init__(self, encoder, index, encode_opts=None, max_batch: int = 32, max_wait_ms: float = 5.0,
                 timeout_s: float = 60.0):
        from retrieval_scaling_tpu_torch.search.encoder import EncodeOptions

        self.encoder = encoder
        self.index = index
        self.encode_opts = encode_opts or EncodeOptions(batch_size=max_batch, maxlength=512)
        self.batcher = MicroBatcher(self._device_batch, max_batch, max_wait_ms, timeout_s=timeout_s,
                                    finish_fn=self._finish_batch)

    @classmethod
    def from_config(cls, cfg, device, index_shard_ids=None, encoder=None):
        from retrieval_scaling_tpu_torch.index.base import Indexer
        from retrieval_scaling_tpu_torch.search.encoder import EncodeOptions, load_encoder, projection_out_dim

        if encoder is None:
            encoder = load_encoder(cfg.model.query_encoder, device, tokenizer_name=cfg.model.query_tokenizer)
        indexer = Indexer(cfg, device, index_shard_ids=index_shard_ids)
        search = cfg.evaluation.search
        opts = EncodeOptions(
            batch_size=search.get("per_device_batch_size", 32),
            maxlength=search.get("question_maxlength", 512),
            lowercase=search.get("lowercase", False),
            normalize_text=search.get("normalize_text", False),
            out_dim=projection_out_dim(cfg, encoder),
        )
        serve_cfg = cfg.get("serve", None) or {}
        # per-request timeout: the reference's 60 s worker timer, configurable
        return cls(
            encoder, indexer.datastore, encode_opts=opts,
            max_batch=int(serve_cfg.get("max_batch_size", 32)),
            max_wait_ms=float(serve_cfg.get("batch_timeout_ms", 5.0)),
            timeout_s=float(serve_cfg.get("request_timeout_s", 60.0)),
        )

    def _device_batch(self, queries: List[str], n_docs: int):
        embeddings = self.encoder.encode(queries, self.encode_opts)
        if not hasattr(self.index, "search_ids"):
            # single-stage index (no separable passage fetch): finish inline
            scores, passages, ids = self.index.search(embeddings, n_docs)
            return [{"scores": list(s), "passages": list(p), "IDs": list(i)}
                    for s, p, i in zip(scores, passages, ids)]
        return self.index.search_ids(embeddings, n_docs)

    def _finish_batch(self, queries: List[str], n_docs: int, staged) -> List[Dict[str, list]]:
        if isinstance(staged, list):  # already finished by the device stage
            return staged
        from retrieval_scaling_tpu_torch.index.flat import filter_pad_hits

        scores, id_rows = filter_pad_hits(*staged)
        passages, ids = self.index.get_retrieved_passages(id_rows)
        return [{"scores": list(s), "passages": list(p), "IDs": list(i)} for s, p, i in zip(scores, passages, ids)]

    # ------------------------------------------------------------ api
    def search(self, query: str, n_docs: int = 10) -> Dict[str, list]:
        """One query through the micro-batcher (thread-safe)."""
        return self.batcher.submit(query, n_docs)

    def search_batch(self, queries: List[str], n_docs: int = 10) -> List[Dict[str, list]]:
        """Direct batched search (bypasses the batcher; for bulk clients)."""
        return self._finish_batch(queries, n_docs, self._device_batch(queries, n_docs))

    def smoke_test(self, query: str = "when was the moon landing?") -> Dict[str, list]:
        """Startup self-check (reference: api/api_index.py:70-86)."""
        out = self.search(query, 3)
        logger.info("smoke test scores: %s IDs: %s", out["scores"], out["IDs"])
        return out

    def shutdown(self) -> None:
        self.batcher.shutdown()
