"""Serving-side generation service over the continuous-batching engine.

Ports ``retrieval_scaling_tpu/serve/generation.py``: one background thread
owns the slot pool and runs the admission / decode loop; HTTP handler
threads enqueue requests and wait on a per-request event, so concurrent
requests share decode steps. The thread works on the model's device
(``torch.cuda.device`` of it on a card), never on an implicit one. With
``speculative`` the loop dispatches the engine's speculative chunks
(draft-and-verify rounds of ``draft_len`` tokens), whose streams equal the
greedy ones; the JAX loop dispatched greedy chunks whatever the flag.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from retrieval_scaling_tpu_torch.models.continuous_batching import (
    ContinuousBatcher,
    clamp_request,
    host_values,
    to_host_async,
)

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    prompt_ids: List[int]
    max_new: int
    stop: List[str]
    done: threading.Event = field(default_factory=threading.Event)
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    error: Optional[str] = None


class GenerationService:
    """Background-threaded continuous-batching text generation."""

    def __init__(self, model, cfg, tokenizer, slots: int = 4, max_len: int = 1024, chunk: int = 8,
                 default_max_new: int = 64, speculative: bool = False, draft_len: int = 7, mesh=None):
        self.tokenizer = tokenizer
        self.default_max_new = default_max_new
        eos = tokenizer.eos_token_id
        if eos is None:
            eos = tokenizer.pad_token_id or 0
        self.eos_id = int(eos)
        self.engine = ContinuousBatcher(model, cfg, self.eos_id, slots=slots, max_len=max_len, chunk=chunk,
                                        speculative=speculative, draft_len=draft_len, mesh=mesh)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._shutdown = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public
    def generate(self, prompt: str, max_tokens: int | None = None, stop: Optional[List[str]] = None,
                 timeout_s: float = 120.0) -> dict:
        max_new = int(max_tokens or self.default_max_new)
        ids = self.tokenizer(prompt)["input_ids"]
        ids = ids[-(self.engine.max_len - max_new):]
        req = _Request(prompt_ids=ids, max_new=max_new, stop=list(stop or []))
        self._queue.put(req)
        if not req.done.wait(timeout_s):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return {"text": req.text, "n_tokens": len(req.tokens)}

    def shutdown(self):
        self._shutdown.set()
        self._queue.put(None)  # wake the loop
        self._thread.join(timeout=5)

    # ------------------------------------------------------------ loop
    def _decode_text(self, toks: List[int]) -> str:
        return self.tokenizer.decode([t for t in toks if t != self.eos_id], skip_special_tokens=True)

    def _finish(self, req: _Request):
        toks = req.tokens
        if self.eos_id in toks:
            toks = toks[: toks.index(self.eos_id)]
        text = self._decode_text(toks)
        for stop in req.stop:
            idx = text.find(stop)
            if idx >= 0:
                text = text[:idx]
        req.tokens = toks
        req.text = text
        req.done.set()

    def _run(self):
        device = self.engine.device
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            self._loop()

    def _loop(self):
        eng = self.engine
        free = list(range(eng.slots))
        active: dict = {}  # slot -> _Request
        # decode state chains between dispatches as device tensors; up to
        # eng.depth chunks stay in flight (ContinuousBatcher.generate's scheme)
        last_d, cur_d = eng.initial_state()
        seq = 0
        valid_from = [0] * eng.slots
        inflight: deque = deque()

        while not self._shutdown.is_set():
            # admit: block when idle, drain when busy; every drained request
            # joins one admission wave (one batched prefill)
            wave = []
            while free:
                idle = not active and not inflight and not wave
                try:
                    req = self._queue.get(block=idle, timeout=1.0 if idle else None)
                except queue.Empty:
                    break
                if req is None:
                    return
                prompt, max_new, _ = clamp_request(req.prompt_ids, req.max_new, eng.max_len - eng.headroom)
                req.max_new = max_new
                slot = free.pop()
                wave.append((slot, prompt))
                valid_from[slot] = seq
                req.tokens = []
                active[slot] = req
            if wave:
                try:
                    last_d, cur_d = eng.admit_wave(wave, last_d, cur_d)
                except Exception as e:  # noqa: BLE001
                    logger.exception("admission wave failed")
                    for slot, _ in wave:
                        req = active.pop(slot)
                        free.append(slot)  # never leak capacity on failure
                        req.error = str(e)
                        req.done.set()
            if not active:
                # trailing in-flight chunks hold junk for finished slots
                inflight.clear()
                continue
            while len(inflight) < eng.depth:
                last_d, cur_d, toks, counts, _ = eng.run_chunk(last_d, cur_d, eng.chunk)
                inflight.append((seq, to_host_async(toks), None if counts is None else to_host_async(counts)))
                seq += 1
            s, handle, counts_handle = inflight.popleft()
            toks_np = host_values(handle)
            counts_np = None if counts_handle is None else host_values(counts_handle)
            eng.count_rounds(counts_np, [slot for slot in active if valid_from[slot] <= s])
            for slot in list(active):
                if valid_from[slot] > s:
                    continue  # the chunk predates this slot's admission
                req = active[slot]
                # column 0 is real for the slot's first valid chunk only
                fresh = valid_from[slot] == s and not req.tokens
                done = False
                for t in eng.chunk_tokens(toks_np, counts_np, slot, fresh):
                    req.tokens.append(int(t))
                    if int(t) == self.eos_id or len(req.tokens) >= req.max_new:
                        done = True
                        break
                if not done and req.stop:
                    # a tail window: decoding the whole text per chunk is O(n^2)
                    text = self._decode_text(req.tokens[-48:])
                    done = any(st in text for st in req.stop)
                if done:
                    self._finish(req)
                    del active[slot]
                    free.append(slot)
