"""Slot-based continuous-batching generation engine (the vLLM analog).

Ports ``retrieval_scaling_tpu/models/continuous_batching.py`` (greedy; the
speculative rounds wait for ``models/speculative.py``):

* a fixed KV slot pool ``[slots, H, max_len, hd]`` per layer (``num_kv_heads``
  heads for the llama family), updated in place;
* admission waves: every admissible request joins one batched prefill
  whose K/V and first token are scattered into the pool;
* decode chunks: a Python loop of ``length`` single-token steps over every
  slot; the tokens stay on the device and each chunk is copied to the host
  once, without blocking (pinned buffer plus an event), so up to
  ``pipeline_depth`` chunks are in flight while the host assembles earlier
  ones;
* eager slot turnover (a slot re-admits once its budget is in flight) and
  LPT admission (largest decode budget first).

A chunk dispatched before a slot's (re)admission carries junk for that
slot, which the assembly records filter; free slots step harmlessly and
their stale writes are overwritten or masked out. The JAX compile buckets
(power-of-two waves) are not needed: each wave prefills just its requests.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from retrieval_scaling_tpu_torch.models.generate import embedding, forward_with_cache, init_cache

logger = logging.getLogger(__name__)


def _bucket(length: int, cap: int) -> int:
    b = 32
    while b < length:
        b *= 2
    return min(b, max(cap, 1))


def clamp_request(prompt_ids, max_new: int, max_len: int, min_prompt: int = 16):
    """(prompt, max_new, prefill_width) with the pool's invariants: the
    prompt fits its bucket, prompt_len + max_new <= max_len, and at least
    ``min_prompt`` prompt tokens survive a max_new >= max_len request."""
    max_new = max(int(max_new), 1)
    budget = max_len - max_new
    if budget < min_prompt:
        budget = min(min_prompt, max_len - 1)
        max_new = max_len - budget
    prompt = list(prompt_ids)[-budget:]
    width = _bucket(len(prompt), budget)
    assert width >= len(prompt)
    return prompt, max_new, width


def to_host_async(t: torch.Tensor):
    """(host tensor, event): a non-blocking device-to-host copy of ``t``;
    wait on the event (None on the CPU) before reading the host tensor."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def host_values(handle):
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


class ContinuousBatcher:
    """Token-level continuous-batching generator.

    ``generate(requests)`` takes ``[(prompt_ids, max_new_tokens), ...]`` and
    returns a token-id list per request (eos excluded). ``stop_check(i,
    tokens) -> bool`` finishes request ``i`` early (stop strings); it is
    checked once per decode chunk.
    """

    def __init__(self, model, cfg, eos_id: int, slots: int = 8, max_len: int = 2048, chunk: int = 16,
                 dtype=None, speculative: bool = False, mesh=None, pipeline_depth: int = 4):
        if speculative:
            raise NotImplementedError("speculative rounds wait for models/speculative.py")
        if mesh is not None:
            raise NotImplementedError("tensor-parallel slot pools wait for module 14")
        self.model, self.cfg = model, cfg
        self.eos_id = int(eos_id)
        self.slots = int(slots)
        self.max_len = min(int(max_len), cfg.max_position_embeddings)
        self.chunk = int(chunk)
        self.depth = max(1, int(pipeline_depth))
        self.device = embedding(model).weight.device
        dtype = dtype or embedding(model).weight.dtype  # as make_generate_fn: the embedding's
        self.pool = init_cache(cfg, self.slots, self.max_len, dtype=dtype, device=self.device)
        self._slot_pos = torch.arange(self.max_len, device=self.device)
        self.stats = {"decode_chunks": 0, "prefills": 0, "slot_steps": 0}
        # the scheduler picks the largest length not above the smallest
        # remaining budget, so chunks never overshoot a known budget
        self._chunk_buckets = sorted({c for c in (4, 8, 16, 32, 64, 128) if c <= self.chunk} | {self.chunk})

    # ------------------------------------------------------------ device work
    @torch.inference_mode()
    def decode_chunk(self, last, cur_len, length: int):
        """``length`` greedy steps over every slot. Returns (last, cur_len,
        tokens [slots, 1 + length]); column 0 is the chunk's input token (a
        freshly admitted slot's first generated token)."""
        seed, toks = last, []
        for _ in range(length):
            pos = cur_len.clamp_max(self.max_len - 1)[:, None]
            key_valid = self._slot_pos[None, :] <= pos
            logits, _ = forward_with_cache(self.model, self.cfg, last[:, None], pos, self.pool, key_valid)
            last = logits[:, 0].argmax(dim=-1)
            toks.append(last)
            cur_len = cur_len + 1
        self.stats["decode_chunks"] += 1
        self.stats["slot_steps"] += length * self.slots
        return last, cur_len, torch.stack([seed] + toks, dim=1)

    @torch.inference_mode()
    def admit_wave(self, entries, last_d, cur_d):
        """Admit ``entries = [(slot, prompt_ids), ...]``: one batched prefill
        and a scatter of its K/V, first token and length into the pool.
        Returns the updated (last, cur_len) device tensors."""
        if not entries:
            return last_d, cur_d
        wave = len(entries)
        width = _bucket(max(len(p) for _, p in entries), self.max_len)
        ids = torch.full((wave, width), self.eos_id, dtype=torch.long)
        lens = torch.ones((wave,), dtype=torch.long)
        for j, (_, prompt) in enumerate(entries):
            ids[j, : len(prompt)] = torch.as_tensor(prompt, dtype=torch.long)
            lens[j] = len(prompt)
        ids, lens = ids.to(self.device), lens.to(self.device)
        slot_idx = torch.as_tensor([slot for slot, _ in entries], dtype=torch.long, device=self.device)
        cache = init_cache(self.cfg, wave, width, dtype=self.pool.k[0].dtype, device=self.device)
        positions = self._slot_pos[:width].expand(wave, width)
        key_valid = self._slot_pos[None, :width] < lens[:, None]
        logits, cache = forward_with_cache(self.model, self.cfg, ids, positions, cache, key_valid, key_valid,
                                           logits_rows=lens - 1)
        first = logits[:, 0].argmax(dim=-1)
        parts = [(self.pool.k, cache.k), (self.pool.v, cache.v)]
        if self.pool.k_scale is not None:
            parts += [(self.pool.k_scale, cache.k_scale), (self.pool.v_scale, cache.v_scale)]
        for pool_layers, wave_layers in parts:
            for pl, wl in zip(pool_layers, wave_layers):
                pl[slot_idx, :, :width] = wl
        last_d, cur_d = last_d.clone(), cur_d.clone()
        last_d[slot_idx] = first
        cur_d[slot_idx] = lens
        self.stats["prefills"] += wave
        return last_d, cur_d

    def initial_state(self):
        return (torch.full((self.slots,), self.eos_id, dtype=torch.long, device=self.device),
                torch.zeros((self.slots,), dtype=torch.long, device=self.device))

    # ------------------------------------------------------------ schedule
    def generate(self, requests: Sequence[Tuple[List[int], int]],
                 stop_check: Optional[Callable[[int, List[int]], bool]] = None,
                 on_finish: Optional[Callable[[int], None]] = None) -> List[List[int]]:
        """Pipelined scheduler: device state chains between dispatches, up
        to ``self.depth`` decode chunks stay in flight, and the host waits
        only on token copies. A slot frees once its schedule covers its
        request's budget; the remaining tokens are assembled later from the
        in-flight chunks, routed by chunk sequence number."""
        n = len(requests)
        results: List[Optional[List[int]]] = [None] * n
        # LPT: the largest decode budget is admitted first (popped from the back)
        pending = sorted(range(n), key=lambda i: (requests[i][1], len(requests[i][0])))
        free = list(range(self.slots))
        cur: dict = {}  # slot -> request being scheduled on it
        last_d, cur_d = self.initial_state()
        budget = [0] * n
        seq = 0
        inflight: deque = deque()  # (seq, host handle of the chunk's tokens)
        sched = [0] * self.slots   # tokens scheduled for the slot's current request
        # per slot, in admission order: [admission seq, request, tokens, done]
        recs: List[List[list]] = [[] for _ in range(self.slots)]
        unfinished = 0

        def complete(rec):
            nonlocal unfinished
            rec[3] = True
            unfinished -= 1
            toks = rec[2]
            if self.eos_id in toks:
                toks = toks[: toks.index(self.eos_id)]
            results[rec[1]] = toks
            if on_finish is not None:
                on_finish(rec[1])

        def admit():
            nonlocal last_d, cur_d, unfinished
            entries = []
            while pending and free:
                i = pending.pop()
                prompt, max_new, _ = clamp_request(requests[i][0], requests[i][1], self.max_len)
                slot = free.pop()
                entries.append((slot, prompt))
                cur[slot] = i
                budget[i] = max_new
                recs[slot].append([seq, i, [], False])
                unfinished += 1
                sched[slot] = 1  # the first token comes from the prefill
            last_d, cur_d = self.admit_wave(entries, last_d, cur_d)

        def pick_chunk_len() -> int:
            remaining = [budget[cur[sl]] - sched[sl] for sl in cur if budget[cur[sl]] > sched[sl]]
            if not remaining:
                return self._chunk_buckets[0]
            need = min(remaining)
            return max([c for c in self._chunk_buckets if c <= need] or [self._chunk_buckets[0]])

        def need_more() -> bool:
            return any(budget[cur[sl]] > sched[sl] for sl in cur)

        def dispatch():
            nonlocal seq, last_d, cur_d
            length = pick_chunk_len()
            last_d, cur_d, toks = self.decode_chunk(last_d, cur_d, length)
            for sl in cur:
                sched[sl] += length
            inflight.append((seq, to_host_async(toks)))
            seq += 1
            for sl in [s for s in cur if sched[s] >= budget[cur[s]]]:  # eager turnover
                del cur[sl]
                free.append(sl)
            admit()

        admit()
        while unfinished or cur:
            while len(inflight) < self.depth and (need_more() or not inflight):
                dispatch()
            if not inflight:
                break
            s, handle = inflight.popleft()
            toks_np = host_values(handle)
            for slot in range(self.slots):
                rec = None
                for r in recs[slot]:
                    if r[0] <= s:
                        rec = r  # the newest record whose window covers chunk s
                    else:
                        break
                if rec is None or rec[3]:
                    continue
                i = rec[1]
                # a record's first chunk carries its first token in column 0;
                # later chunks repeat an emitted token there
                fresh = rec[0] == s and not rec[2]
                done = False
                for t in (toks_np[slot] if fresh else toks_np[slot, 1:]):
                    rec[2].append(int(t))
                    if int(t) == self.eos_id or len(rec[2]) >= budget[i]:
                        done = True
                        break
                if not done and stop_check and stop_check(i, rec[2]):
                    done = True
                if done:
                    complete(rec)
                    if cur.get(slot) == i:  # eos or a stop string beat the schedule
                        del cur[slot]
                        free.append(slot)
            admit()
        inflight.clear()
        return [r if r is not None else [] for r in results]
