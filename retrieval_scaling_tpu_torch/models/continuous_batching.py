"""Slot-based continuous-batching generation engine (the vLLM analog).

Ports ``retrieval_scaling_tpu/models/continuous_batching.py``, greedy and
speculative:

* a fixed KV slot pool ``[slots, H, max_len, hd]`` per layer (``num_kv_heads``
  heads for the llama family), updated in place;
* admission waves: every admissible request is prefilled alone at its own
  length (so its first token does not depend on the other requests of its
  wave) and its K/V and first token are scattered into the pool;
* decode chunks: a Python loop of ``length`` single-token steps over every
  slot; the tokens stay on the device and each chunk is copied to the host
  once, without blocking (pinned buffer plus an event), so up to
  ``pipeline_depth`` chunks are in flight while the host assembles earlier
  ones;
* speculative chunks (``speculative=True``): R = max(1, chunk // 4) rounds of
  prompt-lookup drafting and one verify forward over every slot
  (``models/speculative.py``), each round emitting 1 to draft_len + 1 greedy
  tokens a slot; verify segments stay inside the pool (the pool keeps
  draft_len + 1 positions of headroom, and a stale slot's segment is
  clamped), and a per-slot token history (-1 = no token), written by the
  admission waves and the rounds, feeds the drafter;
* eager slot turnover (a slot re-admits once its budget is in flight) and
  LPT admission (largest decode budget first).

A chunk dispatched before a slot's (re)admission carries junk for that
slot, which the assembly records filter; free slots step harmlessly and
their stale writes are overwritten or masked out. The JAX compile buckets
(power-of-two waves, a shared padded width) are not needed: each request
is prefilled at its own length.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from retrieval_scaling_tpu_torch.models.generate import embedding, forward_with_cache, init_cache
from retrieval_scaling_tpu_torch.models.speculative import _draft_ngram, _embeddable, greedy_emission

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
    checked once per decode chunk. ``speculative``: each chunk runs
    ``self.rounds`` draft-and-verify rounds (``draft_len``, ``ngram``); the
    streams stay exact greedy, and ``stats["spec_rounds"]`` /
    ``["spec_emitted"]`` count the live slots' rounds and tokens.
    """

    def __init__(self, model, cfg, eos_id: int, slots: int = 8, max_len: int = 2048, chunk: int = 16,
                 dtype=None, speculative: bool = False, draft_len: int = 7, ngram: int = 3, mesh=None,
                 pipeline_depth: int = 4):
        if mesh is not None:
            raise NotImplementedError("tensor-parallel slot pools wait for module 14")
        self.model, self.cfg = model, cfg
        self.eos_id = int(eos_id)
        self.slots = int(slots)
        self.max_len = min(int(max_len), cfg.max_position_embeddings)
        self.chunk = int(chunk)
        self.depth = max(1, int(pipeline_depth))
        # a verify segment writes draft_len + 1 positions past a slot's last
        # token: the usable budget shrinks so that it stays inside the pool
        self.speculative = bool(speculative)
        self.draft_len, self.ngram = int(draft_len), int(ngram)
        self.headroom = self.draft_len + 1 if self.speculative else 0
        if self.speculative and (self.draft_len < 1 or self.headroom + 32 > self.max_len):
            raise ValueError(f"draft_len={self.draft_len} leaves no usable context in max_len={self.max_len} "
                             f"(need draft_len+33 <= max_len)")
        self.rounds = max(1, self.chunk // 4)  # verify rounds per speculative chunk
        self.device = embedding(model).weight.device
        dtype = dtype or embedding(model).weight.dtype  # as make_generate_fn: the embedding's
        self.pool = init_cache(cfg, self.slots, self.max_len, dtype=dtype, device=self.device)
        self._slot_pos = torch.arange(self.max_len, device=self.device)
        self.stats = {"decode_chunks": 0, "prefills": 0, "slot_steps": 0, "spec_rounds": 0, "spec_emitted": 0}
        # per-slot token history for the n-gram drafter (-1 = no token)
        self.hist = (torch.full((self.slots, self.max_len), -1, dtype=torch.long, device=self.device)
                     if self.speculative else None)
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
    def spec_chunk(self, last, cur_len):
        """``self.rounds`` draft-and-verify rounds over every slot. Returns
        (last, cur_len, tokens [slots, 1 + R, g + 1], counts [slots, 1 + R]):
        round r of a slot emitted ``tokens[slot, r, :counts[slot, r]]``; round
        0 is the chunk's input token with a count of 1."""
        g = self.draft_len
        rows = torch.arange(self.slots, device=self.device)[:, None]
        j = torch.arange(g + 1, device=self.device)[None, :]
        seed, toks, counts = last, [], []
        for _ in range(self.rounds):
            # a stale free slot's segment is kept inside the pool; a live slot
            # never needs the clamp (clamp_request reserves the headroom)
            n = cur_len.clamp_max(self.max_len - g - 1)
            draft = _draft_ngram(self.hist, last, n, self.ngram, g)
            seg = _embeddable(torch.cat([last[:, None], draft], dim=1), embedding(self.model).weight.shape[0])
            key_valid = self._slot_pos[None, :] < (n + g + 1)[:, None]
            logits, _ = forward_with_cache(self.model, self.cfg, seg, n[:, None] + j, self.pool, key_valid,
                                           contiguous_writes=True)
            a, e = greedy_emission(draft, logits.argmax(dim=-1))
            last = e[:, g]  # positions at and past a repeat the bonus token
            # the history write starts at n + 1, clamped inside the row as the
            # JAX dynamic_update_slice clamps it
            off = (n + 1).clamp_max(self.max_len - g - 1)
            self.hist[rows, off[:, None] + j] = e
            cur_len = n + a + 1
            toks.append(e)
            counts.append(a + 1)
        self.stats["decode_chunks"] += 1
        self.stats["slot_steps"] += self.rounds * self.slots
        seed_round = seed[:, None, None].expand(self.slots, 1, g + 1)
        ones = torch.ones((self.slots, 1), dtype=torch.long, device=self.device)
        return (last, cur_len, torch.cat([seed_round, torch.stack(toks, dim=1)], dim=1),
                torch.cat([ones, torch.stack(counts, dim=1)], dim=1))

    def run_chunk(self, last, cur_len, length: int):
        """One dispatch: a greedy chunk of ``length`` steps or, speculative, a
        chunk of ``self.rounds`` rounds. Returns (last, cur_len, tokens,
        counts or None, tokens guaranteed to each live slot)."""
        if self.speculative:
            return (*self.spec_chunk(last, cur_len), self.rounds)  # >= 1 token a round
        return (*self.decode_chunk(last, cur_len, length), None, length)

    @staticmethod
    def chunk_tokens(toks_np, counts_np, slot: int, fresh: bool):
        """The tokens a chunk emitted for ``slot``; column / round 0 (the
        chunk's input token) only when ``fresh``."""
        if counts_np is None:
            return toks_np[slot] if fresh else toks_np[slot, 1:]
        return [t for r in range(0 if fresh else 1, toks_np.shape[1]) for t in toks_np[slot, r, : counts_np[slot, r]]]

    def count_rounds(self, counts_np, live_slots) -> None:
        """Acceptance over the slots whose tokens the chunk really carried
        (round 0 is bookkeeping)."""
        if counts_np is not None and live_slots:
            self.stats["spec_rounds"] += self.rounds * len(live_slots)
            self.stats["spec_emitted"] += int(counts_np[live_slots, 1:].sum())

    @torch.inference_mode()
    def admit_wave(self, entries, last_d, cur_d):
        """Admit ``entries = [(slot, prompt_ids), ...]``: each prompt is
        prefilled alone at its own length, as the static engine prefills a
        lone request, and its K/V, first token and length are scattered into
        the pool. A request's first token so does not depend on which other
        requests share its wave (a batched, padded prefill changes the f32
        products' shapes, and an f32 reader's K1 inputs are rounded to bf16,
        so a near tie could break either way). Slots past a prompt keep stale
        K/V, which every step writes before it reads. Returns the updated
        (last, cur_len) device tensors."""
        if not entries:
            return last_d, cur_d
        last_d, cur_d = last_d.clone(), cur_d.clone()
        for slot, prompt in entries:
            n = len(prompt)
            ids = torch.as_tensor([prompt], dtype=torch.long, device=self.device)
            cache = init_cache(self.cfg, 1, n, dtype=self.pool.k[0].dtype, device=self.device)
            every = torch.ones((1, n), dtype=torch.bool, device=self.device)
            logits, cache = forward_with_cache(self.model, self.cfg, ids, self._slot_pos[None, :n], cache, every, every,
                                               logits_rows=torch.full((1,), n - 1, device=self.device))
            first = logits[0, 0].argmax()
            parts = [(self.pool.k, cache.k), (self.pool.v, cache.v)]
            if self.pool.k_scale is not None:
                parts += [(self.pool.k_scale, cache.k_scale), (self.pool.v_scale, cache.v_scale)]
            for pool_layers, new_layers in parts:
                for pl, nl in zip(pool_layers, new_layers):
                    pl[slot, :, :n] = nl[0]
            if self.hist is not None:
                # the drafter's history: the prompt, then the first token, then -1
                self.hist[slot] = -1
                self.hist[slot, :n] = ids[0]
                self.hist[slot, n] = first
            last_d[slot] = first
            cur_d[slot] = n
        self.stats["prefills"] += len(entries)
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
        inflight: deque = deque()  # (seq, host handles of the chunk's tokens and counts)
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
                prompt, max_new, _ = clamp_request(requests[i][0], requests[i][1], self.max_len - self.headroom)
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
            last_d, cur_d, toks, counts, guaranteed = self.run_chunk(last_d, cur_d, pick_chunk_len())
            for sl in cur:
                sched[sl] += guaranteed
            inflight.append((seq, to_host_async(toks), None if counts is None else to_host_async(counts)))
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
            s, handle, counts_handle = inflight.popleft()
            toks_np = host_values(handle)
            counts_np = None if counts_handle is None else host_values(counts_handle)
            live_slots = []
            for slot in range(self.slots):
                rec = None
                for r in recs[slot]:
                    if r[0] <= s:
                        rec = r  # the newest record whose window covers chunk s
                    else:
                        break
                if rec is None or rec[3]:
                    continue
                live_slots.append(slot)
                i = rec[1]
                # a record's first chunk carries its first token in column 0;
                # later chunks repeat an emitted token there
                fresh = rec[0] == s and not rec[2]
                done = False
                for t in self.chunk_tokens(toks_np, counts_np, slot, fresh):
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
            self.count_rounds(counts_np, live_slots)
            admit()
        inflight.clear()
        return [r if r is not None else [] for r in results]
