"""Prompt-lookup speculative decoding (n-gram drafting, exact greedy).

Ports ``retrieval_scaling_tpu/models/speculative.py``. A round drafts up to
``draft_len`` tokens from the sequence itself (the latest earlier
occurrence of its last ``ngram`` tokens, and what followed it), then
verifies the segment ``[last_token, d_1 .. d_g]`` with one
``forward_with_cache(..., contiguous_writes=True)``: decode is bound by the
weight stream, so scoring g + 1 tokens costs about what scoring one does.
The longest draft prefix that the model's own greedy argmax agrees with is
accepted, then the model's next token as a bonus; the output equals
sequential greedy decoding token for token. ``temperature > 0`` runs
speculative rejection sampling (accept d with probability p(d), resample
the first rejection from the residual), distribution-identical to
sequential ancestral sampling.

On the card the verify forward's attention is K3 with per-query positions
(``ops.flash_attention.flash_decode``): a verify row sums its keys in the
same order as a one-token step, and its projections stay on K6 / K7 (K8 for
int4) while B * (draft_len + 1) <= 128 rows, whose rows do not depend on the
row count either.

The drafter, the acceptance and the emission run on the device, vectorised
over the batch, with no host sync; ``lax.while_loop`` becomes a Python loop
that looks at ``finished`` every 8 rounds only. Rounds run after every row
has finished emit nothing, and ``with_stats`` counts only the rounds that
the JAX loop's condition would have run. Sampling draws from a
``torch.Generator`` seeded from ``seed`` (other draws than ``jax.random``).
"""

from __future__ import annotations

import torch

from retrieval_scaling_tpu_torch.models.generate import _check_reader, embedding, forward_with_cache, init_cache

_FINISHED_CHECK = 8  # rounds between the host's looks at `finished`


def _draft_ngram(all_tokens, last_token, cur_len, ngram: int, draft_len: int):
    """Latest-match prompt lookup, vectorised over the batch.

    all_tokens: [B, T] history with ``last_token`` at index ``cur_len``.
    For the longest n <= ``ngram`` with a match, the latest start p <=
    cur_len - n with ``all_tokens[p : p + n]`` equal to the trailing n-gram;
    returns the ``draft_len`` tokens that follow it [B, draft_len]. With no
    match the clamped gather gives arbitrary history tokens, which the
    verification rejects."""
    b, t = all_tokens.shape
    dev = all_tokens.device
    cur_len = cur_len.long()
    starts_full = torch.arange(t, device=dev)[None, :]
    best_p = torch.full((b,), -1, dtype=torch.long, device=dev)
    best_n = torch.zeros((b,), dtype=torch.long, device=dev)
    for n in range(1, ngram + 1):  # ascending: a longer match overwrites
        n_win = t - n + 1
        tail_idx = cur_len[:, None] + torch.arange(-n + 1, 1, device=dev)[None, :]
        tail = torch.gather(all_tokens, 1, tail_idx.clamp_min(0))
        match = torch.ones((b, n_win), dtype=torch.bool, device=dev)
        for j in range(n):
            match = match & (all_tokens[:, j: j + n_win] == tail[:, j: j + 1])
        starts = starts_full[:, :n_win]
        # the match ends strictly before the trailing n-gram's end (no
        # self-match; overlapping the tail is fine)
        valid = starts <= (cur_len[:, None] - n)
        p = torch.where(match & valid, starts, -1).amax(dim=1)
        best_p = torch.where(p >= 0, p, best_p)
        best_n = torch.where(p >= 0, n, best_n)
    cont_idx = (best_p[:, None] + best_n[:, None] + torch.arange(draft_len, device=dev)[None, :]).clamp(0, t - 1)
    return torch.gather(all_tokens, 1, cont_idx)


def _embeddable(seg, vocab: int):
    """A verify segment's ids as embedding rows: a draft from the history's
    -1 fill (or an eos id of -1) reads row vocab - 1, as the JAX package's
    negative index does; verification rejects such a draft either way."""
    return seg.remainder(vocab)


def greedy_emission(draft, y, pad_id: int = 0):
    """The accept / emit core of both speculative engines.

    draft [B, g]; y [B, g + 1] the model's greedy tokens after each segment
    position. Returns ``(a, stream)``: ``a`` [B] the longest draft prefix the
    model itself would have produced, ``stream`` [B, g + 1] the accepted
    drafts then the bonus token (positions past ``a`` repeat the bonus)."""
    b, g = draft.shape
    agree = draft == y[:, :g]
    a = torch.cumprod(agree.long(), dim=1).sum(dim=1)
    j = torch.arange(g + 1, device=draft.device)[None, :]
    bonus = torch.gather(y, 1, a[:, None])
    cand = torch.cat([draft, torch.full((b, 1), pad_id, dtype=draft.dtype, device=draft.device)], dim=1)
    return a, torch.where(j < a[:, None], cand, bonus)


def make_speculative_generate_fn(cfg, max_new_tokens: int, eos_id: int, draft_len: int = 7, ngram: int = 3,
                                 kv_cache: str | None = None, mesh=None, with_stats: bool = False,
                                 temperature: float = 0.0, param_shardings=None, scripted: bool = False):
    """``(model, prompt_ids, prompt_lens, seed=0[, script_ids]) -> tokens [B, max_new_tokens]``.

    Drop-in for ``make_generate_fn`` with fewer forwards. Greedy
    (``temperature <= 0``) output equals the static engine's token for
    token; ``temperature > 0`` runs speculative rejection sampling.
    ``with_stats``: also return ``(rounds, emitted)`` as 0-d device tensors,
    the verify rounds and the tokens emitted (the first included), whose
    ratio is the realised acceptance. ``scripted``: the function takes
    ``script_ids`` [B, max_new_tokens] and emits exactly those tokens in
    place of the model's argmax, while every verify forward still runs the
    whole model (a measurement of acceptance at a chosen copy rate).
    ``kv_cache="int8"``: quantized cache. ``fn.rounds_run`` holds the verify
    forwards the last call ran (with the rounds past the end of every row)."""
    _check_reader(cfg)
    if kv_cache not in (None, "", "none", "int8"):
        raise ValueError(f"unknown kv_cache {kv_cache!r}")
    g = int(draft_len)
    if g < 1:
        raise ValueError("draft_len must be >= 1")
    sampled = temperature is not None and temperature > 0.0
    if scripted and sampled:
        raise ValueError("scripted emission is greedy-only")
    if mesh is not None or param_shardings is not None:
        raise NotImplementedError("data- and tensor-parallel generation wait for module 14")

    @torch.inference_mode()
    def fn(model, prompt_ids, prompt_lens, seed=0, script_ids=None):
        if scripted and script_ids is None:
            raise ValueError("a scripted function needs script_ids [B, max_new_tokens]")
        device = prompt_ids.device
        b, s_pad = prompt_ids.shape
        max_len = s_pad + max_new_tokens + g + 1  # verify-segment headroom
        if max_len > cfg.max_position_embeddings:
            raise ValueError(f"prompt ({s_pad}) + max_new_tokens ({max_new_tokens}) + draft headroom ({g + 1}) "
                             f"exceeds max_position_embeddings ({cfg.max_position_embeddings})")
        prompt_ids = prompt_ids.long()
        prompt_lens = prompt_lens.to(device=device, dtype=torch.long)
        cache_dtype = torch.int8 if kv_cache == "int8" else embedding(model).weight.dtype
        cache = init_cache(cfg, b, max_len, cache_dtype, device)
        slots = torch.arange(max_len, device=device)

        # prefill, as the static engine's
        positions = slots[:s_pad].expand(b, s_pad)
        key_valid = slots[None, :] < prompt_lens[:, None]
        write_mask = slots[None, :s_pad] < prompt_lens[:, None]
        logits, cache = forward_with_cache(model, cfg, prompt_ids, positions, cache, key_valid, write_mask,
                                           logits_rows=prompt_lens - 1)
        gen = torch.Generator(device=device).manual_seed(int(seed)) if sampled else None
        if scripted:
            script = script_ids.to(device=device, dtype=torch.long)
            first = script[:, 0]
        elif sampled:
            first = torch.multinomial(torch.softmax(logits[:, 0].float() / temperature, dim=-1), 1,
                                      generator=gen)[:, 0]
        else:
            first = logits[:, 0].argmax(dim=-1)

        t_hist = s_pad + max_new_tokens + g + 2
        hist_idx = torch.arange(t_hist, device=device)[None, :]
        all_tokens = torch.zeros((b, t_hist), dtype=torch.long, device=device)
        all_tokens[:, :s_pad] = prompt_ids
        # pads past a row's prompt must not match an n-gram: -1 is no token
        all_tokens = torch.where(hist_idx < prompt_lens[:, None], all_tokens, -1)
        all_tokens = torch.where(hist_idx == prompt_lens[:, None], first[:, None], all_tokens)
        tokens = torch.full((b, max_new_tokens + g + 1), eos_id, dtype=torch.long, device=device)
        tokens[:, 0] = first

        last_token, cur_len = first, prompt_lens
        gen_count = torch.ones((b,), dtype=torch.long, device=device)
        finished = (first == eos_id) | (max_new_tokens <= 1)
        rounds = torch.zeros((), dtype=torch.long, device=device)
        rows = torch.arange(b, device=device)[:, None]
        j = torch.arange(g + 1, device=device)[None, :]
        vocab = embedding(model).weight.shape[0]
        fn.rounds_run = 0
        for step in range(max_new_tokens):
            if step % _FINISHED_CHECK == 0 and bool(finished.all()):
                break
            fn.rounds_run += 1  # verify forwards run, on the host's count
            rounds = rounds + (~finished.all()).long()  # the JAX loop's condition
            n = cur_len
            draft = _draft_ngram(all_tokens, last_token, n, ngram, g)
            seg = torch.cat([last_token[:, None], draft], dim=1)  # [B, g + 1]
            key_valid = slots[None, :] < (n + g + 1)[:, None]
            logits, cache = forward_with_cache(model, cfg, _embeddable(seg, vocab), n[:, None] + j, cache, key_valid,
                                               contiguous_writes=True)
            if sampled:
                # a point-mass drafter: accept d_j with probability p_j(d_j);
                # the first rejection resamples from p_j with d_j zeroed; a
                # full acceptance draws the bonus from p_{g+1}
                probs = torch.softmax(logits.float() / temperature, dim=-1)  # [B, g + 1, V]
                # a draft from the history's -1 fill is no token: probability 0
                pd = torch.gather(probs[:, :g], 2, draft.clamp_min(0)[..., None])[..., 0]
                pd = torch.where(draft >= 0, pd, 0.0)
                acc = torch.rand((b, g), generator=gen, device=device) < pd
                a = torch.cumprod(acc.long(), dim=1).sum(dim=1)
                p_last = torch.gather(probs, 1, a[:, None, None].expand(b, 1, probs.shape[-1]))[:, 0]
                rej_tok = torch.gather(draft, 1, a.clamp_max(g - 1)[:, None])[:, 0]
                token = torch.arange(p_last.shape[-1], device=device)[None, :]
                p_res = torch.where((a < g)[:, None] & (token == rej_tok[:, None]), 0.0, p_last)
                repl = torch.multinomial(p_res, 1, generator=gen)[:, 0]
                cand = torch.cat([draft, torch.zeros((b, 1), dtype=torch.long, device=device)], dim=1)
                stream = torch.where(j < a[:, None], cand, repl[:, None])
            else:
                if scripted:
                    # the "model's" tokens are the script at the emission
                    # offset; the forward above still ran the whole model
                    y = torch.gather(script, 1, (gen_count[:, None] + j).clamp(0, script.shape[1] - 1))
                else:
                    y = logits.argmax(dim=-1)  # [B, g + 1]
                a, stream = greedy_emission(draft, y)
            rem = (max_new_tokens - gen_count).clamp_min(1)
            emit = torch.where(finished, 0, torch.minimum(a + 1, rem))  # accepted + bonus
            # the stream's first `emit` tokens, eos after them; finished rows
            # emit nothing; the first emitted eos covers the rest
            e = torch.where((j < emit[:, None]) & ~finished[:, None], stream, eos_id)
            is_eos = (e == eos_id) & (j < emit[:, None])
            prior_eos = torch.cumsum(is_eos.long(), dim=1) - is_eos.long()
            e = torch.where(prior_eos > 0, eos_id, e)
            tokens[rows, gen_count[:, None] + j] = e
            all_tokens[rows, n[:, None] + 1 + j] = e
            new_last = torch.gather(e, 1, (emit - 1).clamp_min(0)[:, None])[:, 0]
            last_token = torch.where(finished, last_token, new_last)
            gen_count = gen_count + emit
            finished = finished | is_eos.any(dim=1) | (gen_count >= max_new_tokens)
            cur_len = n + emit
        out = tokens[:, :max_new_tokens]
        if with_stats:
            return out, rounds, gen_count.sum()
        return out

    fn.rounds_run = 0
    return fn
