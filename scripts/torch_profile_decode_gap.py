#!/usr/bin/env python3
"""The gap between the port's int8 Pythia-1B decode step and its weight
stream, on one GPU: the PyTorch port's counterpart of
scripts/profile_decode_gap.py (S5).

    python3 scripts/torch_profile_decode_gap.py [--iters 20] [--batch 8] [--prompt 32] [--seed 0]

A random Pythia-1B (16 x 2048, made on the card from --seed) in the int8
scheme (``quantize_decode_params``), --batch rows of --prompt tokens in an f32
cache. Three measurements, each the mean over --iters repetitions:

  full      a decode step, ``forward_with_cache`` of one token a row plus the
            argmax: host ms (the clock around steps that end in a synchronize)
            and device ms (CUDA events)
  streams   only the step's weight streams, chained as the step issues them:
            per layer K6 (qkv|mlp_in, ``q8_dual_in_dot``) and K7 (attn_out +
            mlp_out, ``q8_splitk_dot``), then K6 on the head
  launch    the launch floor: S5 (``ops/decode_probes.tiny_copy``, a [8, 128]
            f32 copy) launched 2L + 1 = 33 times (the weight streams' launch
            count, the JAX script's ``n_calls``) and as many times as one
            eager step launches kernels (counted with torch.profiler)

plus K13's floor (``ops.stream_probe.stream_floor``) over the same int8
buffers. Prints the card's name and power limit first and a JSON object
last; writes no file. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def events_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def kernels_per_call(fn) -> int:
    """CUDA kernel launches of one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)


def measure(iters: int, batch: int, prompt: int, seed: int) -> dict:
    from retrieval_scaling_tpu_torch.models.generate import (
        forward_with_cache,
        init_cache,
        quantize_decode_params,
    )
    from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig, init_gpt_neox_params
    from retrieval_scaling_tpu_torch.ops import decode_probes as dp
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm
    from retrieval_scaling_tpu_torch.ops.stream_probe import stream_floor

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = GPTNeoXConfig()  # Pythia-1B
    qmodel = quantize_decode_params(init_gpt_neox_params(cfg, gen, device=dev), cfg, scheme="int8")
    torch.cuda.empty_cache()
    m = prompt + 2 * iters + 16
    ids = torch.randint(3, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)
    slots = torch.arange(m, device=dev)
    cache = init_cache(cfg, batch, m, dtype=torch.float32, device=dev)
    res = {}
    with torch.inference_mode():
        logits, _ = forward_with_cache(qmodel, cfg, ids, slots[:prompt].expand(batch, prompt), cache,
                                       slots[None, :] < prompt, torch.ones(batch, prompt, dtype=torch.bool, device=dev))
        state = {"tok": logits[:, -1].argmax(-1), "cur": prompt}

        def step():  # the cache position stays inside the pool however often it runs
            cur = torch.full((batch, 1), state["cur"], device=dev)
            out, _ = forward_with_cache(qmodel, cfg, state["tok"][:, None], cur, cache, slots[None, :] <= state["cur"])
            state["tok"] = out[:, 0].argmax(-1)
            state["cur"] = min(state["cur"] + 1, m - 1)

        res["full_host_ms"] = host_ms(step, iters)
        res["full_device_ms"] = events_ms(step, iters, warmup=0)
        res["launches_per_step"] = kernels_per_call(step)

        x0 = torch.randn(batch, 1, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
        nqkv = 3 * cfg.num_heads * cfg.head_dim

        def streams():
            x = x0
            for layer in qmodel.layers:
                qkv, h = qm.q8_dual_in_dot(layer.q8, "qkv_mi", x, x, nqkv)
                x = x + qm.q8_splitk_dot(layer.q8, "ao_mo", qkv[..., : cfg.hidden_size], h)
            return qm.q8_dot(qmodel.q8, "embed_out", x, out_dtype=torch.float32)

        res["streams_ms"] = events_ms(streams, iters)
        src = torch.randn(8, 128, generator=gen, device=dev)
        dst = torch.empty_like(src)
        floors = (("launch_floor_33", 2 * cfg.num_layers + 1), ("launch_floor_step", res["launches_per_step"]))
        for label, n_calls in floors:
            res[label + "_ms"] = events_ms(lambda n=n_calls: [dp.tiny_copy(src, dst) for _ in range(n)], iters)
            res[label + "_host_ms"] = host_ms(lambda n=n_calls: [dp.tiny_copy(src, dst) for _ in range(n)], iters)
        buffers = [layer.q8[k] for layer in qmodel.layers for k in ("qkv_mi@q8", "ao_mo@q8")]
        buffers.append(qmodel.q8["embed_out@q8"])
        floor = stream_floor(buffers)
        res["k13_floor_ms"], res["stream_gb"] = floor["ms"], floor["bytes"] / 1e9
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--prompt", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_decode_gap: needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    res = measure(args.iters, args.batch, args.prompt, args.seed)
    print(f"full step (int8, b{args.batch}): host {res['full_host_ms']:.4f} ms, device {res['full_device_ms']:.4f} ms, "
          f"{res['launches_per_step']} kernel launches [{card}]", flush=True)
    print(f"streams only (K6 / K7 chain, {res['stream_gb']:.4f} GB): {res['streams_ms']:.4f} ms; K13 floor "
          f"{res['k13_floor_ms']:.4f} ms [{card}]", flush=True)
    print(f"launch floor (S5): 33 launches {res['launch_floor_33_ms']:.4f} ms "
          f"(host {res['launch_floor_33_host_ms']:.4f}),"
          f" {res['launches_per_step']} launches {res['launch_floor_step_ms']:.4f} ms (host "
          f"{res['launch_floor_step_host_ms']:.4f}) [{card}]", flush=True)
    print(json.dumps({"card": card, **res}))
    return res


if __name__ == "__main__":
    main()
