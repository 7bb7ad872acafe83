#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python3 scripts/torch_decode_profile.py [--batch 8] [--prompt 256] [--layers 16] [--steps 20]

Builds a random Pythia-1B (GPT-NeoX 16 x 2048, 8 heads, vocab 50304; f32
weights, as the readers load) on the card, prefills ``--batch`` prompts of
``--prompt`` tokens into an f32 cache and times ``--steps`` decode steps
(``models.generate.forward_with_cache``, one token per row) for the float
model and the bf16 and int8 schemes of ``quantize_decode_params``: wall ms
per step (host clock after a synchronize), device ms per step (the sum of
the kernels' device time under ``torch.profiler``), the device's busy
share, CUDA kernel launches per step and the ten kernels with the most
device time. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--prompt", type=int, default=256)
    parser.add_argument("--layers", type=int, default=16)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache, quantize_decode_params
    from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig, init_gpt_neox_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = GPTNeoXConfig(num_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_gpt_neox_params(cfg, gen, device=dev, dtype=torch.float32)
    b, s = args.batch, args.prompt
    m = s + args.steps + 8
    ids = torch.randint(3, cfg.vocab_size, (b, s), generator=gen, device=dev)
    slots = torch.arange(m, device=dev)
    for scheme in (None, "bf16", "int8"):
        lm = model if scheme is None else quantize_decode_params(model, cfg, scheme=scheme)
        cache = init_cache(cfg, b, m, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            logits, _ = forward_with_cache(lm, cfg, ids, slots[:s].expand(b, s), cache, slots[None, :] < s,
                                           torch.ones(b, s, dtype=torch.bool, device=dev))
            tok = logits[:, -1].argmax(-1)[:, None]
            cur = [s]

            def step():
                pos = torch.full((b, 1), cur[0], device=dev)
                forward_with_cache(lm, cfg, tok, pos, cache, (slots[None, :] <= cur[0]).expand(b, m))
                cur[0] += 1

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / args.steps
            cur[0] = s
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.steps):
                    step()
                torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        name = scheme or "float"
        print(f"{name}: {wall:.4f} ms per decode step (host clock), device {device_us / 1e3 / args.steps:.4f} ms "
              f"per step ({100 * device_us / 1e3 / args.steps / wall:.1f} % busy), "
              f"{launches / args.steps:.1f} kernels per step; b{b}, {s}-token prompt, {args.layers} layers")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3 / args.steps:9.4f} ms/step  {e.count / args.steps:6.1f}x  "
                  f"{e.key[:100]}")


if __name__ == "__main__":
    main()
