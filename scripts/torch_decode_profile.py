#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one GPU.

    python3 scripts/torch_decode_profile.py [--model pythia-1b|llama3-8b] [--batch 8] [--prompt 256]
                                            [--layers N] [--steps 20] [--schemes float,bf16,int8,int4]

Builds a random reader on the card with f32 weights, as the readers load:
Pythia-1B (GPT-NeoX 16 x 2048, 8 heads, vocab 50304) or Llama-3.1-8B (32 x
4096, 32 heads over 8 KV heads, FFN 14336, vocab 128256; 32 GB in f32).
It prefills ``--batch`` prompts of ``--prompt`` tokens into an f32 cache and
times ``--steps`` decode steps (``models.generate.forward_with_cache``, one
token per row) for the float model and the bf16, int8 and int4 schemes of
``quantize_decode_params``: wall ms per step (host clock after a
synchronize), device ms per step (the sum of the kernels' device time under
``torch.profiler``), the device's busy share, CUDA kernel launches per step,
the ten kernels with the most device time, and, for a quantized scheme, the
K13 floor of the same weight buffers (``ops.stream_probe.stream_floor``)
beside the step. ``--layers`` cuts the depth (default: the model's). Prints
the card's name and power limit first.
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
    parser.add_argument("--model", choices=("pythia-1b", "llama3-8b"), default="pythia-1b")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--prompt", type=int, default=256)
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--schemes", default="float,bf16,int8,int4")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from retrieval_scaling_tpu_torch.models.generate import forward_with_cache, init_cache, quantize_decode_params
    from retrieval_scaling_tpu_torch.models.gpt_neox import GPTNeoXConfig, init_gpt_neox_params
    from retrieval_scaling_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from retrieval_scaling_tpu_torch.ops.stream_probe import stream_floor

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.model == "llama3-8b":  # meta-llama/Llama-3.1-8B's config.json
        cfg = LlamaConfig(vocab_size=128256, hidden_size=4096, num_layers=args.layers or 32, num_heads=32,
                          num_kv_heads=8, head_dim=128, intermediate_size=14336, max_position_embeddings=131072,
                          rope_base=500000.0, rope_scaling_type="llama3", rope_factor=8.0)
        model = init_llama_params(cfg, gen, device=dev, dtype=torch.float32)
    else:
        cfg = GPTNeoXConfig(num_layers=args.layers or 16)
        model = init_gpt_neox_params(cfg, gen, device=dev, dtype=torch.float32)
    b, s = args.batch, args.prompt
    m = s + args.steps + 8
    ids = torch.randint(3, cfg.vocab_size, (b, s), generator=gen, device=dev)
    slots = torch.arange(m, device=dev)
    for name in args.schemes.split(","):
        scheme = None if name == "float" else name
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
        floor = ""
        if scheme is not None:
            bufs = [t for st in [layer.q8 for layer in lm.layers] + [lm.q8] for t in st.values() if t.dim() == 2]
            f = stream_floor(bufs)
            floor = (f"; K13 floor of the {f['bytes'] / 1e9:.3f} GB of weight buffers {f['ms']:.4f} ms "
                     f"({f['gb_per_s']:.1f} GB/s), step / floor {wall / f['ms']:.2f}")
        print(f"{args.model} {name}: {wall:.4f} ms per decode step (host clock), device "
              f"{device_us / 1e3 / args.steps:.4f} ms per step ({100 * device_us / 1e3 / args.steps / wall:.1f} % "
              f"busy), {launches / args.steps:.1f} kernels per step; b{b}, {s}-token prompt, {cfg.num_layers} "
              f"layers{floor}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3 / args.steps:9.4f} ms/step  {e.count / args.steps:6.1f}x  "
                  f"{e.key[:100]}")
        del lm, cache
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
