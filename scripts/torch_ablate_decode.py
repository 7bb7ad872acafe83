#!/usr/bin/env python3
"""Where the weight streams of a Pythia-1B decode step go, on one GPU: the
PyTorch port's counterpart of scripts/ablate_decode.py (S1).

    python3 scripts/torch_ablate_decode.py [--iters 20] [--variants mm_cur,mm_preq,...] [--seed 0]

The matmul chain of one decode step at Pythia-1B's shapes (D 2048, FF 8192,
qkv 6144, vocab 50304, 16 layers, 8 rows; random int8 weights with
per-column scales made on the card from --seed), timed with CUDA events over
--iters chained steps (one step streams 0.91 GB of int8 weights, far more
than the 50 MB L2, so every step reads them from device memory). The
variants are the script's, each built from the port's decode probes
(``ops/decode_probes.py``, csrc/decode_probes.cu) and the port's own
kernels:

  mm_cur       S1-cur: x quantised inside each launch, once per column block
  mm_preq      S1-preq: x quantised once per matmul (rowquant_xla), then s8 x s8
  mm_fused     preq with qkv|mlp_in as one stream and attn_out + mlp_out as
               S1-dual (residual add fused)
  mm_w8bf16    S1-w8bf16: int8 weights widened to bf16, no activation quantisation
  mm_k6        the same function through K6 (ops.quant_matmul.w8_stream), the
               port's decode kernel
  mm_bf16k     S1-bf16 (concatenated qkv|mlp_in) and S1-dual-bf16
  mm_bf16      torch.matmul on bf16 weights (the library's dots; no repo kernel)
  mm_touch     S1-touch: K13 once per weight buffer, 65 launches (the stream floor
               with launches)

Prints the card's name and power limit first, then per variant ms per step,
effective GB/s and the byte bound at 3.35 TB/s (the weights read once).
Needs the card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D, FF, NQKV, V, L, M = 2048, 8192, 6144, 50304, 16, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
VARIANTS = ("mm_cur", "mm_preq", "mm_fused", "mm_w8bf16", "mm_k6", "mm_bf16k", "mm_bf16", "mm_touch")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def chain_ms(step, x0, iters: int, warmup: int = 2) -> float:
    """Device ms per step of ``iters`` chained steps (CUDA events)."""
    x = x0
    for _ in range(warmup):
        x = step(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x = step(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build(gen, dev):
    """Per-layer int8 weights [K, N] with f32 column scales, the head, the
    fused layouts and the bf16 weight sets (wq * scale), as the script."""
    def qweight(k, n):
        w = 0.02 * torch.randn(k, n, generator=gen, device=dev)
        s = w.abs().amax(dim=0) / 127.0
        return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s

    layers = [dict(qkv=qweight(D, NQKV), ao=qweight(D, D), mi=qweight(D, FF), mo=qweight(FF, D)) for _ in range(L)]
    for ly in layers:
        ly["cat"] = (torch.cat([ly["qkv"][0], ly["mi"][0]], dim=1).contiguous(),
                     torch.cat([ly["qkv"][1], ly["mi"][1]]))
        for name in ("qkv", "ao", "mi", "mo", "cat"):
            wq, s = ly[name]
            ly[name + "_bf16"] = (wq.to(torch.bfloat16) * s.to(torch.bfloat16)).contiguous()
    head = qweight(D, V)
    return layers, head, (head[0].to(torch.bfloat16) * head[1].to(torch.bfloat16)).contiguous()


def make_steps(layers, head, head_bf16) -> dict:
    """{variant: step(x) -> x}: one decode step's matmul chain per variant,
    with the script's stand-in data flow (qkv[:, :D] plays the attention
    output, gelu(mlp_in) feeds mlp_out, the head folds into nothing)."""
    from retrieval_scaling_tpu_torch.ops import decode_probes as dp
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    ws = dp.weight_stream

    def fold(x, logits):
        return x + logits.float().mean(dim=-1, keepdim=True).to(x.dtype) * 0

    def step_chain(x, mm):  # four streams a layer and the head
        for ly in layers:
            qkv = mm(x, ly["qkv"])
            hh = F.gelu(mm(x, ly["mi"]))
            x = x + mm(qkv[:, :D], ly["ao"]) + mm(hh, ly["mo"])
        return fold(x, mm(x, head))

    def preq(inp, w):
        q, s = dp.rowquant_xla(inp)
        return ws(q, w[0], w[1], "preq", xs=s)

    def step_fused(x):
        for ly in layers:
            cat = preq(x, ly["cat"])
            (aq, asc), (hq, hsc) = dp.rowquant_xla(cat[:, :D]), dp.rowquant_xla(F.gelu(cat[:, NQKV:]))
            x = dp.dual_stream(aq, hq, x, ly["ao"][0], ly["mo"][0], ly["ao"][1], ly["mo"][1], asc, hsc)
        return fold(x, preq(x, head))

    def step_bf16k(x):
        for ly in layers:
            cat = ws(x, ly["cat_bf16"], None, "bf16")
            x = dp.dual_stream(cat[:, :D], F.gelu(cat[:, NQKV:]), x, ly["ao_bf16"], ly["mo_bf16"])
        return fold(x, ws(x, head_bf16, None, "bf16"))

    def step_bf16(x):
        for ly in layers:
            qkv = x @ ly["qkv_bf16"]
            hh = F.gelu(x @ ly["mi_bf16"])
            x = x + qkv[:, :D] @ ly["ao_bf16"] + hh @ ly["mo_bf16"]
        return fold(x, x @ head_bf16)

    probes = []  # K13's launches, prepared at the first touch step

    def step_touch(x):
        if not probes:
            probes.extend(dp.touch_probes([ly[n][0] for ly in layers for n in ("qkv", "ao", "mi", "mo")] + [head[0]]))
        dp.touch_step(probes)
        return x

    return {"mm_cur": lambda x: step_chain(x, lambda i, w: ws(i, w[0], w[1], "cur")),
            "mm_preq": lambda x: step_chain(x, preq), "mm_fused": step_fused,
            "mm_w8bf16": lambda x: step_chain(x, lambda i, w: ws(i, w[0], w[1], "w8bf16")),
            "mm_k6": lambda x: step_chain(x, lambda i, w: qm.w8_stream(i, w[0], w[1], torch.bfloat16)),
            "mm_bf16k": step_bf16k, "mm_bf16": step_bf16, "mm_touch": step_touch}


def weight_bytes(layers, head) -> int:
    """The int8 weight bytes one step streams (the bf16 variants stream twice as many)."""
    return sum(ly[n][0].numel() for ly in layers for n in ("qkv", "ao", "mi", "mo")) + head[0].numel()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_ablate_decode: needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    layers, head, head_bf16 = build(gen, dev)
    x0 = torch.randn(M, D, generator=gen, device=dev).to(torch.bfloat16)
    int8_bytes = weight_bytes(layers, head)
    menu = make_steps(layers, head, head_bf16)
    bound_int8 = int8_bytes / HBM_BYTES_PER_S * 1e3
    print(f"int8 weight bytes per step: {int8_bytes / 1e9:.4f} GB, byte bound {bound_int8:.4f} ms at 3.35 TB/s "
          f"(bf16: {2 * bound_int8:.4f} ms)", flush=True)
    results = {}
    with torch.inference_mode():
        for key in args.variants.split(","):
            ms = chain_ms(menu[key], x0, args.iters)
            n_bytes = 2 * int8_bytes if key in ("mm_bf16k", "mm_bf16") else int8_bytes
            bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            results[key] = ms
            print(f"{key:10s} {ms:8.4f} ms/step  {n_bytes / ms / 1e6:7.1f} GB/s effective  bound {bound_ms:.4f} ms "
                  f"({bound_ms / ms:.1%} of it) [{card}]", flush=True)
    return results


if __name__ == "__main__":
    main()
