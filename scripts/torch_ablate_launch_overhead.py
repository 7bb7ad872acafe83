#!/usr/bin/env python3
"""What one kernel launch costs the port, on one GPU: the PyTorch port's
counterpart of scripts/ablate_launch_overhead.py (S2).

    python3 scripts/torch_ablate_launch_overhead.py [--iters 50] [--seed 0]

The same weight stream, 16 qkv-sized int8 weights [2048, 6144] (Pythia-1B's
qkv projection, random from --seed) against 8 bf16 rows, computed two ways
by the port's ``weight_stream`` probe (``ops/decode_probes.py``, mode
"w8bf16", the function of K6):

  many1   16 launches, one weight each (the shape of an eager decode step)
  one16   one launch over the 16 weights stacked, the layer axis in the grid

Same bytes, same products, same tiles: (many1 - one16) / 15 is what one more
launch costs from this host. The 16 launches are also captured once in a
CUDA graph and replayed (``graph16``): (graph16 - one16) / 15 is a launch's
cost without the host's dispatch. The graph is a measurement only; no
generation path uses one. Times are CUDA events over --iters repetitions.
Prints the card's name and power limit first. Needs the card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

D, N, L, M = 2048, 6144, 16, 8
HBM_BYTES_PER_S = 3.35e12


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


def measure(iters: int, seed: int) -> dict:
    """{many1, one16, graph16 (ms per 16 streams), launch_us, graph_launch_us,
    bound_ms}; the stacked weights live on the card."""
    from retrieval_scaling_tpu_torch.ops import decode_probes as dp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    wq = torch.randint(-127, 128, (L, D, N), generator=gen, device=dev, dtype=torch.int8)
    sc = torch.rand(L, N, generator=gen, device=dev) * 1e-2
    x = torch.randn(M, D, generator=gen, device=dev).to(torch.bfloat16)

    def many1():
        for li in range(L):
            dp.weight_stream(x, wq[li], sc[li], "w8bf16")

    def one16():
        dp.weight_stream(x, wq, sc, "w8bf16")

    with torch.inference_mode():
        many1()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            many1()
        res = {"many1": events_ms(many1, iters), "one16": events_ms(one16, iters),
               "graph16": events_ms(graph.replay, iters)}
    res["launch_us"] = (res["many1"] - res["one16"]) / (L - 1) * 1e3
    res["graph_launch_us"] = (res["graph16"] - res["one16"]) / (L - 1) * 1e3
    res["bound_ms"] = (L * D * N + L * N * 4 + M * D * 2 + L * M * N * 2) / HBM_BYTES_PER_S * 1e3
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_ablate_launch_overhead: needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    res = measure(args.iters, args.seed)
    gbytes = L * D * N / 1e9
    for key, what in (("many1", "16 launches"), ("one16", "1 launch"), ("graph16", "16 launches, one graph replay")):
        print(f"{key:8s} ({what}): {res[key]:.4f} ms  {gbytes / res[key] * 1e3:.1f} GB/s effective, "
              f"bound {res['bound_ms']:.4f} ms [{card}]", flush=True)
    print(f"launch overhead: {res['launch_us']:.2f} us a launch (many1 - one16) / 15; in a graph replay "
          f"{res['graph_launch_us']:.2f} us [{card}]", flush=True)
    return res


if __name__ == "__main__":
    main()
