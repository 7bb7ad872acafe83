#!/usr/bin/env python3
"""Time K1 (``csrc/flash_attn_fwd.cu``) against another version of the same
source on one GPU, both launched through ctypes in the same way.

    python3 scripts/torch_k1_ab.py --old path/to/older/flash_attn_fwd.cu

Both sources are built with the repo's nvcc flags into ``build/``; an older
source whose C entry point has no ``window`` / ``logit_cap`` arguments is
called without them. For each shape the two outputs must be equal bit for
bit, and each version is timed in the order old, new, new, old (CUDA events
around ``--iters`` back-to-back launches, so host time per launch hides
under the kernel's). The new version is also timed through the Python
wrapper ``ops.flash_attention.flash_attention``, which adds the wrapper's
host time where the kernel is short. The shapes: the Contriever encoder's
(BERT-base heads, S 256, a key-padding mask) at b8 and at b2048, Pythia-1B
scoring (b2 h8 S2048 d256, causal) and Llama-3.1-8B scoring (b8 h32/kv8
S2048 d128, causal). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = [  # (label, B, H, Hkv, S, D, causal, masked)
    ("encoder b8 h12 S256 d64 key-mask", 8, 12, 12, 256, 64, False, True),
    ("encoder b2048 h12 S256 d64 key-mask", 2048, 12, 12, 256, 64, False, True),
    ("pythia b2 h8 S2048 d256 causal", 2, 8, 8, 2048, 256, True, False),
    ("llama b8 h32/kv8 S2048 d128 causal", 8, 32, 8, 2048, 128, True, False),
]


def build(src: str, lib: str):
    from retrieval_scaling_tpu_torch.ops import _build

    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stderr}")
    fn = ctypes.CDLL(lib).flash_attn_fwd
    fn.restype = ctypes.c_int
    features = "logit_cap" in open(src).read().split("extern \"C\" int flash_attn_fwd", 1)[1].split(")", 1)[0]
    mid = [ctypes.c_float, ctypes.c_int, ctypes.c_float] if features else [ctypes.c_float]
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + mid + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    regs = [line.split("Used", 1)[1].split(",")[0].strip() for line in out.stderr.splitlines() if "Used" in line]
    return fn, features, regs


def launcher(fn, features, q, k, v, mask, causal):
    b, h, sq, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    mid = (d ** -0.5, 0, 0.0) if features else (d ** -0.5,)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, h, k.shape[1], sq, k.shape[2], d, int(causal), *mid, 0, strides,
            torch.cuda.current_stream().cuda_stream)

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out

    return run


def ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--old", required=True, help="the other version of csrc/flash_attn_fwd.cu")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_ab: needs a CUDA device")
    from retrieval_scaling_tpu_torch.ops import _build
    from retrieval_scaling_tpu_torch.ops.flash_attention import flash_attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    new_src = os.path.join(_build.CSRC_DIR, "flash_attn_fwd.cu")
    versions = {"old": build(args.old, os.path.join(_build.BUILD_DIR, "libk1_ab_old.so")),
                "new": build(new_src, os.path.join(_build.BUILD_DIR, "libk1_ab_new.so"))}
    for name, (_, _, regs) in versions.items():
        print(f"{name}: registers per thread of its {len(regs)} instances: {', '.join(regs)}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, h, hkv, s, d, causal, masked in SHAPES:
        q = torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        mask = None
        if masked:
            lengths = torch.randint(1, s + 1, (b, 1), generator=gen, device=dev)
            mask = (torch.arange(s, device=dev)[None] < lengths).contiguous()
        run = {name: launcher(fn, feat, q, k, v, mask, causal) for name, (fn, feat, _) in versions.items()}
        equal = torch.equal(run["old"]().clone(), run["new"]())
        t = [ms(run[name], args.iters) for name in ("old", "new", "new", "old")]
        wrapped = ms(lambda: flash_attention(q, k, v, kv_mask=mask, causal=causal), args.iters)
        print(f"K1 {label}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms (same ctypes call), "
              f"new through the Python wrapper {wrapped:.4f} ms; outputs equal {equal}", flush=True)
        del q, k, v, mask, run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
