#!/usr/bin/env python3
"""Time the hand-written kernels of one CUDA source against another build of
them on one GPU.

    python3 scripts/torch_kernel_ab.py flash --old path/to/older/flash_attn_fwd.cu
    python3 scripts/torch_kernel_ab.py quant --old path/to/older/quant_matmul.cu
    python3 scripts/torch_kernel_ab.py flash --old-without=--split-compile=0

"new" is the repo's source (``csrc/flash_attn_fwd.cu`` or
``csrc/quant_matmul.cu``) built with the repo's nvcc flags
(``ops._build.NVCC_FLAGS``); "old" is ``--old`` (default: the repo's source)
built with those flags less the ones named by ``--old-without``. Both are
built into ``build/``; their registers per thread and whether their SASS is
the same, function by function (``cuobjdump -sass``), are printed. For each
shape the two outputs must be equal bit for bit, and each version is timed
in the order old, new, new, old (CUDA events around ``--iters``
back-to-back calls, queued behind a sleep kernel).

flash: K1 at the Contriever encoder's shapes (BERT-base heads, S 256, a
key-padding mask) at b8 and b2048, Pythia-1B scoring (b2 h8 S2048 d256,
causal) and Llama-3.1-8B scoring (b8 h32/kv8 S2048 d128, causal); K2s on a
packed encoder batch (b2048 h12 S256 d64, segments of ~40 tokens) where
both sources take segments. Both are launched through ctypes in the same
way, so an older source whose entry point lacks ``window`` / ``logit_cap``
or K2s's segment pointers is called without them; the new one is also
timed through the wrapper ``ops.flash_attention.flash_attention``.

quant: K6 (b8, Llama-3.1-8B's gate + up, 4096 -> 28672), K9 (m2048,
2048 -> 6144 f32; BERT-base ``mlp_in``, m 2048 x 256, 768 -> 3072 bf16 with
gelu) and K10 (BERT-base FFN tail, m 2048 x 256, 3072 -> 768 bf16; m 65,536
f32), each through its wrapper in ``ops.quant_matmul`` with the version's
library swapped in, so the two sources must share their C interface.

Prints the card's name and power limit first.
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

FLASH_SHAPES = [  # (label, B, H, Hkv, S, D, causal, key mask, mean segment length or 0)
    ("K1 encoder b8 h12 S256 d64 key-mask", 8, 12, 12, 256, 64, False, True, 0),
    ("K1 encoder b2048 h12 S256 d64 key-mask", 2048, 12, 12, 256, 64, False, True, 0),
    ("K1 pythia b2 h8 S2048 d256 causal", 2, 8, 8, 2048, 256, True, False, 0),
    ("K1 llama b8 h32/kv8 S2048 d128 causal", 8, 32, 8, 2048, 128, True, False, 0),
    ("K2s packed encoder batch b2048 h12 S256 d64 seg40", 2048, 12, 12, 256, 64, False, True, 40),
]
QUANT_SHAPES = [  # (label, kernel, m, K, N, input dtype)
    ("K6 b8 4096->28672 f32 out", "K6", 8, 4096, 28672, torch.float32),
    ("K9 m2048 2048->6144 f32", "K9", 2048, 2048, 6144, torch.float32),
    ("K9 bert-base mlp_in m524288 768->3072 bf16 gelu", "K9", 2048 * 256, 768, 3072, torch.bfloat16),
    ("K10 bert-base FFN tail m524288 3072->768 bf16", "K10", 2048 * 256, 3072, 768, torch.bfloat16),
    ("K10 bert-base FFN tail m65536 3072->768 f32", "K10", 65536, 3072, 768, torch.float32),
]
SOURCES = {"flash": "flash_attn_fwd", "quant": "quant_matmul"}


def sass_functions(lib: str) -> list:
    """The library's SASS, one text block per function, sorted."""
    from retrieval_scaling_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    blocks = []
    for block in text.split("Function : ")[1:]:
        name, *lines = block.splitlines()
        blocks.append("\n".join([name.strip()] + [ln.strip() for ln in lines if ln.strip().startswith("/*")]))
    return sorted(blocks)


def build(src: str, lib: str, flags: list):
    """Compile ``src`` into ``lib``; returns (registers per thread of each
    instance, SASS blocks)."""
    from retrieval_scaling_tpu_torch.ops import _build

    out = subprocess.run([_build._nvcc(), *flags, "-o", lib, src], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stderr}")
    regs = [line.split("Used", 1)[1].split(",")[0].strip() for line in out.stderr.splitlines() if "Used" in line]
    return regs, sass_functions(lib)


def ms(fn, iters: int) -> float:
    """Device ms per call: a sleep kernel holds the card while the host
    queues the calls, so a short kernel is not timed at the host's pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of clock cycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(label: str, run: dict, iters: int, extra: str = "") -> None:
    """Equality of old and new outputs, then old / new / new / old times."""
    equal = torch.equal(run["old"]().clone(), run["new"]())
    t = [ms(run[name], iters) for name in ("old", "new", "new", "old")]
    print(f"{label}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} ms{extra}; outputs equal {equal}",
          flush=True)


# ---------------------------------------------------------------- flash_attn_fwd (K1, K2s)
def flash_entry(lib: str, src: str):
    """The ctypes entry point and the features its signature takes:
    (window and cap, segments)."""
    fn = ctypes.CDLL(lib).flash_attn_fwd
    fn.restype = ctypes.c_int
    signature = open(src).read().split("extern \"C\" int flash_attn_fwd", 1)[1].split(")", 1)[0]
    features = "logit_cap" in signature, "seg_lo" in signature
    mid = [ctypes.c_float, ctypes.c_int, ctypes.c_float] if features[0] else [ctypes.c_float]
    fn.argtypes = [ctypes.c_void_p] * (8 if features[1] else 5) + [ctypes.c_int] * 7 + mid + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    return fn, features


def flash_launcher(fn, features, q, k, v, mask, seg, causal):
    from retrieval_scaling_tpu_torch.ops.flash_attention import segment_bounds

    b, h, sq, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    mid = (d ** -0.5, 0, 0.0) if features[0] else (d ** -0.5,)
    segments = ()
    if features[1]:
        segments = (None, None, None) if seg is None else (seg, *segment_bounds(seg))
    ptrs = tuple(None if t is None else t.data_ptr() for t in segments)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(), *ptrs,
            out.data_ptr(), b, h, k.shape[1], sq, k.shape[2], d, int(causal), *mid, 0, strides,
            torch.cuda.current_stream().cuda_stream)

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return out

    run.inputs = segments  # the segment tensors live as long as the launcher
    return run


def run_flash(libs: dict, srcs: dict, iters: int) -> None:
    from chip_smoke import _packed_segments_cuda
    from retrieval_scaling_tpu_torch.ops import _build
    from retrieval_scaling_tpu_torch.ops.flash_attention import flash_attention

    entries = {name: flash_entry(libs[name], srcs[name]) for name in libs}
    _build._LIBS["flash_attn_fwd"] = ctypes.CDLL(libs["new"])  # the wrapper's library: the new build
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, b, h, hkv, s, d, causal, masked, seg_len in FLASH_SHAPES:
        if seg_len and not all(feat[1] for _, feat in entries.values()):
            print(f"{label}: skipped, the old source takes no segments", flush=True)
            continue
        q = torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, s, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        mask = seg = None
        if seg_len:
            seg = _packed_segments_cuda(b, s, seg_len, torch.Generator().manual_seed(0)).to(dev)
            mask = seg > 0
        elif masked:
            lengths = torch.randint(1, s + 1, (b, 1), generator=gen, device=dev)
            mask = (torch.arange(s, device=dev)[None] < lengths).contiguous()
        run = {name: flash_launcher(fn, feat, q, k, v, mask, seg, causal) for name, (fn, feat) in entries.items()}
        wrapped = ms(lambda: flash_attention(q, k, v, kv_mask=mask, causal=causal, segment_ids=seg), iters)
        compare(label, run, iters, f" (same ctypes call), new through the Python wrapper {wrapped:.4f} ms")
        del q, k, v, mask, seg, run
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- quant_matmul (K6, K9, K10)
def run_quant(libs: dict, iters: int) -> None:
    from retrieval_scaling_tpu_torch.ops import _build
    from retrieval_scaling_tpu_torch.ops import quant_matmul as qm

    handles = {name: ctypes.CDLL(lib) for name, lib in libs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, kernel, m, k, n, dt in QUANT_SHAPES:
        qw = qm.quantize_weight(0.02 * torch.randn(k, n, generator=gen, device=dev))
        x = torch.randn(m, k, generator=gen, device=dev).to(dt)
        if kernel == "K6":
            def call():
                return qm.w8_stream(x, qw.wq, qw.scale, torch.float32)
        elif kernel == "K9":
            act = "gelu_tanh" if dt == torch.bfloat16 else "none"
            bias = torch.randn(n, generator=gen, device=dev)

            def call():
                return qm.int8_matmul(x, qw, bias, activation=act, out_dtype=dt)
        else:
            qw_nk = qm.res_ln_layout(qw)
            res = torch.randn(m, n, generator=gen, device=dev).to(dt)
            vecs = [torch.randn(n, generator=gen, device=dev) for _ in range(3)]

            def call():
                return qm.int8_matmul_residual_ln(x, res, qw_nk, *vecs, eps=1e-12)

        def with_library(name):
            def run():
                _build._LIBS["quant_matmul"] = handles[name]
                return call()
            return run

        compare(label, {name: with_library(name) for name in handles}, iters, " (through the wrapper)")
        del qw, x, call
        torch.cuda.empty_cache()
    _build._LIBS.pop("quant_matmul", None)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source", choices=sorted(SOURCES), help="flash: K1 and K2s; quant: K6, K9 and K10")
    parser.add_argument("--old", help="the other version of the source (default: the repo's own)")
    parser.add_argument("--old-without", action="append", default=[], metavar="FLAG",
                        help="an nvcc flag of the repo's that the old build leaves out (repeatable)")
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA device")
    from retrieval_scaling_tpu_torch.ops import _build

    missing = [f for f in args.old_without if f not in _build.NVCC_FLAGS]
    if missing:
        raise SystemExit(f"torch_kernel_ab: {missing} not among the repo's nvcc flags {_build.NVCC_FLAGS}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    name = SOURCES[args.source]
    new_src = os.path.join(_build.CSRC_DIR, name + ".cu")
    srcs = {"old": args.old or new_src, "new": new_src}
    flags = {"old": [f for f in _build.NVCC_FLAGS if f not in args.old_without], "new": _build.NVCC_FLAGS}
    libs, built = {}, {}
    for side in ("old", "new"):
        libs[side] = os.path.join(_build.BUILD_DIR, f"lib{name}_ab_{side}.so")
        built[side] = build(srcs[side], libs[side], flags[side])
        print(f"{side}: {srcs[side]} with {' '.join(flags[side])}; registers per thread of its "
              f"{len(built[side][0])} instances: {', '.join(built[side][0])}", flush=True)
    same = built["old"][1] == built["new"][1]
    print(f"SASS of old and new the same, function by function: {same} ({len(built['old'][1])} / "
          f"{len(built['new'][1])} functions)", flush=True)
    if args.source == "flash":
        run_flash(libs, srcs, args.iters)
    else:
        run_quant(libs, args.iters)


if __name__ == "__main__":
    main()
