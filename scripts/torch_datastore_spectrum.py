#!/usr/bin/env python3
"""Recall@10 of chip_smoke.py's synthetic IVF datastore for several spectra.

    python3 scripts/torch_datastore_spectrum.py [--rows 1048576] [--nprobe 64] ALPHA:SPREAD ...

Each ALPHA:SPREAD sets chip_smoke.make_datastore's within-cluster spread:
per-direction scale i^-ALPHA in a random basis, total variance
SPREAD^2 * 768. For each, the script writes chip_smoke.py's phase-7
datastore (seed 0, 4,096 centres, four shards), builds IVF-Flat and IVF-PQ
through Indexer at the configs' own settings (the PyTorch port, kernels built
from retrieval_scaling_tpu_torch/csrc), and prints recall@10 against the
exact scan at --nprobe for IVF-Flat, raw IVF-PQ (the K5a scan) and IVF-PQ +
refine x4.
It runs on the GPU; ``--device cpu`` with a small --rows and --lists
rehearses it on the CPU's plain scans.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("spectra", nargs="+", help="ALPHA:SPREAD pairs")
    parser.add_argument("--rows", type=int, default=1 << 20)
    parser.add_argument("--lists", type=int, default=4096)
    parser.add_argument("--nprobe", type=int, default=chip_smoke.NPROBE)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: pass --device cpu for a rehearsal")
    tag = f"[{chip_smoke.card_line()}]" if device.type == "cuda" else "[cpu]"
    chip_smoke.log(tag)
    root = os.path.join(REPO, "build", "datastore_spectrum")
    for spec in args.spectra:
        alpha, spread = (float(v) for v in spec.split(":"))
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        ds = chip_smoke.build_datastore(root, device, 0, tag, args.rows, args.lists, args.lists,
                                        args.nprobe, alpha=alpha, spread=spread)
        recall = {name: chip_smoke.recall_at_10(ids, ds["truth"]) for name, ids in (
            ("ivf_flat", ds["flat_ids"]), ("ivf_pq_raw", ds["pq_raw_k5a"][1]), ("ivf_pq_refine4", ds["pq_ids"]))}
        chip_smoke.log(json.dumps({"alpha": alpha, "spread": spread, "rows": args.rows, "lists": args.lists,
                                   "nprobe": args.nprobe, "recall_at_10": recall}))
        del ds
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
