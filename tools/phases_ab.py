#!/usr/bin/env python3
"""Host-bound serving readings of this tree against another, on one card.

    python3 tools/phases_ab.py --other DIR   # DIR: another tree, e.g. unpacked
                                             # with git archive <commit>
    python3 tools/phases_ab.py --tree DIR    # one tree alone

Runs ``chip_smoke.py``'s phase 1 (``main_path``: full-width qwen2.5-7b in the
co-located configuration, then one engine's prefill and decode step
profiled) and gemma2-2b's phase 4 (``model_api_path``), each tree's own code,
in a subprocess per run, in the order other, this, this, other, so that the
two trees' spread can be read beside their difference. A tree whose
``chip_smoke.py`` starts phase 5's data worker in ``main`` gets it here as
well, while phase 1 runs. Prints the lines that carry the readings: phase
1's TTFT and TPOT p50, host wall and device busy per call, and ``AB`` lines
with gemma2's prefill and ``decode_step`` times.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

KEEP = ("AB ", "requests finished", "online TTFT p50", "host wall", "worker data")


def run_tree(tree: str) -> None:
    sys.path.insert(0, tree + "/src")
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"imported {cs.__file__}, not the tree's chip_smoke.py")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import ops as fp_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    pool = None
    if hasattr(cs, "train_batches"):      # as that tree's main() does
        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        data = pool.submit(cs.train_batches)
    try:
        build.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        out = cs.main_path(fp_ops, pa_ops, get_config("qwen2.5-7b"))
        del out
        torch.cuda.empty_cache()
        api = cs.model_api_path(fp_ops, pa_ops, "gemma2-2b")
        print("AB", tree, json.dumps({k: api[k] for k in (
            "prefill_ms", "prefill_busy_ms", "decode_ms", "decode_busy_ms")}))
        if pool:
            print("worker data seconds", data.result()[1])
    finally:
        if pool:
            pool.shutdown(cancel_futures=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other tree: runs other, this, this, other")
    ap.add_argument("--tree", help="run one tree in this process")
    args = ap.parse_args()
    if args.tree:
        run_tree(os.path.abspath(args.tree))
        return 0
    if not args.other:
        ap.error("give --other DIR or --tree DIR")
    this = str(Path(__file__).resolve().parents[1])
    rc = 0
    for tree in (args.other, this, this, args.other):
        print(f"=== {tree}", flush=True)
        out = subprocess.run([sys.executable, __file__, "--tree", tree], capture_output=True,
                             text=True, timeout=600)
        for line in out.stdout.splitlines():
            if line.startswith(KEEP[0]) or any(k in line for k in KEEP[1:]):
                print(line, flush=True)
        if out.returncode:
            print(out.stderr[-4000:], flush=True)
            rc = out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
