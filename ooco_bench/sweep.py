"""Find a cell's knee: run the cell (``run.run_cell``, the timed path of a
benchmark run, judged as a run is) at each of a list of online rates, from
the lowest up, on each of the seeds given, until a rate fails on one seed;
print, for each run, the online TTFT p90 and the online requests still
waiting for a first token at the window's middle and at its end; then the
knee, the highest rate at which, on every seed, the TTFT p90 is within the
SLO and that queue did not grow from the middle to the end. Seeds draw
tokens and weights, not lengths or arrivals, yet a tail near the knee
moves from seed to seed. It writes nothing into the cell's files.

    python3 ooco_bench/sweep.py --workload qwen2.5-7b.conv --rates 2 2.5 3 --seconds 51 --seeds 1 2

One process: the bs_sat memo of the first run is carried to the others.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def sweep(cell, bench: dict, rates, seeds, seconds: float, device, log=print) -> dict:
    import torch

    from ooco_bench.run import run_cell
    memo: dict = {}
    rows = []
    slo = cell.deployment["slo_ttft_s"]
    for rate, seed in ((r, s) for r in sorted(rates) for s in seeds):
        if rows and not rows[-1]["sustained"]:
            break
        at = dataclasses.replace(cell, load={**cell.load, "online_rate_qps": rate})
        res, _ = run_cell(at, bench, seed, seconds, False, device,
                          t_start=time.perf_counter(), memo=memo)
        d = res["detail"]
        c = d["client"]
        row = {"rate_qps": rate, "seed": seed, "online_ttft_p90_s": c["online_ttft_p90_s"],
               "queue_mid": d["queue_mid"], "queue_end": d["queue_end"],
               "online_tpot_p90_ms": c["online_tpot_p90_ms"],
               "offline_tokens_per_s": c["offline_tokens_per_s"],
               "slo_attainment": c["slo_attainment"], "online_due": c["online_due"],
               "online_unserved": c["online_unserved"], "rounds": d["counters"]["rounds"],
               "warm": d["warm"], "correct": res["correct"], "logit_gap": d["gaps"].get("program"),
               "kinds_uncovered": sorted(set(d["kinds_ran"]) - set(d["kinds_covered"])),
               "kinds_unserved": d["kinds_unserved"]}
        row["sustained"] = (c["online_ttft_p90_s"] <= slo and d["queue_end"] <= d["queue_mid"])
        log(json.dumps(row))
        rows.append(row)
        del res, d
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    failed = None if rows[-1]["sustained"] else rows[-1]["rate_qps"]
    ok = [r["rate_qps"] for r in rows if r["rate_qps"] != failed]
    return {"rows": rows, "knee_qps": max(ok) if ok else None, "failed_at": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)
    from ooco_bench.run import process_env
    process_env()
    import torch

    from ooco_bench.cell import load_cell, load_json
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = sweep(load_cell(args.workload), load_json(ROOT / "BENCHMARK.json"), args.rates,
                args.seeds, args.seconds, "cuda")
    knee = out["knee_qps"]
    print(json.dumps({"workload": args.workload, "knee_qps": knee, "failed_at": out["failed_at"],
                      "rate_at_0.8": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
