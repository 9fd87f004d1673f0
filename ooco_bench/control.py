"""Read the numbers that set a cell's correctness limit, on the card at the
cell's own size: for each seed, one run of the cell as ``run.py`` makes it,
and, over the same sample of served requests, the widest gap of the
program's tokens (the lower reading) and of the control's (the reference in
float8 e4m3, W8A8, at the same positions: the upper reading). With
``--plant NAME ...`` each fault of ``faults.py`` named is planted in the
program in turn for the runs instead, and only the program's gaps are read.

    python3 ooco_bench/control.py --workload qwen2.5-7b.conv --seeds 11 12 13 --seconds 30
    python3 ooco_bench/control.py --workload qwen2.5-7b.conv --seeds 14 --seconds 30 --plant token_altered

One process for all seeds; the bs_sat memo of the first run is carried to
the others. Each line it prints is one seed's readings; after each fault's
(or the control's) seeds, the largest and smallest program readings and the
smallest control reading.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from ooco_bench import faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plant", choices=sorted(faults.PLANTS), nargs="+", default=None,
                    help="faults planted in the program, one after another, each for all seeds")
    args = ap.parse_args(argv)
    from ooco_bench.run import process_env
    process_env()
    import torch

    from ooco_bench.cell import load_cell, load_json
    from ooco_bench.run import ROOT as R, run_cell
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = load_json(R / "BENCHMARK.json")
    cell = load_cell(args.workload)
    memo: dict = {}
    for plant in args.plant or [None]:
        prog, ctl = [], []
        for seed in args.seeds:
            with faults.planted(plant) if plant else contextlib.nullcontext():
                res, _ = run_cell(cell, bench, seed, args.seconds, False, "cuda",
                                  t_start=time.perf_counter(), control=not plant, memo=memo)
            g = res["detail"]["gaps"]
            prog.append(g["program"]["widest"])
            if "control" in g:
                ctl.append(g["control"]["widest"])
            print(json.dumps({"seed": seed, "plant": plant, "gaps": g, "correct": res["correct"],
                              "metrics": res["metrics"], "sampled": res["detail"]["sampled"],
                              "kinds_ran": res["detail"]["kinds_ran"],
                              "kinds_covered": res["detail"]["kinds_covered"],
                              "kinds_unserved": res["detail"]["kinds_unserved"]}), flush=True)
            del res
            gc.collect()
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seeds": args.seeds, "plant": plant,
                          "rate_qps": cell.load["online_rate_qps"],
                          "program_widest_max": max(prog), "program_widest_min": min(prog),
                          "control_widest_min": min(ctl) if ctl else None,
                          "ratio": min(ctl) / max(prog) if ctl and max(prog) > 0 else None}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
