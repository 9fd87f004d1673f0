"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 ooco_bench/run.py --workload qwen2.5-7b.conv --seed 7 --seconds 40 --trace 0

Set-up (weights made from the seed on the card, the runtime, the bs_sat
memo, the offline backlog warmed) counts as ``setup_s``; then the window
runs for ``--seconds``; then the plain reference judges a sample of what the
window served. The last line of standard output is one JSON object; the
numbers compared for ``correct`` are the last lines of standard error and
the last key of that object. With ``--trace 1`` a slice at the end of the
window is profiled and the per-layer metrics are printed instead of the
end-to-end ones. Without a CUDA card, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
#: top-level module names that a run of the port must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the profiled slice at the end of a traced window, seconds
SLICE_S = 2.0


def process_env() -> None:
    """Settings of the run's own process, before torch is imported: caches
    of anything that compiles at fixed paths inside the checkout; no Flax
    behind a library; one intra-op thread (the host paces this system, and
    idle worker threads spinning beside it move its timings)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[v] = "1"


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, workload: str, key: str) -> list[dict]:
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def run_cell(cell, bench: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START, control: bool = False, memo: dict | None = None,
             bench_dir: Path | None = None) -> tuple[dict, dict]:
    """Set up, run the window and judge it. Returns (result, compared).
    ``control`` also reads the control's gaps (``control.py``); ``memo``, a
    dict, carries the bs_sat memo from one call to the next (``sweep.py``,
    ``control.py``): a run of the benchmark fills its own. ``bench_dir``
    holds the reference and metric files (this directory by default)."""
    import numpy as np
    import torch

    from ooco_bench import clientstats, harness, judge, traffic
    from ooco_bench.cell import HERE, metric_readers, reference_module
    from ooco_bench.profile import summarize
    from ooco_bench.weights import dims, make_weights, weight_bytes

    config, mix, load = cell.config, cell.traffic, cell.load
    bench_dir = bench_dir or HERE
    dep = config["deployment"]
    n = dims(config)
    on_cuda = torch.device(device).type == "cuda"
    weights = make_weights(config, seed, device)
    log(f"weights made: {weight_bytes(weights) / 1e9:.3f} GB")
    rt = harness.build_runtime(config, weights, seed, device)
    spans = harness.Spans()
    spans.install(rt)
    log("runtime built" + (f"; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, card "
                           f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.3f} GB"
                           if on_cuda else ""))
    if memo is not None and memo:
        rt.pm._bs_sat_cache = dict(memo)     # a calibration tool's carry-over
        memo_s = 0.0
    else:
        memo_s = harness.fill_memo(rt, mix)
        if memo is not None:
            memo.update(rt.pm._bs_sat_cache)
    log(f"bs_sat memo filled in {memo_s:.2f} s")
    backlog = traffic.offline_backlog(mix, load["offline_backlog"], seed, n["V"])
    off_reqs, warm = harness.warm_backlog(rt, backlog, mix["warm"], dep["relaxed_decode_cap"])
    log(f"backlog warmed: {warm}")
    online = traffic.online_requests(mix, load["online_rate_qps"], seconds, seed, n["V"])
    if on_cuda:
        torch.cuda.synchronize()
    harness.steady_heap()
    setup_s = time.perf_counter() - t_start
    sl = harness.Slice(start=max(seconds - SLICE_S, 0.0)) if trace else None
    log(f"set-up done in {setup_s:.2f} s; window of {seconds} s, {len(online)} online requests")
    win = harness.run_window(rt, online, seconds, spans, n, sl)
    log(f"window closed at {win['close']:.3f} s after {win['rounds']} rounds")
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    prof = None
    if sl is not None:
        sl.prof.stop()
        prof = summarize(sl.prof, sl.t1 - sl.t0)
        prof["work"] = sl.work
        sl.prof = None
        log(f"profile read in {prof['parse_s']:.2f} s: {prof['device_events']} device events")

    # what the window served, before the program's state is freed
    prompts = {r.rid: q.prompt for r, q in zip(off_reqs, backlog)}
    prompts.update({c["req"].rid: q.prompt for c, q in zip(win["clients"], online)
                    if c["req"] is not None})
    cands = [(r.rid, r.prompt_len, r.output_len) for r, _ in win["finished"]]
    done = {c[0] for c in cands}
    inflight = [(rid, len(prompts[rid]), len(rt.generated_tokens(rid))) for rid in spans.kinds
                if rid not in done and rid in prompts and len(rt.generated_tokens(rid)) >= 1]
    lim = load["limits"]
    chosen = judge.choose(cands, spans.kinds, seed, lim["served_tokens_target"],
                          lim["judge_tokens_max"], inflight)
    streams = [(prompts[rid], np.asarray(rt.generated_tokens(rid))) for rid, _, _ in chosen]
    # a kind counts as ran where it served a token the judge can read: a
    # request that took part in it finished, or holds a token at the close
    # (not one whose prompt is still in its chunks, nor one evicted since)
    served = done | {c[0] for c in inflight}
    ran = sorted(set().union(*(ks for rid, ks in spans.kinds.items() if rid in served)))
    unserved = sorted(set().union(*spans.kinds.values()) - set(ran)) if spans.kinds else []
    covered = set().union(*(spans.kinds.get(rid, set()) for rid, _, _ in chosen)) if chosen else set()
    counters = {"dispatches": {}, "rounds": win["rounds"]}
    for pool, kind, *_ in spans.dispatches:
        counters["dispatches"][f"{pool}.{kind}"] = counters["dispatches"].get(f"{pool}.{kind}", 0) + 1
    summ = rt.summary()
    del rt
    harness.release_heap(on_cuda)
    if on_cuda:
        log(f"program state freed: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    t_ref = time.perf_counter()
    g = judge.gaps(reference_module(config, bench_dir), config, weights, streams, device,
                   control=control) if streams else {}
    ref_s = time.perf_counter() - t_ref
    log(f"reference over {len(streams)} requests in {ref_s:.2f} s: {g.get('program')}")

    client = clientstats.summary(win["clients"], win["close"], win["offline_tokens"],
                                 dep["slo_ttft_s"], dep["slo_tpot_s"])
    record = {
        "config": config, "dims": n, "client": client, "memo_s": memo_s,
        "dispatch_ms": {p: spans.dispatch_ms(p) for p in ("strict", "relaxed")},
        "profile": prof, "counters": counters,
    }
    prog = g.get("program", {"widest": float("inf"), "tokens": 0})
    compared = {
        "logit_gap": {"value": prog["widest"], "limit": lim["logit_gap"]},
        "tokens_compared": {"value": prog["tokens"], "limit": lim["tokens_compared_min"]},
        "kinds_uncovered": {"value": len(set(ran) - covered), "limit": 0},
    }
    correct = (prog["widest"] <= lim["logit_gap"]
               and prog["tokens"] >= lim["tokens_compared_min"]
               and not set(ran) - covered)
    if trace:
        readers = metric_readers([m["name"] for m in cell_metrics(bench, cell.name, "per_layer")],
                                 bench_dir)
        values = {k: f(record) for k, f in readers.items()}
    else:
        values = {**client, "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    wanted = {m["name"] for m in cell_metrics(bench, cell.name, "per_layer" if trace else "end_to_end")}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()
               if k in wanted and v is not None}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
    result = {"correct": bool(correct), "attempted": client["online_due"], "failed": 0,
              "metrics": metrics, "device": dev}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["detail"] = {
        "client": client, "warm": warm, "memo_s": memo_s, "setup_s": setup_s,
        "reference_s": ref_s, "gaps": g, "sampled": len(chosen),
        "kinds_ran": ran, "kinds_covered": sorted(covered), "kinds_unserved": unserved,
        "queue_mid": win["queue_mid"],
        "queue_end": win["queue_end"], "counters": counters, "gc": win["gc"],
        "dispatch_ms": record["dispatch_ms"],
        "runtime_spans": {k: {"count": c, "seconds": t} for k, (c, t) in spans.host.items()},
        "runtime": {k: summ[k] for k in ("dispatches_by_kind", "chunks", "chunk_preemptions",
                                         "evictions", "migrations", "pulls", "horizon_rounds",
                                         "mixed_horizon_rounds", "prefix_hits")},
        "profile": None if prof is None else {k: v for k, v in prof.items()
                                              if k not in ("device_ops", "idle_gaps")},
    }
    result["compared"] = compared
    return result, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    process_env()

    from ooco_bench.cell import load_cell, load_json
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"ooco_bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.cuda.reset_peak_memory_stats()
    result, compared = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"ooco_bench: the run loaded {bad}; the port's benchmark must not",
              file=sys.stderr)
        return 3
    for k, v in compared.items():
        print(f"compared {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
