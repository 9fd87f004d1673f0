"""Serving launcher: real OOCO co-located serving (reduced model).

Drives the pool-based runtime (``repro_torch.cluster.runtime.PoolRuntime``):
N latency-strict + M latency-relaxed ServingEngines, the OOCO scheduling
points (§3.4) routed through the roofline perf model, and a pluggable clock
— wall-clock for live serving, virtual clock for deterministic trace replay
(same seed → bit-identical token streams and metrics JSON).

Engines run on a CUDA card by default (``--device cuda``); ``--device cpu``
runs them on the CPU with the plain attention versions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-7b \
      --policy ooco --strict 1 --relaxed 2 --virtual-clock --duration 20
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.cluster.runtime import (POLICIES, PoolRuntime, VirtualClock,
                                         WallClock, replay_hw)
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.data import traces as tr

def write_json_atomic(path: str, blob: str) -> None:
    """Write via a same-directory temp file + ``os.replace`` so a crash
    mid-write can never leave a truncated/corrupt metrics file: readers see
    either the previous complete file or the new complete file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CoLocatedServer(PoolRuntime):
    """PR-1 compatibility wrapper: the fixed 1-relaxed + 1-strict topology
    as a special case of the pool runtime (same ``submit``/``step`` API).
    Keeps the legacy whole-prompt prefill with layer-level interruption
    (``chunk_tokens=0``) — the PR-1 semantics its tests pin down."""

    def __init__(self, cfg, *, policy: str = "ooco", slo_tpot: float = 1.0,
                 num_pages: int = 1024, page_size: int = 16, seed: int = 0,
                 backend: str = "auto", device="cuda"):
        super().__init__(cfg, policy=policy, n_strict=1, n_relaxed=1,
                         clock=WallClock(), slo_tpot=slo_tpot,
                         num_pages=num_pages, page_size=page_size, seed=seed,
                         backend=backend, decode_buckets=(8,),
                         chunk_tokens=0, decode_horizon=1, device=device)

    @property
    def relaxed(self):
        return self.relaxed_pool[0].engine

    @property
    def strict(self):
        return self.strict_pool[0].engine


def build_traces(args, cfg):
    online = tr.online_trace("ooc", duration=args.duration,
                             mean_qps=args.online_qps, seed=args.seed)
    n_off = max(int(args.offline_qps * args.duration), 1)
    if args.trace == "shared-prefix":
        # P system prompts x Q few-shot variants x R queries with explicit
        # token content — the cross-request KV-reuse workload; sized to
        # the same offline request count as the ooc trace
        reqs = tr.shared_prefix_requests(
            num_prefixes=max(n_off // 8, 1), variants=2, queries=4,
            prefix_tokens=args.max_prompt // 2,
            variant_tokens=args.max_prompt // 8,
            query_tokens=args.max_prompt // 8,
            vocab=cfg.vocab_size, seed=args.seed + 1)[:n_off]
        offline = tr.with_uniform_qps(reqs, args.offline_qps)
    else:
        offline = tr.with_uniform_qps(
            tr.offline_requests(n_off, seed=args.seed + 1), args.offline_qps)
    return online, offline


def _auto_or_nonneg_int(knob):
    """argparse type: 'auto' or an int >= 0 (0 disables the feature).
    Raises ``ArgumentTypeError`` so junk exits with a one-line usage error
    instead of a deep ValueError traceback from the runtime."""
    def parse(s):
        if s == "auto":
            return s
        try:
            n = int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{knob} must be 'auto' or an integer >= 0 (got {s!r})")
        if n < 0:
            raise argparse.ArgumentTypeError(
                f"{knob} must be >= 0 (got {n}; 0 disables the feature)")
        return n
    return parse


def _positive_int(knob):
    """argparse type: an int >= 1."""
    def parse(s):
        try:
            n = int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{knob} must be an integer >= 1 (got {s!r})")
        if n < 1:
            raise argparse.ArgumentTypeError(
                f"{knob} must be >= 1 (got {n}; omit it for unbounded)")
        return n
    return parse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-7b")
    ap.add_argument("--policy", default="ooco", choices=list(POLICIES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run: cuda = the Hopper kernels on "
                         "the card (no fallback when none is present), cpu = "
                         "the plain PyTorch versions")
    ap.add_argument("--strict", type=int, default=1,
                    help="latency-strict pool size (decode under TPOT SLO)")
    ap.add_argument("--relaxed", type=int, default=1,
                    help="latency-relaxed pool size (prefill + offline decode)")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="deterministic trace replay: time advances by the "
                         "perf model instead of the wall clock")
    ap.add_argument("--chunk-tokens", default="auto",
                    type=_auto_or_nonneg_int("--chunk-tokens"),
                    help="chunked-prefill token budget per fused mixed "
                         "step: 'auto' picks it from the roofline ridge "
                         "(PerfModel.suggest_chunk_tokens), N fixes it, "
                         "0 disables chunking (legacy whole-prompt prefill "
                         "with layer-level interruption)")
    ap.add_argument("--decode-horizon", default="auto",
                    type=_auto_or_nonneg_int("--decode-horizon"),
                    help="multi-step decode horizon on latency-relaxed "
                         "rounds: 'auto' picks K from the decode roofline "
                         "(PerfModel.suggest_decode_horizon, amortizing the "
                         "per-dispatch overhead under the §3.4.1 preemption "
                         "bound), N fixes it, 1 disables fusion (one host "
                         "sync per token — today's behavior)")
    ap.add_argument("--trace", default="ooc",
                    choices=["ooc", "shared-prefix"],
                    help="offline workload: 'ooc' draws lengths from the "
                         "paper's Table-5 statistics; 'shared-prefix' "
                         "generates P system prompts x Q few-shot variants "
                         "x R queries with explicit token content (the "
                         "cross-request KV-reuse workload)")
    ap.add_argument("--prefix-cache", default="on", choices=["on", "off"],
                    help="cross-request KV reuse: radix prefix cache over "
                         "resident pages with refcounted copy-on-write "
                         "sharing (chunked-prefill path only; greedy token "
                         "streams are bit-identical either way)")
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--online-qps", type=float, default=0.5)
    ap.add_argument("--offline-qps", type=float, default=1.0)
    ap.add_argument("--slo-ttft", type=float, default=2.0)
    ap.add_argument("--slo-tpot", type=float, default=0.05)
    ap.add_argument("--num-pages", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-prompt", type=int, default=64)
    ap.add_argument("--max-output", type=int, default=32)
    ap.add_argument("--metrics-json", default=None,
                    help="write the metrics summary to this path "
                         "(atomically: temp file + os.replace)")
    ap.add_argument("--tokens-json", default=None,
                    help="write the finished-request signature (per-request "
                         "identity + full token stream) to this path — the "
                         "chaos-replay CI job byte-diffs it across runs")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault injection for chaos replay: "
                         "a JSON file/list of events or the compact spec "
                         "'kind[:engine][@t][:k=v...]', comma-separated. "
                         "Kinds: crash, stuck, page_leak, migration_fail, "
                         "migration_corrupt, migration_flaky. Example: "
                         "'crash:relaxed1@3.0,migration_flaky:p=0.25'. "
                         "Same plan + --chaos-seed => bit-identical metrics "
                         "and token streams under --virtual-clock")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the fault injector's RNG (flaky-transfer "
                         "coin flips, retry-backoff jitter); replays with "
                         "the same seed are bit-reproducible")
    ap.add_argument("--max-online-queue",
                    type=_positive_int("--max-online-queue"), default=None,
                    help="bounded online admission queue: overflowing "
                         "submits raise AdmissionRejected (backpressure) "
                         "instead of growing host state without bound")
    ap.add_argument("--replay-hw", default="cpu", choices=["cpu", "v5e"],
                    help="virtual-clock hardware calibration preset: 'cpu' "
                         "scales rates to CPU-smoke-test sizes; 'v5e' keeps "
                         "the real TPU v5e dispatch overheads against "
                         "uniformly scaled rates — the datacenter "
                         "overhead:work ratio where horizons pay "
                         "(ignored without --virtual-clock)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    cfg = get_config(args.arch).reduced()
    clock = VirtualClock() if args.virtual_clock else WallClock()
    if args.virtual_clock:
        hw = replay_hw(args.replay_hw)
    else:
        hw = H100_SXM if args.device == "cuda" else None
    chunk = args.chunk_tokens
    horizon = args.decode_horizon
    runtime = PoolRuntime(cfg, policy=args.policy, n_strict=args.strict,
                          n_relaxed=args.relaxed, clock=clock,
                          slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
                          num_pages=args.num_pages, seed=args.seed,
                          device=args.device, hw=hw, chunk_tokens=chunk,
                          decode_horizon=horizon,
                          prefix_cache=args.prefix_cache == "on",
                          fault_plan=args.fault_plan,
                          chaos_seed=args.chaos_seed,
                          max_online_queue=args.max_online_queue)
    online, offline = build_traces(args, cfg)
    summary = runtime.run(online, offline, duration=args.duration,
                          max_prompt=args.max_prompt,
                          max_output=args.max_output)
    blob = json.dumps(summary, sort_keys=True, indent=2)
    print(blob)
    if args.metrics_json:
        write_json_atomic(args.metrics_json, blob + "\n")
    if args.tokens_json:
        write_json_atomic(
            args.tokens_json,
            json.dumps(runtime.finished_signature()) + "\n")
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
