"""End-to-end serving on the PyTorch port: real pool-based co-located serving.

N latency-strict + M latency-relaxed ServingEngines run a reduced model on a
CUDA card (both attention kernels) or, with ``--device cpu``, on the host;
online requests preempt offline prefills at transformer-layer granularity,
KV migrates between engine pairs (push after prefill, §3.4.3 pull when the
strict pool has headroom), and decode batches are selected under the TPOT
SLO: the full OOCO data path of Figure 4. The port of
``examples/serve_online_offline.py``. On the card in wall-clock mode the
scheduler plans with ``H100_SXM``, as ``repro_torch.launch.serve`` does.

  PYTHONPATH=src python examples/torch_serve_online_offline.py --duration 30
  PYTHONPATH=src python examples/torch_serve_online_offline.py \\
      --strict 1 --relaxed 2 --virtual-clock      # deterministic replay
"""
import argparse

from repro_torch.cluster.runtime import (POLICIES, PoolRuntime, VirtualClock,
                                         WallClock, replay_hw)
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch.serve import build_traces


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-7b")
    ap.add_argument("--policy", default="ooco", choices=list(POLICIES))
    ap.add_argument("--strict", type=int, default=1)
    ap.add_argument("--relaxed", type=int, default=1)
    ap.add_argument("--virtual-clock", action="store_true")
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--online-qps", type=float, default=0.4)
    ap.add_argument("--offline-qps", type=float, default=1.0)
    ap.add_argument("--trace", default="ooc",
                    choices=["ooc", "shared-prefix"])
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    clock = VirtualClock() if args.virtual_clock else WallClock()
    if args.virtual_clock:
        hw = replay_hw()
    else:
        hw = H100_SXM if args.device == "cuda" else None
    print(f"serving reduced {args.arch} under policy={args.policy} "
          f"({args.strict} strict + {args.relaxed} relaxed, "
          f"{'virtual' if args.virtual_clock else 'wall'} clock) ...")
    runtime = PoolRuntime(cfg, policy=args.policy, n_strict=args.strict,
                          n_relaxed=args.relaxed, clock=clock,
                          slo_ttft=2.0, slo_tpot=0.05, hw=hw,
                          seed=args.seed, device=args.device)
    online, offline = build_traces(args, cfg)   # same synthesis as the CLI
    m = runtime.run(online, offline, duration=args.duration,
                    max_prompt=args.max_prompt, max_output=24)

    print(f"finished: online={m['online_finished']}/{m['online_requests']} "
          f"offline={m['offline_finished']}/{m['offline_requests']} "
          f"in {m['elapsed']:.1f}s ({m['clock']} time)")
    print(f"offline throughput: {m['offline_tokens_per_s']:.1f} tok/s "
          f"({m['offline_tokens']} tokens)")
    if m["online_ttft_p50"] is not None:
        print(f"online TTFT p50={m['online_ttft_p50']:.3f}s "
              f"p99={m['online_ttft_p99']:.3f}s")
    if m["online_tpot_p50"] is not None:
        print(f"online TPOT p50={m['online_tpot_p50'] * 1e3:.1f}ms "
              f"p99={m['online_tpot_p99'] * 1e3:.1f}ms "
              f"(SLO {runtime.slo_tpot * 1e3:.0f}ms, "
              f"attainment {m['online_slo_attainment']:.0%})")
    print(f"layer-level preemptions: {m['preemptions']}, "
          f"migrations: {m['migrations']} (pulled: {m['pulls']}), "
          f"evictions: {m['evictions']}")
    print(f"rounds: {m['rounds']} (+{m['idle_rounds']} idle skipped)")
    print(f"fused dispatches: decode horizons={m['horizon_rounds']} "
          f"mixed horizons={m['mixed_horizon_rounds']} "
          f"({m['horizon_steps']} horizon steps over "
          f"{m['host_syncs']} host syncs)")
    by_kind = ", ".join(f"{k}={v}" for k, v in
                        sorted(m["dispatches_by_kind"].items()) if v)
    print(f"dispatches by kind: {by_kind or 'none'}")


if __name__ == "__main__":
    main()
