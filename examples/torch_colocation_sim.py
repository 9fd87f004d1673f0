"""Cluster-scale co-location experiment (Figure 6) via the PyTorch port's
discrete-event simulator: sweep offline load under the three policies and
report the max offline throughput each sustains within the online SLO, on an
H100's data-sheet rates. The port of ``examples/colocation_sim.py``.

The simulator computes on the host and touches no device: ``--device`` is
taken so that every example has the same command line, and changes nothing.

  PYTHONPATH=src python examples/torch_colocation_sim.py [--duration 120]
"""
import argparse

from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.data import traces as tr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-7b")
    ap.add_argument("--dataset", default="ooc",
                    choices=["ooc", "azure_conv", "azure_code"])
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--online-qps", type=float, default=6.0)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="unused: the simulator runs on the host")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    online = tr.online_trace(args.dataset, duration=args.duration,
                             mean_qps=args.online_qps, seed=0)
    pool = tr.offline_requests(20000, seed=1)
    print(f"{args.dataset}: {len(online)} online requests over "
          f"{args.duration:.0f}s (mean {args.online_qps}/s)")
    print(f"{'policy':16s} {'offQPS':>6s} {'viol%':>6s} {'off tok/s':>10s} "
          f"{'p99 TTFT':>9s} {'p50 TPOT':>9s}")
    for policy in ("base_pd", "online_priority", "ooco"):
        for qps in (4.0, 12.0, 32.0):
            off = tr.with_uniform_qps(pool, qps)
            sim = Simulator(cfg, H100_SXM, policy,
                            SimConfig(duration=args.duration, tp=args.tp))
            m = sim.run(online, off)
            print(f"{policy:16s} {qps:6.1f} "
                  f"{m['online_violation_rate']*100:6.1f} "
                  f"{m['offline_token_throughput']:10.1f} "
                  f"{m['online_p99_ttft']:8.2f}s "
                  f"{m['online_p50_tpot']*1e3:7.1f}ms")


if __name__ == "__main__":
    main()
