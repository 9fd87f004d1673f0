"""Live gateway walkthrough on the PyTorch port: async streams,
cancellation, deadlines, backpressure, health, and a leak-free drain, with
engines on a CUDA card (both attention kernels) or, with ``--device cpu``,
on the host. The port of ``examples/serve_gateway.py``:

1. concurrent clients stream tokens as the pools produce them;
2. one client disconnects mid-stream (its KV pages are freed instantly);
3. one request carries a total deadline tight enough to blow (the runtime
   aborts it and bills the SLO violation: it never goes silent);
4. a burst overflows the bounded online queue (``AdmissionRejected``);
5. a health probe reports engine-slot liveness and queue depths;
6. a graceful drain finishes in-flight work and proves zero live pages.

``--backend auto`` (the default) runs the kernels on the card and their plain
versions on the host; ``ref`` asks for the plain versions anywhere.

  PYTHONPATH=src python examples/torch_serve_gateway.py
  PYTHONPATH=src python examples/torch_serve_gateway.py --clients 12 --relaxed 2
"""
import argparse
import asyncio

from repro_torch.cluster.gateway import AdmissionRejected, Gateway
from repro_torch.cluster.runtime import PoolRuntime, WallClock
from repro_torch.configs import get_config
from repro_torch.core.request import Kind
from repro_torch.kernels import BACKENDS


async def demo(args) -> int:
    cfg = get_config(args.arch).reduced()
    print(f"building {args.strict} strict + {args.relaxed} relaxed "
          f"engines (reduced {args.arch}) ...")
    runtime = PoolRuntime(cfg, policy="ooco", n_strict=args.strict,
                          n_relaxed=args.relaxed, clock=WallClock(),
                          slo_ttft=30.0, slo_tpot=1.0, num_pages=256,
                          page_size=8, backend=args.backend,
                          max_online_queue=args.max_online_queue,
                          device=args.device)
    gateway = Gateway(runtime)
    await gateway.start()

    async def client(i: int) -> str:
        kw = {}
        role = "plain"
        if i == 0:
            role = "disconnect"
        elif i == 1:
            role, kw["total_deadline"] = "tight-deadline", 0.001
        elif i == 2:
            role, kw["kind"] = "offline", Kind.OFFLINE
        try:
            stream = await gateway.submit(
                [i * 7 + t for t in range(1, 9)],
                max_new_tokens=args.tokens, **kw)
        except AdmissionRejected:
            print(f"  client {i:2d} [{role}] -> rejected (backpressure)")
            return "rejected"
        toks = []
        async for tok in stream:
            toks.append(tok)
            if role == "disconnect" and len(toks) >= 2:
                await stream.cancel()
                break
        print(f"  client {i:2d} [{role}] -> {stream.outcome or 'cancelled'} "
              f"after {len(toks)} tokens")
        return stream.outcome or "cancelled"

    outcomes = await asyncio.gather(
        *(client(i) for i in range(args.clients)))

    health = gateway.health()
    print(f"health: status={health['status']} "
          f"engines={[(e['name'], 'up' if e['alive'] else 'down') for e in health['engines']]} "
          f"queued={health['queued_online']}+{health['queued_offline']}")

    report = await gateway.drain(timeout=60.0)
    leaked = sum(report["leaked_pages"].values())
    s = report["summary"]
    print(f"drained: finished={s['online_finished'] + s['offline_finished']} "
          f"cancelled={s['cancelled']} deadline_aborts={s['deadline_aborts']} "
          f"rejected={s['rejected_online']}")
    print(f"leaked pages after drain: {report['leaked_pages']} "
          f"({'LEAK!' if leaked else 'clean'})")
    assert sorted(set(outcomes)) and leaked == 0
    return 1 if leaked else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-7b")
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS))
    ap.add_argument("--strict", type=int, default=1)
    ap.add_argument("--relaxed", type=int, default=1)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-online-queue", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    return asyncio.run(demo(args))


if __name__ == "__main__":
    raise SystemExit(main())
