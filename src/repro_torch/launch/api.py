"""HTTP serving entrypoint over the live gateway (stdlib asyncio only).

The port of ``repro.launch.api``. Engines run on a CUDA card by default
(``--device cuda``, the hand-written Hopper kernels, no fallback when no
card is present); ``--device cpu`` runs them on the CPU with the plain
attention versions.

A deliberately small HTTP/1.1 layer — no framework dependency — exposing
the gateway's full robustness surface:

* ``POST /v1/generate``  body ``{"prompt": [ids], "kind": "online",
  "max_new_tokens": 16, "ttft_deadline": null, "total_deadline": null}``
  → a newline-delimited JSON stream: first ``{"rid": N}``, then one
  ``{"token": id}`` per generated token, finally ``{"done": outcome}``
  with outcome in finished/cancelled/deadline/error. A client that
  disconnects mid-stream cancels its request server-side (every KV page
  freed); a full online queue answers 429 immediately (backpressure).
* ``GET  /healthz``      → engine-slot liveness, queue depths, and the
  crash/watchdog counters; 200 while serving, 503 once dead/stopped.
* ``POST /v1/cancel``    body ``{"rid": N}`` → explicit abort.

Shutdown (SIGINT/SIGTERM or ``--duration``) is a graceful drain: admission
stops, in-flight streams run to completion or deadline, and the process
exits nonzero if any engine still holds allocated pages afterwards — the
zero-leak contract, enforced at the process boundary.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.api --arch qwen2.5-7b --port 8080
  PYTHONPATH=src python -m repro_torch.launch.api --device cpu --selftest
"""
from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys

from repro_torch.cluster.gateway import AdmissionRejected, Gateway, GatewayClosed
from repro_torch.cluster.runtime import PoolRuntime, WallClock
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.request import Kind


def _response(status: str, body: bytes,
              content_type: str = "application/json") -> bytes:
    return (f"HTTP/1.1 {status}\r\nContent-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
            ).encode() + body


def _json_response(status: str, obj) -> bytes:
    return _response(status, json.dumps(obj).encode() + b"\n")


async def _read_request(reader: asyncio.StreamReader):
    """Parse one HTTP request: (method, path, body) or None on junk/EOF."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) < 2:
        return None
    method, path = parts[0].upper(), parts[1]
    length = 0
    while True:
        hdr = await reader.readline()
        if hdr in (b"\r\n", b"\n", b""):
            break
        name, _, value = hdr.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            try:
                length = int(value.strip())
            except ValueError:
                return None
    body = await reader.readexactly(length) if length else b""
    return method, path, body


async def _handle_generate(gateway: Gateway, body: bytes,
                           writer: asyncio.StreamWriter) -> None:
    try:
        spec = json.loads(body or b"{}")
        prompt = [int(t) for t in spec["prompt"]]
    except (json.JSONDecodeError, KeyError, TypeError, ValueError):
        writer.write(_json_response(
            "400 Bad Request", {"error": "body must be JSON with a "
                                "'prompt' list of token ids"}))
        return
    kind = Kind.OFFLINE if spec.get("kind") == "offline" else Kind.ONLINE
    try:
        stream = await gateway.submit(
            prompt, kind=kind,
            max_new_tokens=int(spec.get("max_new_tokens", 16)),
            ttft_deadline=spec.get("ttft_deadline"),
            total_deadline=spec.get("total_deadline"))
    except AdmissionRejected as exc:
        writer.write(_json_response("429 Too Many Requests",
                                    {"error": str(exc)}))
        return
    except GatewayClosed as exc:
        writer.write(_json_response("503 Service Unavailable",
                                    {"error": str(exc)}))
        return
    except ValueError as exc:
        writer.write(_json_response("400 Bad Request", {"error": str(exc)}))
        return
    writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: application/x-ndjson\r\n"
                 b"Connection: close\r\n\r\n")
    writer.write(json.dumps({"rid": stream.rid}).encode() + b"\n")
    try:
        await writer.drain()
        async for tok in stream:
            writer.write(json.dumps({"token": tok}).encode() + b"\n")
            await writer.drain()
        writer.write(json.dumps({"done": stream.outcome}).encode() + b"\n")
    except (ConnectionError, asyncio.CancelledError):
        # mid-stream disconnect: free the server-side state and re-raise
        # cancellation (the event loop owns task teardown)
        await stream.cancel()
        raise


async def _handle(gateway: Gateway, reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter) -> None:
    try:
        parsed = await _read_request(reader)
        if parsed is None:
            return
        method, path, body = parsed
        if method == "GET" and path == "/healthz":
            health = gateway.health()
            status = ("200 OK" if health["status"] in ("ok", "degraded")
                      else "503 Service Unavailable")
            writer.write(_json_response(status, health))
        elif method == "POST" and path == "/v1/generate":
            await _handle_generate(gateway, body, writer)
        elif method == "POST" and path == "/v1/cancel":
            try:
                rid = int(json.loads(body or b"{}")["rid"])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                writer.write(_json_response(
                    "400 Bad Request", {"error": "body must be JSON with "
                                        "an integer 'rid'"}))
            else:
                live = await gateway.cancel(rid)
                writer.write(_json_response("200 OK", {"rid": rid,
                                                       "cancelled": live}))
        else:
            writer.write(_json_response("404 Not Found",
                                        {"error": f"no route {method} {path}"}))
        await writer.drain()
    except (ConnectionError, asyncio.IncompleteReadError):
        pass
    finally:
        try:
            writer.close()
            await writer.wait_closed()
        except (ConnectionError, RuntimeError):
            pass


def build_runtime(args) -> PoolRuntime:
    cfg = get_config(args.arch).reduced()
    return PoolRuntime(
        cfg, policy=args.policy, n_strict=args.strict,
        n_relaxed=args.relaxed, clock=WallClock(),
        slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
        num_pages=args.num_pages, page_size=args.page_size, seed=args.seed,
        backend=args.backend, max_online_queue=args.max_online_queue,
        max_offline_backlog=args.max_offline_backlog,
        fault_plan=args.fault_plan, chaos_seed=args.chaos_seed,
        device=args.device, hw=H100_SXM if args.device == "cuda" else None)


async def _selftest(gateway: Gateway, host: str, port: int) -> None:
    """In-process smoke of the HTTP surface: one streamed completion, one
    mid-stream disconnect, one cancel endpoint call, one health probe."""
    async def post(path: str, obj, read_all: bool = True) -> bytes:
        reader, writer = await asyncio.open_connection(host, port)
        body = json.dumps(obj).encode()
        writer.write(f"POST {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        await writer.drain()
        data = await reader.read() if read_all else await reader.readline()
        writer.close()
        return data

    prompt = list(range(1, 9))
    full = await post("/v1/generate", {"prompt": prompt, "max_new_tokens": 4})
    if b'"done": "finished"' not in full:
        raise RuntimeError(f"selftest: the streamed completion did not finish: {full!r}")

    # disconnect mid-stream: open, read the rid line, slam the connection
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps({"prompt": prompt, "max_new_tokens": 64}).encode()
    writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    while b'"rid"' not in await reader.readline():
        pass
    writer.close()

    reader, writer = await asyncio.open_connection(host, port)
    writer.write(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
    await writer.drain()
    health = await reader.read()
    writer.close()
    if b"200 OK" not in health:
        raise RuntimeError(f"selftest: /healthz answered {health!r}")
    print("selftest: generate/disconnect/healthz OK")


async def serve(args) -> int:
    runtime = build_runtime(args)
    gateway = Gateway(runtime)
    await gateway.start()
    server = await asyncio.start_server(
        lambda r, w: _handle(gateway, r, w), args.host, args.port)
    port = server.sockets[0].getsockname()[1]
    print(f"gateway listening on {args.host}:{port} "
          f"(policy={args.policy}, strict={args.strict}, "
          f"relaxed={args.relaxed})")
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
    if args.selftest:
        await _selftest(gateway, "127.0.0.1", port)
        stop.set()
    elif args.duration is not None:
        loop.call_later(args.duration, stop.set)
    await stop.wait()
    server.close()
    await server.wait_closed()
    report = await gateway.drain(timeout=args.drain_timeout)
    leaks = {k: v for k, v in report["leaked_pages"].items() if v}
    print(json.dumps({"drained": report["drained"],
                      "leaked_pages": report["leaked_pages"]}, indent=2))
    if leaks:
        print(f"LEAK: pages still allocated after drain: {leaks}",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-7b")
    ap.add_argument("--policy", default="ooco")
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "ref"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run: cuda = the Hopper kernels on "
                         "the card (no fallback when none is present), cpu = "
                         "the plain PyTorch versions")
    ap.add_argument("--strict", type=int, default=1)
    ap.add_argument("--relaxed", type=int, default=1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 picks an ephemeral port")
    ap.add_argument("--slo-ttft", type=float, default=2.0)
    ap.add_argument("--slo-tpot", type=float, default=0.05)
    ap.add_argument("--num-pages", type=int, default=1024)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-online-queue", type=int, default=64,
                    help="bounded online admission queue: overflow answers "
                         "429 instead of growing host state (None-like 0 "
                         "disables the bound)")
    ap.add_argument("--max-offline-backlog", type=int, default=None,
                    help="bounded offline backlog: overflow is shed through "
                         "admission_decision (surfaced, never silent)")
    ap.add_argument("--duration", type=float, default=None,
                    help="serve for N seconds then drain (default: until "
                         "SIGINT/SIGTERM)")
    ap.add_argument("--drain-timeout", type=float, default=60.0)
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic chaos, same spec as repro_torch.launch.serve")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--selftest", action="store_true",
                    help="bind an ephemeral port, run an in-process HTTP "
                         "smoke (stream, disconnect, healthz), drain, exit")
    args = ap.parse_args(argv)
    if args.selftest:
        args.port = 0
    if args.max_online_queue is not None and args.max_online_queue <= 0:
        args.max_online_queue = None
    return asyncio.run(serve(args))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
