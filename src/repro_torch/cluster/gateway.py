"""Live serving gateway: asyncio streaming front end over ``PoolRuntime``.

The port of ``repro.cluster.gateway``. The runtime
(``repro_torch.cluster.runtime``) is a synchronous round-based scheduler; a
real deployment faces many concurrent clients that stream tokens,
disconnect mid-stream, time out, and arrive in bursts. This module bridges
the two worlds with ONE background thread that owns the runtime:

* the thread loops ``rt.step()`` under ``Gateway._lock`` and, after each
  round, polls every live stream's new tokens (``rt.generated_tokens`` +
  a per-stream emit offset) and fans them out to per-request
  ``asyncio.Queue``s via ``loop.call_soon_threadsafe`` — the only
  thread-safe way into the event loop;
* clients call ``await gateway.submit(...)`` and get a ``TokenStream``
  (async iterator of token ids); submission/cancellation take the same
  lock, so the runtime's single-threaded invariants hold.

The runtime thread issues all of the card's work. What PyTorch keeps per
thread is set up for it: the five engine dispatch entry points enter
``torch.inference_mode`` themselves; the thread makes the engines' CUDA
device its current one before the first round (a new thread starts on
device 0); the kernel wrappers launch on ``torch.cuda.current_stream``,
which is the device's default stream in that thread, as in a serving loop
run from the main thread. Migration, eviction and crash recovery run from
this thread too, on tensors that need no autograd state. The pinned upload
buffers of ``engine.kv_cache.to_device`` come from PyTorch's caching host
allocator, which is shared by every thread and safe across them.

Robustness pillars (the point of the layer):

* **cancellation** — ``TokenStream.cancel()`` (or the api layer, on client
  disconnect) aborts the request at any lifecycle stage through
  ``PoolRuntime.cancel``, which frees every KV page it held;
* **deadlines** — per-request TTFT/total deadlines ride on the ``Request``
  and are enforced by the runtime loop itself (``_enforce_deadlines``), so
  a gateway stall can never let a blown request keep burning FLOPs;
* **backpressure** — ``submit`` surfaces ``AdmissionRejected``
  synchronously when the bounded online queue is full; offline floods
  degrade through the runtime's defer/shed admission;
* **health & drain** — ``health()`` probes engine slots plus the
  crash/watchdog counters; ``drain()`` stops admission, lets in-flight
  streams run to completion or deadline, closes every client queue exactly
  once, then releases the retained page references (fault leases + prefix
  trees) so a leak-free shutdown ends with zero live pages per engine.

Eviction/crash recovery is invisible to streams by construction: greedy
regeneration is bit-identical, and the emit offset only advances — a
recovering request re-earns its prefix before new tokens flow.
"""
from __future__ import annotations

import asyncio
import threading
import time
from dataclasses import dataclass

import torch

from repro_torch.cluster.runtime import AdmissionRejected, PoolRuntime, WallClock
from repro_torch.core.request import Kind, Phase, Request

__all__ = ["Gateway", "GatewayClosed", "TokenStream", "AdmissionRejected"]

#: terminal outcomes a stream can report (exactly one per stream)
OUTCOMES = ("finished", "cancelled", "deadline", "error")


class GatewayClosed(RuntimeError):
    """Submit after the gateway stopped accepting (draining or stopped)."""


class _FifoLock:
    """A lock handed over in the order it was asked for. The runtime thread
    takes the lock again right after each round; under a plain lock it wins
    over a client thread that is already waiting (woken, but not yet
    running), so a submit or cancel would wait until the runtime ran out of
    work. Not reentrant: no holder takes it twice."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._tickets = 0
        self._serving = 0

    def __enter__(self) -> None:
        with self._cv:
            ticket = self._tickets
            self._tickets += 1
            self._cv.wait_for(lambda: self._serving == ticket)

    def __exit__(self, *exc) -> None:
        with self._cv:
            self._serving += 1
            self._cv.notify_all()


@dataclass
class _StreamState:
    """Gateway-side record of one live client stream."""
    rid: int
    req: Request
    queue: asyncio.Queue
    emitted: int = 0        # tokens already fanned out to the client
    closed: bool = False    # terminal event posted (exactly once)
    outcome: str | None = None


class TokenStream:
    """Async iterator over one request's output tokens.

    Yields token ids as the runtime produces them; iteration ends when the
    request reaches a terminal state, after which ``outcome`` is one of
    ``OUTCOMES``. ``cancel()`` aborts the request server-side (idempotent
    from the client's point of view: cancelling an already-terminal stream
    is a no-op here, unlike the strict ``PoolRuntime.cancel``)."""

    def __init__(self, gateway: "Gateway", req: Request,
                 queue: asyncio.Queue):
        self._gw = gateway
        self._q = queue
        self.req = req
        self.rid = req.rid
        self.outcome: str | None = None

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        if self.outcome is not None:
            raise StopAsyncIteration
        kind, payload = await self._q.get()
        if kind == "tok":
            return payload
        self.outcome = payload
        raise StopAsyncIteration

    async def cancel(self) -> bool:
        """Client-initiated abort; True if the request was still live."""
        return await self._gw.cancel(self.rid)


class Gateway:
    """Asyncio front end over a wall-clock ``PoolRuntime``.

    The runtime must use a ``WallClock`` (live serving); its ``interrupt``
    event is wired to the gateway's wake event so idle sleeps anywhere in
    the stack react to submits/cancels/shutdown within one slice."""

    def __init__(self, runtime: PoolRuntime, *, poll_interval: float = 0.005):
        if runtime.clock.virtual:
            raise ValueError(
                "Gateway drives live serving and needs a WallClock runtime; "
                "use PoolRuntime.run() for virtual-clock trace replay")
        self.rt = runtime
        self.poll_interval = poll_interval
        self._lock = _FifoLock()
        self._wake = threading.Event()
        if isinstance(runtime.clock, WallClock):
            runtime.clock.interrupt = self._wake
        self._streams: dict[int, _StreamState] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._accepting = False
        self.crashed: BaseException | None = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> "Gateway":
        if self._thread is not None:
            raise RuntimeError("gateway already started")
        self._loop = asyncio.get_running_loop()
        self._accepting = True
        self._thread = threading.Thread(
            target=self._run_loop, name="gateway-runtime", daemon=True)
        self._thread.start()
        return self

    def _run_loop(self) -> None:
        """The runtime thread: step the pools, fan out tokens, sleep only
        when truly idle (and then interruptibly). Any exception escaping
        the scheduler closes every stream with the ``error`` outcome
        instead of leaving clients awaiting forever."""
        try:
            pools = self.rt.strict_pool + self.rt.relaxed_pool
            # a tensor's device carries its index (the engine's may be "cuda")
            dev = pools[0].engine.cache.k_pool.device if pools else None
            if dev is not None and dev.type == "cuda":
                torch.cuda.set_device(dev)
            while not self._stop.is_set():
                self._wake.clear()
                with self._lock:
                    worked = self.rt.step()
                    self._publish()
                    idle = (not worked and not self.rt.online_queue
                            and not self.rt.offline_queue)
                if idle and not self._stop.is_set():
                    self._wake.wait(self.poll_interval)
        except BaseException as exc:  # noqa: BLE001 — surfaced to clients
            self.crashed = exc
            with self._lock:
                for st in list(self._streams.values()):
                    self._close_stream(st, "error")

    def _publish(self) -> None:
        """Fan new tokens out to client queues; close streams whose request
        reached a terminal state. Called with the lock held."""
        for st in list(self._streams.values()):
            toks = self.rt.generated_tokens(st.rid)
            while st.emitted < len(toks):
                self._post(st, ("tok", int(toks[st.emitted])))
                st.emitted += 1
            phase = st.req.phase
            if phase is Phase.FINISHED:
                self._close_stream(st, "finished")
            elif phase is Phase.CANCELLED:
                self._close_stream(st, "deadline"
                                   if st.req.cancel_reason == "deadline"
                                   else "cancelled")

    def _close_stream(self, st: _StreamState, outcome: str) -> None:
        """Terminal event, exactly once per stream (guarded by ``closed``
        and removal from the live map)."""
        if st.closed:
            return
        st.closed = True
        st.outcome = outcome
        self._streams.pop(st.rid, None)
        self._post(st, ("end", outcome))

    def _post(self, st: _StreamState, item: tuple) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return  # client world is gone; dropping the event is all we can do
        try:
            loop.call_soon_threadsafe(st.queue.put_nowait, item)
        except RuntimeError:
            pass  # loop closed between the check and the call

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    async def submit(self, prompt_tokens: list[int], *,
                     kind: Kind = Kind.ONLINE, max_new_tokens: int = 16,
                     ttft_deadline: float | None = None,
                     total_deadline: float | None = None) -> TokenStream:
        """Admit one request and return its token stream.

        Raises ``AdmissionRejected`` (backpressure), ``ValueError``
        (malformed prompt), or ``GatewayClosed`` (draining/stopped) — all
        synchronously, before the client ever waits on the stream."""
        if not self._accepting:
            raise GatewayClosed("gateway is draining or stopped")
        queue: asyncio.Queue = asyncio.Queue()
        toks = [int(t) for t in prompt_tokens]

        def _admit() -> Request:
            with self._lock:
                req = Request(kind, self.rt.clock.now(), len(toks),
                              max(int(max_new_tokens), 1),
                              ttft_deadline=ttft_deadline,
                              total_deadline=total_deadline)
                self.rt.submit(req, toks)   # may raise; nothing registered yet
                self._streams[req.rid] = _StreamState(req.rid, req, queue)
                return req

        req = await asyncio.to_thread(_admit)
        self._wake.set()
        return TokenStream(self, req, queue)

    async def cancel(self, rid: int) -> bool:
        """Abort a live request (client disconnect path). Returns True if
        it was still live, False if it already reached a terminal state —
        the benign disconnect/finish race is not an error here."""
        def _do() -> bool:
            with self._lock:
                st = self._streams.get(rid)
                try:
                    self.rt.cancel(rid)
                except ValueError:
                    return False
                if st is not None:
                    self._close_stream(st, "cancelled")
                return True

        live = await asyncio.to_thread(_do)
        self._wake.set()
        return live

    def health(self) -> dict:
        """Engine-slot liveness + fault counters + gateway state."""
        with self._lock:
            out = self.rt.health()
        out["accepting"] = self._accepting
        out["live_streams"] = len(self._streams)
        if self.crashed is not None:
            out["status"] = "dead"
            out["gateway_error"] = repr(self.crashed)
        return out

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def _work_pending(self) -> bool:
        rt = self.rt
        resident = any(s.resident or s.prefilling
                       for s in rt.strict_pool + rt.relaxed_pool)
        return bool(self._streams or rt.online_queue or rt.offline_queue
                    or rt.place_queue or resident)

    async def drain(self, timeout: float = 60.0) -> dict:
        """Graceful shutdown: stop admission, let in-flight streams run to
        completion (or their deadlines), force-cancel whatever outlives
        ``timeout``, stop the runtime thread, then release retained page
        references (fault leases + prefix trees). Returns a report whose
        ``leaked_pages`` must be all-zero — asserted by the load harness
        and the gateway tests."""
        self._accepting = False
        with self._lock:
            self.rt.draining = True
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pending = self._work_pending()
            if not pending or self.crashed is not None:
                break
            if time.monotonic() >= deadline:
                with self._lock:
                    for st in list(self._streams.values()):
                        try:
                            self.rt.cancel(st.rid)
                        except ValueError:
                            pass
                        self._close_stream(st, "cancelled")
                break
            await asyncio.sleep(0.01)
        await self.stop()
        with self._lock:
            released = self.rt.release_retained()
            leaks = self.rt.live_pages()
            summary = self.rt.summary()
        return {
            "leaked_pages": leaks,
            "released_retained": released,
            "drained": summary["drained"],
            "summary": summary,
        }

    async def stop(self) -> None:
        """Stop the runtime thread (does not touch runtime state; use
        ``drain`` for the graceful leak-free path)."""
        self._accepting = False
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            await asyncio.to_thread(self._thread.join)
            self._thread = None
