"""One run of a cell against the port: the runtime built as the cell's
configuration states, set-up (the scheduler's bs_sat memo, the offline
backlog warmed until its decode batch stops growing), the open-loop window
that submits online requests when they are due and steps the runtime, the
client's clock, the spans around the engines' dispatches, and the traced
slice. The program is driven through ``PoolRuntime.submit`` and
``PoolRuntime.step``, the calls its ``run()`` and its gateway make."""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ooco_bench import counts, traffic

#: the dispatches of a ``ServingEngine`` that the runtime calls
DISPATCHES = ("decode_step", "decode_horizon", "mixed_step", "mixed_horizon", "prefill")
#: the runtime's own host work inside ``step()`` that moves KV between or
#: out of the engines, timed apart from the scheduler's decisions
RUNTIME_SPANS = {"_migrate": "runtime.migrate", "_evict_from": "runtime.evict"}
SPAN = "ooco:"


def port_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file."""
    from repro_torch.models.config import DENSE, ModelConfig
    d, hq = config["hidden_size"], config["num_attention_heads"]
    return ModelConfig(
        name=config["name"], family=DENSE,
        num_layers=config["num_hidden_layers"], d_model=d, num_heads=hq,
        num_kv_heads=config["num_key_value_heads"], d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"], head_dim=d // hq,
        attn_bias=config["qkv_bias"], rope_theta=config["rope_theta"],
        norm_eps=config["rms_norm_eps"], dtype=config["torch_dtype"],
        tie_embeddings=config["tie_word_embeddings"], source=config["source"])


def build_runtime(config: dict, weights: dict, seed: int, device):
    """A ``PoolRuntime`` in the configuration's deployment over ``weights``."""
    from repro_torch.cluster.runtime import PoolRuntime, WallClock
    from repro_torch.core import hardware
    from repro_torch.models.model import build_model
    dep = config["deployment"]
    pcfg = port_config(config)
    return PoolRuntime(
        pcfg, policy=dep["policy"], n_strict=dep["n_strict"], n_relaxed=dep["n_relaxed"],
        clock=WallClock(), slo_ttft=dep["slo_ttft_s"], slo_tpot=dep["slo_tpot_s"],
        num_pages=dep["num_pages"], page_size=dep["page_size"], seed=seed,
        hw=getattr(hardware, dep["hw"]), decode_buckets=tuple(dep["decode_buckets"]),
        relaxed_decode_cap=dep["relaxed_decode_cap"], chunk_tokens=dep["chunk_tokens"],
        decode_horizon=dep["decode_horizon"], prefix_cache=dep["prefix_cache"],
        model=build_model(pcfg), params=weights, device=device)


def fill_memo(rt, mix: dict) -> float:
    """The scheduler's bs_sat memo for every power-of-two context bucket the
    mix can reach, as a server fills it at start-up. Returns its seconds."""
    t0 = time.perf_counter()
    for b in range(traffic.max_context(mix).bit_length()):
        rt.pm.compute_saturated_batch(1 << b)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# spans around the engines' dispatches
# ---------------------------------------------------------------------------

@dataclass
class Spans:
    """In the window: host spans of every outermost engine dispatch (pool,
    kind, start, end, in the profiled slice or not), which kinds of
    dispatch each request took part in, and the count and seconds of the
    runtime's KV moves (``RUNTIME_SPANS``). Installed on the engine and
    runtime instances; with ``annotate`` each is also a ``record_function``
    range."""
    dispatches: list = field(default_factory=list)
    kinds: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)
    recording: bool = False
    annotate: bool = False
    in_slice: bool = False

    def install(self, rt) -> None:
        for pool, slots in (("strict", rt.strict_pool), ("relaxed", rt.relaxed_pool)):
            for slot in slots:
                eng = slot.engine
                depth = [0]
                for kind in DISPATCHES:
                    setattr(eng, kind, self._wrap(getattr(eng, kind), pool, kind, depth))
        for attr, name in RUNTIME_SPANS.items():
            setattr(rt, attr, self._wrap_host(getattr(rt, attr), name))

    def _wrap(self, fn, pool: str, kind: str, depth: list):
        def call(rids, *args, **kw):
            if depth[0]:
                return fn(rids, *args, **kw)
            depth[0] += 1
            ctx = (torch.profiler.record_function(f"{SPAN}{pool}.{kind}")
                   if self.annotate else contextlib.nullcontext())
            t0 = time.perf_counter()
            out = None
            try:
                with ctx:
                    out = fn(rids, *args, **kw)
                return out
            finally:
                t1 = time.perf_counter()
                depth[0] -= 1
                if self.recording:
                    self.dispatches.append((pool, kind, t0, t1, self.in_slice))
                    self._note(rids, args, kw, f"{pool}.{kind}", out)
        return call

    def _wrap_host(self, fn, name: str):
        def call(*args, **kw):
            ctx = (torch.profiler.record_function(SPAN + name)
                   if self.annotate else contextlib.nullcontext())
            t0 = time.perf_counter()
            try:
                with ctx:
                    return fn(*args, **kw)
            finally:
                if self.recording:
                    c = self.host.setdefault(name, [0, 0.0])
                    c[0] += 1
                    c[1] += time.perf_counter() - t0
        return call

    def _note(self, rids, args, kw, kind, out) -> None:
        """``kind`` is "<pool>.<dispatch>": each pool's engine is its own
        state, so a kind is judged per pool."""
        if kind.endswith(".prefill"):   # one request; its first token once "done"
            if out == "done":
                self.kinds.setdefault(rids, set()).add(kind)
            return
        for r in rids:
            self.kinds.setdefault(r, set()).add(f"{kind}.decode")
        prid = kw.get("prefill_rid", args[0] if args else None)
        if ".mixed" in kind and prid is not None:
            self.kinds.setdefault(prid, set()).add(f"{kind}.chunk")

    def dispatch_ms(self, pool: str) -> float | None:
        """Mean host wall of a pool's dispatches outside the profiled slice."""
        xs = [t1 - t0 for p, _, t0, t1, sl in self.dispatches if p == pool and not sl]
        return 1e3 * float(np.mean(xs)) if xs else None


def annotate(name: str, on: bool):
    return torch.profiler.record_function(SPAN + name) if on else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# set-up: the offline backlog, warmed
# ---------------------------------------------------------------------------

def submit(rt, kind: str, req: traffic.Req, arrival: float):
    from repro_torch.core.request import Kind, Request
    r = Request(Kind.ONLINE if kind == "online" else Kind.OFFLINE, arrival,
                int(req.prompt.shape[0]), int(req.output_len))
    rt.submit(r, req.prompt.tolist())
    return r


def warm_backlog(rt, backlog: list, rule: dict, cap: int) -> tuple[list, dict]:
    """Submit the backlog and step the runtime until the offline requests in
    decode reach ``cap`` or stop growing for ``rule['stall_rounds']`` rounds
    (the pool is full), or ``rule['max_seconds']`` pass."""
    reqs = [submit(rt, "offline", q, rt.clock.now()) for q in backlog]
    t0 = time.perf_counter()
    best, stall, rounds = 0, 0, 0
    while True:
        rt.step()
        rounds += 1
        n = sum(1 for r in reqs if r.generated >= 1 and not r.done)
        if n > best:
            best, stall = n, 0
        else:
            stall += 1
        if n >= cap or stall >= rule["stall_rounds"]:
            break
        if time.perf_counter() - t0 > rule["max_seconds"]:
            break
    return reqs, {"warm_rounds": rounds, "warm_decoding": best,
                  "warm_s": time.perf_counter() - t0,
                  "warm_finished": sum(1 for r in reqs if r.done)}


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class GcPauses:
    """Seconds the garbage collector held the interpreter, by generation,
    while ``on``."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = 0.0
        self.on = False

    def __call__(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self._t0
            self.count[g] += 1


def steady_heap() -> None:
    """End of set-up: collect, then freeze what set-up made (weights' and
    runtime's objects, the backlog's prompts) out of the collector's scans,
    as a server does once it has started."""
    gc.collect()
    gc.freeze()


def release_heap(on_cuda: bool) -> None:
    """After the window, once the caller has dropped the runtime: unfreeze
    and collect, so that the engines (held in cycles with the span wrappers)
    and their KV pools are freed."""
    gc.unfreeze()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()


@dataclass
class Slice:
    """The traced slice: the profiler over whole rounds from ``start`` s
    after the window opens to its close, and per round the requests'
    progress, from which the model FLOPs and the kernels' least times are
    counted."""
    start: float
    prof: object = None
    t0: float = 0.0
    t1: float = 0.0
    work: dict = field(default_factory=lambda: {
        "decode_tokens": 0, "chunk_tokens": 0, "model_flops": 0.0,
        "paged_bytes": 0.0, "paged_flops": 0.0, "flash_least_s": 0.0})


def _progress(reqs) -> list:
    return [(r.generated, r.prefill_tokens_done, r.cached_tokens) for r in reqs]


def count_round(n: dict, reqs, before: list, work: dict) -> None:
    """Add one round's work to ``work``: each request's decode tokens (the
    paged kernel's rows) and prefill chunk (the flash kernel's queries),
    from the progress of its host record across the round."""
    for r, (g0, p0, c0) in zip(reqs, before):
        g1, p1, c1 = r.generated, r.prefill_tokens_done, r.cached_tokens
        if g1 < g0:          # evicted: its tokens are made again from the start
            g0 = 0
        if p1 < p0:
            p0 = 0
        p0 += c1 - c0 if c1 > c0 else 0   # a prefix claim is no compute
        if p1 > p0:
            s = p1 - p0
            work["chunk_tokens"] += s
            work["model_flops"] += counts.chunk_flops(n, p0, s, p1 == r.prompt_len)
            b, f = counts.flash_chunk(n, p0, s)
            work["flash_least_s"] += n["L"] * counts.least_seconds(b, f)
        for k in range(max(g0, 1), g1):   # token k + 1 attends prompt + k keys
            keys = r.prompt_len + k
            work["decode_tokens"] += 1
            work["model_flops"] += counts.decode_token_flops(n, keys)
            b, f = counts.paged_decode(n, keys, 1)
            work["paged_bytes"] += n["L"] * b
            work["paged_flops"] += n["L"] * f


def run_window(rt, online: list, seconds: float, spans: Spans, n: dict,
               trace: Slice | None = None) -> dict:
    """Submit each online request when due and step the runtime for
    ``seconds``. A token reaches the client at the return of the ``step()``
    that produced it. Returns the client's record of the window."""
    from repro_torch.core.request import Phase
    clients = [{"due": q.due, "times": [], "finished": False, "req": None} for q in online]
    offline = [r for r in rt.all_requests if r.kind.value == "offline"]
    hw = {r.rid: r.generated for r in offline}
    live_off = [r for r in offline if r.phase is not Phase.FINISHED]
    live_on: list = []
    finished: list = []           # (request, finish time) in the window
    delivered, nxt, rounds = 0, 0, 0
    queue_mid = None
    clock0 = rt.clock.now()
    t_open = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t_open

    # as PoolRuntime.run wires its trace feed: online work due but not yet
    # submitted counts for the runtime's preemption decisions
    rt.incoming_online = lambda: nxt < len(online) and online[nxt].due <= now()
    rt._next_online_arrival = lambda: clock0 + online[nxt].due if nxt < len(online) else None
    spans.recording = True
    tracing = False
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    pauses.on = True
    while True:
        t = now()
        if queue_mid is None and t >= seconds / 2:
            queue_mid = sum(1 for c in clients[:nxt] if not c["times"]) + sum(
                1 for q in online[nxt:] if q.due <= t)
        if t >= seconds:
            break
        if trace is not None and not tracing and t >= trace.start:
            trace.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            trace.prof.start()
            tracing = spans.annotate = spans.in_slice = True
            trace.t0 = time.perf_counter()
        with annotate("client", tracing):
            while nxt < len(online) and online[nxt].due <= t:
                c = clients[nxt]
                c["req"] = submit(rt, "online", online[nxt], clock0 + online[nxt].due)
                live_on.append(c)
                nxt += 1
        if tracing:
            watched = live_off + [c["req"] for c in live_on]
            before = _progress(watched)
        with annotate("round", tracing):
            worked = rt.step()
        if not worked:           # nothing to run: wait for the next arrival
            with annotate("idle", tracing):
                due = online[nxt].due if nxt < len(online) else seconds
                time.sleep(max(0.0, min(due, seconds) - now()) if due > now() else 0.0)
        t = now()
        rounds += 1
        with annotate("client", tracing):
            if tracing:
                count_round(n, watched, before, trace.work)
            for c in live_on:
                r = c["req"]
                g = min(r.generated, r.output_len)
                if g > len(c["times"]):
                    c["times"].extend([t] * (g - len(c["times"])))
                if r.phase is Phase.FINISHED:
                    c["finished"] = True
                    finished.append((r, t))
            live_on = [c for c in live_on if not c["finished"]]
            still = []
            for r in live_off:
                g = r.generated
                if g > hw[r.rid]:
                    delivered += g - hw[r.rid]
                    hw[r.rid] = g
                if r.phase is Phase.FINISHED:
                    finished.append((r, t))
                else:
                    still.append(r)
            live_off = still
    close = now()
    pauses.on = False
    gc.callbacks.remove(pauses)
    spans.recording = False
    if tracing:
        trace.t1 = time.perf_counter()
        spans.annotate = spans.in_slice = False
    queue_end = sum(1 for c in clients if not c["times"])
    return {"clients": clients, "close": close, "offline_tokens": delivered,
            "rounds": rounds, "finished": finished, "queue_mid": queue_mid,
            "queue_end": queue_end, "submitted": nxt,
            "gc": {"seconds": pauses.seconds, "count": pauses.count}}
