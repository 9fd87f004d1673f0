"""Pool-based co-located serving runtime: N strict + M relaxed REAL engines.

This is the cluster layer of the paper (§3.1–3.4) executing on actual
``ServingEngine`` instances instead of the discrete-event simulator: the
latency-strict pool decodes online traffic under the TPOT SLO, the
latency-relaxed pool absorbs prefills and offline decoding, and every
scheduling point routes through the *same* ``core.scheduling`` functions and
the Roofline ``PerfModel`` the simulator uses — ``last_bottleneck`` per
instance steers eviction-victim selection, the strict-pool pressure EMA
feeds the §3.4.2 gating cost model, and the §3.4.3 pull migration moves real
KV pages between any relaxed→strict engine pair.

Clocking is pluggable:

* ``WallClock`` — live serving; step latencies are measured, idle rounds
  sleep until the next arrival instead of spinning.
* ``VirtualClock`` — **deterministic trace replay**: tokens come from the
  real model compute, but time advances by the perf model's modeled step
  latencies, so two replays of the same trace produce bit-identical token
  streams, finished sets, and metrics (the foundation for policy
  regression gates — see tests/test_colocation_runtime.py and the
  ``colocation-replay`` CI step).

Pools execute in parallel in a real deployment, so a virtual round advances
by the *maximum* modeled cost across engines; each engine's actions within
a round (prefill, then decode) are serialized and their costs summed.

Fault tolerance (``cluster.faults``): a seeded ``FaultPlan`` can crash
engines, wedge dispatches, leak pool pages, and fail/corrupt KV transfers —
all deterministically, so chaos replays are bit-reproducible. Crashed
engines' in-flight requests are re-admitted from the frontend prompt log
through the recompute path (greedy streams regenerate bit-identical
tokens); a crashed strict engine promotes a drained relaxed engine; KV
migration retries with seeded backoff and falls back to recompute; and
under overload, admission control defers (optionally sheds) offline work
first so online SLO attainment decays last.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.cluster.faults import FaultInjector, FaultPlan
from repro_torch.core import scheduling as sch
from repro_torch.core.hardware import cpu_measured
from repro_torch.core.perf_model import HardwareParams, PerfModel
from repro_torch.core.request import Kind, Phase, Request
from repro_torch.data.traces import TraceRequest
from repro_torch.engine.engine import ServingEngine
from repro_torch.engine.kv_cache import TransferIntegrityError
from repro_torch.kernels import require_device
from repro_torch.models.model import build_model

POLICIES = ("base_pd", "online_priority", "ooco")


def replay_hw(profile: str = "cpu") -> HardwareParams:
    """Replay calibration presets for the virtual clock.

    ``"cpu"`` (default, alias ``"cpu_scale"``): the reduced smoke-test
    models serve requests of tens of tokens, so with datacenter rates every
    step would collapse into the static overhead and no policy could be
    distinguished. This calibration scales the achievable rates down so
    that reduced-model request sizes reproduce the full-scale bottleneck
    structure: decode attention is memory-bound and grows with context
    length, GEMMs saturate within a few tens of requests, and the per-step
    overhead stays a minority term.

    ``"v5e"``: datacenter-ratio preset — the TPU v5e achievable rates
    scaled down uniformly so reduced-model work takes simulable time, but
    with the FULL v5e dispatch overheads (O_p=8ms, O_d=4ms) kept as-is.
    The overhead:work ratio therefore matches the real chip (per-dispatch
    overhead is a large fraction of a small decode step), which is the
    regime where multi-step horizons and fused mixed horizons pay — the
    datacenter-scale replay the ROADMAP calls for.

    All presets are fixed constants — never measured — so virtual-clock
    replays are machine-independent.
    """
    if profile in ("cpu", "cpu_scale"):
        return HardwareParams(
            name="replay_cpu_scale",
            F_g=5e9, F_ap=3e9, F_ad=1e9,
            M_g=1e9, M_a=2e7,
            O_p=2e-3, O_d=1e-3,
            B_c=1e8, hbm_capacity=64e6,
            peak_flops=5e9, peak_hbm_bw=1e9)
    if profile == "v5e":
        from repro_torch.core.hardware import TPU_V5E
        # s=100 keeps a reduced-model weight stream (~20 MB -> ~2 ms)
        # under the unscaled O_d (4 ms), preserving the real chip's
        # overhead-dominated decode steps; a much larger s would invert
        # the ratio (streaming above overhead) and no horizon could ever
        # pay, which is the cpu-scale regime, not the datacenter one
        s = 100.0
        return HardwareParams(
            name="replay_v5e_scale",
            F_g=TPU_V5E.F_g / s, F_ap=TPU_V5E.F_ap / s,
            F_ad=TPU_V5E.F_ad / s,
            M_g=TPU_V5E.M_g / s, M_a=TPU_V5E.M_a / s,
            O_p=TPU_V5E.O_p, O_d=TPU_V5E.O_d,
            B_c=TPU_V5E.B_c / s, hbm_capacity=64e6,
            peak_flops=TPU_V5E.peak_flops / s,
            peak_hbm_bw=TPU_V5E.peak_hbm_bw / s)
    raise ValueError(f"unknown replay_hw profile {profile!r}; "
                     "expected 'cpu' or 'v5e'")


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class WallClock:
    """Live-serving clock: real time, bounded sleep when idle.

    ``interrupt`` (an optional ``threading.Event``) makes idle sleeps
    responsive to live signals: the gateway sets it on submit / cancel /
    shutdown so a long idle gap never delays reacting to a client by more
    than one slice. Without an event, plain ``time.sleep`` slices give the
    same bounded-latency property to signal handlers."""

    virtual = False

    #: max seconds one idle sleep may block before re-checking for signals
    IDLE_SLICE = 0.005

    def __init__(self, interrupt=None):
        self._t0 = time.perf_counter()
        self.interrupt = interrupt

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance(self, dt: float) -> None:
        pass  # wall time advances by itself

    def reset(self) -> None:
        """Re-anchor t=0 (run() calls this so engine construction and
        import time never count against trace-relative TTFTs)."""
        self._t0 = time.perf_counter()

    def idle_until(self, t: float) -> None:
        """Sleep toward t in small interruptible slices (the busy-loop fix:
        idle rounds must not spin ``step()`` and dilute measured
        throughput; the slice bound keeps cancel/shutdown latency under
        ``IDLE_SLICE`` even across a long idle gap)."""
        while True:
            delta = t - self.now()
            if delta <= 0:
                return
            nap = min(delta, self.IDLE_SLICE)
            if self.interrupt is not None:
                if self.interrupt.wait(nap):
                    return  # woken by a live signal: let the caller react
            else:
                time.sleep(nap)


class VirtualClock:
    """Deterministic replay clock: time is whatever the perf model says."""

    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += float(dt)

    def idle_until(self, t: float) -> None:
        self._now = max(self._now, float(t))

    def reset(self) -> None:
        pass  # virtual time only moves by advance()/idle_until()


# ---------------------------------------------------------------------------
# pool state + metrics
# ---------------------------------------------------------------------------

@dataclass
class EngineSlot:
    """One engine instance plus the §3.4 per-instance scheduling state."""
    name: str
    role: str                      # "strict" | "relaxed"
    engine: ServingEngine
    online: list[Request] = field(default_factory=list)
    offline: list[Request] = field(default_factory=list)
    # chunk-granular prefills in progress on this engine (KV pinned here);
    # index 0 is the one currently advancing
    prefilling: list = field(default_factory=list)
    last_bottleneck: str = "memory"
    pressure: float = 0.0          # strict-pool online-latency EMA (§3.4.2)

    @property
    def resident(self) -> int:
        return len(self.online) + len(self.offline)


@dataclass
class Metrics:
    """Runtime counters; ``PoolRuntime.summary()`` turns these plus the
    per-request SLO accounting into the policy-comparison record."""
    rounds: int = 0
    idle_rounds: int = 0
    migrations: int = 0
    pulls: int = 0
    evictions: int = 0
    chunks: int = 0                # prefill chunks executed (fused rounds)
    chunk_preemptions: int = 0     # §3.4.1 pauses at chunk boundaries
    horizon_rounds: int = 0        # rounds dispatched as K>1 decode horizons
    mixed_horizon_rounds: int = 0  # rounds dispatched as K>1 fused mixed
                                   # horizons (chunk + decode in one scan)
    engine_crashes: int = 0        # fault injection: engines lost
    promotions: int = 0            # relaxed->strict failover promotions
    recoveries: int = 0            # requests re-admitted after a crash
    migration_retries: int = 0     # failed KV-transfer attempts retried
    migration_recomputes: int = 0  # transfers that fell back to recompute
    watchdog_aborts: int = 0       # stuck dispatches killed by the watchdog
    shed_requests: int = 0         # offline work shed under bounded backlog
    degraded_rounds: int = 0       # rounds run under overload admission
    cancelled: int = 0             # client-cancelled requests (any stage)
    deadline_aborts: int = 0       # requests aborted past their deadline
    rejected_online: int = 0       # online submits bounced at admission
    drained: int = 0               # requests finished during graceful drain
    prefill_modeled_seconds: float = 0.0  # modeled prefill compute (chunk-
                                   # only share of fused rounds) — the
                                   # denominator of effective prefill tok/s


def _pct(xs: list[float], q: float) -> float | None:
    return float(np.percentile(xs, q)) if xs else None


class AdmissionRejected(RuntimeError):
    """Online submit bounced by backpressure: the bounded online admission
    queue is full. Raised synchronously from ``submit`` so the caller (the
    gateway) can fail the client fast instead of letting an online flood
    grow host state without bound. Offline floods degrade through the
    existing defer/shed path (``admission_decision``) and never raise."""


def _validate_runtime_args(*, policy, n_strict, n_relaxed, slo_ttft, slo_tpot,
                           num_pages, page_size, decode_horizon, max_horizon,
                           chunk_tokens, max_transfer_attempts,
                           max_offline_backlog, max_online_queue) -> None:
    """Constructor-time validation: reject impossible topologies, SLOs, and
    scheduling knobs with actionable ``ValueError``s instead of the index/
    shape errors they would otherwise become deep inside a replay."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; "
                         f"expected one of {POLICIES}")
    if n_strict + n_relaxed <= 0:
        raise ValueError("PoolRuntime needs at least one engine "
                         f"(n_strict={n_strict}, n_relaxed={n_relaxed})")
    if n_strict < 1 or n_relaxed < 1:
        raise ValueError(
            "PoolRuntime needs >= 1 strict and >= 1 relaxed engine (got "
            f"n_strict={n_strict}, n_relaxed={n_relaxed}): the strict pool "
            "serves online decode, the relaxed pool runs prefill. Pools "
            "may still shrink to zero at runtime via fault injection.")
    if slo_ttft <= 0 or slo_tpot <= 0:
        raise ValueError("SLOs must be positive seconds "
                         f"(slo_ttft={slo_ttft}, slo_tpot={slo_tpot})")
    if num_pages < 2 or page_size < 1:
        raise ValueError("KV pool needs num_pages >= 2 (page 0 is reserved) "
                         f"and page_size >= 1 (got num_pages={num_pages}, "
                         f"page_size={page_size})")
    if max_horizon < 1:
        raise ValueError(f"max_horizon must be >= 1 (got {max_horizon})")
    for knob, val in (("decode_horizon", decode_horizon),
                      ("chunk_tokens", chunk_tokens)):
        if val in (None, "auto"):
            continue
        try:
            n = int(val)
        except (TypeError, ValueError):
            raise ValueError(f"{knob} must be an int >= 0, 'auto', or None "
                             f"(got {val!r})") from None
        if n < 0:
            raise ValueError(f"{knob} must be >= 0 (got {val!r}; "
                             "0/None disables the feature)")
    if max_transfer_attempts < 1:
        raise ValueError("max_transfer_attempts must be >= 1 "
                         f"(got {max_transfer_attempts})")
    if max_offline_backlog is not None and max_offline_backlog < 0:
        raise ValueError("max_offline_backlog must be None or >= 0 "
                         f"(got {max_offline_backlog})")
    if max_online_queue is not None and max_online_queue < 1:
        raise ValueError("max_online_queue must be None (unbounded) or >= 1 "
                         f"(got {max_online_queue})")


class PoolRuntime:
    """N-strict + M-relaxed co-located serving over real engines, which run
    on ``device`` (a CUDA card unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg, *, policy: str = "ooco", n_strict: int = 1,
                 n_relaxed: int = 1, clock=None, slo_ttft: float = 4.0,
                 slo_tpot: float = 1.0, num_pages: int = 512,
                 page_size: int = 16, seed: int = 0, backend: str = "auto",
                 hw: HardwareParams | None = None,
                 decode_buckets: tuple[int, ...] = (8,),
                 relaxed_decode_cap: int = 16,
                 gating_horizon: float = 20.0,
                 chunk_tokens: int | str | None = "auto",
                 decode_horizon: int | str | None = 1,
                 max_horizon: int = 16,
                 fault_plan=None, chaos_seed: int = 0,
                 max_transfer_attempts: int = 3,
                 backoff_base: float = 0.05,
                 watchdog_mult: float = 10.0,
                 max_offline_backlog: int | None = None,
                 max_online_queue: int | None = None,
                 prefix_cache: bool = True,
                 model=None, params=None, device="cuda",
                 kernels_from: ServingEngine | None = None):
        _validate_runtime_args(
            policy=policy, n_strict=n_strict, n_relaxed=n_relaxed,
            slo_ttft=slo_ttft, slo_tpot=slo_tpot, num_pages=num_pages,
            page_size=page_size, decode_horizon=decode_horizon,
            max_horizon=max_horizon, chunk_tokens=chunk_tokens,
            max_transfer_attempts=max_transfer_attempts,
            max_offline_backlog=max_offline_backlog,
            max_online_queue=max_online_queue)
        device = require_device(device)
        self.cfg = cfg
        self.policy = policy
        # chunked-prefill token budget: "auto" = roofline-suggested per
        # round (PerfModel.suggest_chunk_tokens), N = fixed budget,
        # 0/None = legacy whole-prompt prefill with layer interruption
        self.chunked = chunk_tokens not in (None, 0, "0")
        self.chunk_budget = (None if chunk_tokens == "auto"
                             else int(chunk_tokens) if self.chunked else 0)
        # multi-step decode horizons: "auto" = roofline-chosen K per round
        # (PerfModel.suggest_decode_horizon under the §3.4.1 preemption
        # bound), N = fixed K, 1/0/None = today's one-sync-per-token decode
        # (which CoLocatedServer pins). Strict rounds and any round with a
        # queued/resident online request always clamp to K=1.
        self.horizon_req = ("auto" if decode_horizon == "auto"
                           else max(int(decode_horizon), 1)
                           if decode_horizon not in (None, 0, "0") else 1)
        self.max_horizon = max_horizon
        self.clock = clock or WallClock()
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        self.pm = PerfModel(cfg, hw or cpu_measured())
        self.rng = random.Random(seed)
        self.seed = seed
        self.relaxed_decode_cap = relaxed_decode_cap
        self.gating_horizon = gating_horizon
        # cross-request KV reuse (radix prefix cache + refcounted COW
        # pages); only effective on the chunked-prefill path — the legacy
        # layer-interruptible path rewrites whole tables and cannot share
        self.prefix_cache = bool(prefix_cache) and self.chunked
        if model is None:
            model = build_model(cfg)
            params = model.init(torch.Generator(device).manual_seed(seed))
        self.model, self.params = model, params
        # engines in (and across) runtimes over the same weights share one
        # set of per-layer parameter views; pass runtime.kernel_donor on
        donor: ServingEngine | None = kernels_from
        self.strict_pool: list[EngineSlot] = []
        self.relaxed_pool: list[EngineSlot] = []
        for i in range(n_strict):
            eng = ServingEngine(model, params, num_pages=num_pages,
                                page_size=page_size, decode_buckets=decode_buckets,
                                backend=backend, prefix_cache=self.prefix_cache,
                                device=device, kernels_from=donor)
            donor = donor or eng
            self.strict_pool.append(EngineSlot(f"strict{i}", "strict", eng))
        for i in range(n_relaxed):
            eng = ServingEngine(model, params, num_pages=num_pages,
                                page_size=page_size, decode_buckets=decode_buckets,
                                backend=backend, prefix_cache=self.prefix_cache,
                                device=device, kernels_from=donor)
            self.relaxed_pool.append(EngineSlot(f"relaxed{i}", "relaxed", eng))
        self.kernel_donor = donor  # share layer views across runtimes
        # queues hold (req, tokens[, home_slot]) — home pins a layer-
        # interrupted prefill to the engine holding its partial state
        self.online_queue: list[tuple[Request, list[int]]] = []
        self.offline_queue: list[tuple[Request, list[int], EngineSlot | None]] = []
        self.finished: list[Request] = []
        self.all_requests: list[Request] = []
        # prefilled offline waiting for strict-pool capacity (baselines);
        # their KV stays on the source relaxed engine until a slot frees
        self.place_queue: list[tuple[Request, EngineSlot]] = []
        self.tokens: dict[int, list[int]] = {}   # rid -> final token stream
        self.metrics = Metrics()
        self.measured_tpot = slo_tpot / 4
        self._op_cap: int | None = None
        self._push_cost = 0.0   # per-round push-migration transfer (overlap)
        # wall-mode live-arrival probe for §3.4.1 (run() wires the trace feed)
        self.incoming_online = lambda: False
        self._next_online_arrival = lambda: None
        # ---- fault tolerance (chaos replay) ----
        plan = FaultPlan.parse(fault_plan)
        self.injector = (FaultInjector(plan, chaos_seed)
                         if plan is not None and plan.events else None)
        self.chaos_seed = chaos_seed
        self.max_transfer_attempts = max_transfer_attempts
        self.backoff_base = backoff_base
        self.watchdog_mult = watchdog_mult
        self.max_offline_backlog = max_offline_backlog
        self.max_online_queue = max_online_queue
        # frontend request log: prompts survive engine crashes, so recovery
        # re-admits from here instead of reading dead-engine memory
        self.prompts: dict[int, list[int]] = {}
        self.shed: list[Request] = []
        self.dead_pool: list[EngineSlot] = []
        self._page_leases: list[tuple[EngineSlot, list[int], float]] = []
        self._admission = "admit"
        # ---- live-serving lifecycle (gateway) ----
        self.by_rid: dict[int, Request] = {}   # every accepted submit, ever
        self.cancelled: list[Request] = []     # terminal: client or deadline
        self.rejected: list[Request] = []      # bounced at submit (terminal)
        self._deadline_watch: list[Request] = []
        self.draining = False   # graceful shutdown: finish residents, no SLA
                                # change — only the `drained` counter

    # ------------------------------------------------------------------
    # submission + one co-located round
    # ------------------------------------------------------------------
    def submit(self, req: Request, tokens: list[int]) -> None:
        """Accept a request into the frontend queues.

        Validates up front — a malformed submit must fail HERE with a clear
        error, not corrupt queue/engine state rounds later: empty prompts
        would underflow the chunk scheduler, a length mismatch would trip an
        engine assert mid-prefill, and a duplicate rid would silently alias
        two requests' KV tables and token buffers. Online submits are
        additionally bounded by ``max_online_queue`` (``AdmissionRejected``
        — backpressure the caller sees synchronously)."""
        if not tokens:
            raise ValueError(f"submit of rid {req.rid}: empty token list "
                             "(prompts must contain >= 1 token)")
        if len(tokens) != req.prompt_len:
            raise ValueError(
                f"submit of rid {req.rid}: prompt_len={req.prompt_len} but "
                f"{len(tokens)} tokens were provided")
        if req.rid in self.by_rid:
            raise ValueError(
                f"submit of duplicate rid {req.rid} "
                f"({self.by_rid[req.rid].phase.value}): rids are unique per "
                "runtime; resubmission would alias KV tables")
        if (req.kind == Kind.ONLINE and self.max_online_queue is not None
                and len(self.online_queue) >= self.max_online_queue):
            self.metrics.rejected_online += 1
            req.phase = Phase.CANCELLED
            req.cancel_reason = "rejected"
            self.rejected.append(req)
            raise AdmissionRejected(
                f"online admission queue full "
                f"({len(self.online_queue)}/{self.max_online_queue}); "
                "retry later or shed load upstream")
        self.by_rid[req.rid] = req
        self.all_requests.append(req)
        self.prompts[req.rid] = list(tokens)
        if req.ttft_deadline is not None or req.total_deadline is not None:
            self._deadline_watch.append(req)
        if req.kind == Kind.ONLINE:
            self.online_queue.append((req, tokens))
        else:
            self.offline_queue.append((req, tokens, None))

    def step(self) -> bool:
        """One scheduling round across every pool. Returns True if any
        engine did work; virtual mode advances the clock by the modeled
        round duration (max across engines — pools run in parallel)."""
        now = self.clock.now()
        self._enforce_deadlines(now)
        self._apply_faults(now)
        self._admission = self._admission_state()
        if self._admission != "admit":
            self.metrics.degraded_rounds += 1
            if self._admission == "shed":
                self._shed_offline()
        self._retry_placements()
        costs = [self._relaxed_round(slot, now) for slot in self.relaxed_pool]
        costs += [self._strict_round(slot, now) for slot in self.strict_pool]
        self.metrics.rounds += 1
        cost = max(costs, default=0.0)  # pools can crash away entirely
        if cost > 0:
            self.clock.advance(cost)
            return True
        return False

    # ------------------------------------------------------------------
    # live request lifecycle: cancel, deadlines, streaming, health, drain
    # ------------------------------------------------------------------
    def cancel(self, rid: int, *, reason: str = "client") -> Request:
        """Abort a request at ANY lifecycle stage — queued, mid-chunked-
        prefill, mid-decode, parked mid-migration — releasing every KV page
        and refcount it held on every engine. Terminal and final: a
        cancelled request is never re-admitted and bills no recompute waste
        (nothing will re-run). Raises ``ValueError`` for unknown rids and
        for requests already in a terminal state, so double-cancels and
        cancel-after-finish are caller bugs, not silent no-ops."""
        req = self.by_rid.get(rid)
        if req is None:
            raise ValueError(f"cancel of unknown rid {rid}: never submitted "
                             "to this runtime (or rejected at admission)")
        if req.phase is Phase.FINISHED:
            raise ValueError(f"cancel of rid {rid}: already finished")
        if req.phase is Phase.CANCELLED:
            raise ValueError(f"cancel of rid {rid}: already cancelled "
                             f"({req.cancel_reason})")
        self._purge(req)
        req.phase = Phase.CANCELLED
        req.cancel_reason = reason
        req.finish_time = self.clock.now()
        self.cancelled.append(req)
        if reason == "deadline":
            self.metrics.deadline_aborts += 1
        else:
            self.metrics.cancelled += 1
        return req

    def _purge(self, req: Request) -> None:
        """Remove every trace of a live request from the cluster: frontend
        queues, slot resident lists, pinned prefills, parked placements,
        and per-engine state/pages (``ServingEngine.release`` is idempotent
        and stage-agnostic, so sweeping every slot is safe)."""
        rid = req.rid
        self.online_queue[:] = [e for e in self.online_queue
                                if e[0].rid != rid]
        self.offline_queue[:] = [e for e in self.offline_queue
                                 if e[0].rid != rid]
        self.place_queue[:] = [e for e in self.place_queue
                               if e[0].rid != rid]
        self._deadline_watch[:] = [r for r in self._deadline_watch
                                   if r.rid != rid]
        for slot in self.strict_pool + self.relaxed_pool:
            slot.prefilling[:] = [e for e in slot.prefilling
                                  if e[0].rid != rid]
            slot.online[:] = [r for r in slot.online if r.rid != rid]
            slot.offline[:] = [r for r in slot.offline if r.rid != rid]
            slot.engine.release(rid)
        self.prompts.pop(rid, None)   # cancelled work is never recovered

    def _enforce_deadlines(self, now: float) -> None:
        """Abort watched requests whose TTFT/total deadline has passed
        (``core.scheduling.deadline_state``). Runs at the top of every
        round, BEFORE admission/prefill — a blown request must not steal
        another FLOP from requests that can still meet their SLOs. Aborts
        count in ``deadline_aborts`` and are billed as SLO violations in
        ``summary()``, never as attainment."""
        if not self._deadline_watch:
            return
        for req in list(self._deadline_watch):
            if req.phase in (Phase.FINISHED, Phase.CANCELLED) or req.done:
                self._deadline_watch.remove(req)
                continue
            if sch.deadline_state(req, now) != "ok":
                self.cancel(req.rid, reason="deadline")  # unwatches via purge

    def generated_tokens(self, rid: int) -> list[int]:
        """Output tokens produced so far for ``rid`` — the gateway's
        streaming poll. Reads the resident engine's token ring (finished
        requests read the frontend copy), clamped to ``req.generated`` so
        eviction/crash recovery is invisible to the stream: greedy replay
        regenerates bit-identical tokens, and until progress catches back
        up to the client's emit offset the poll simply returns a prefix it
        has already seen. Empty for unknown/rejected rids."""
        req = self.by_rid.get(rid)
        if req is None:
            return []
        final = self.tokens.get(rid)
        if final is not None:
            return final[req.prompt_len:]
        if req.generated <= 0:
            return []
        for slot in self.strict_pool + self.relaxed_pool:
            buf = slot.engine.token_buf.get(rid)
            if buf is not None:
                return buf[req.prompt_len: req.prompt_len + req.generated]
        return []

    def health(self) -> dict:
        """Cluster health probe for the gateway's ``/healthz``: per-slot
        liveness and page occupancy plus the crash/watchdog counters.
        ``status`` is ``"ok"`` (full topology), ``"degraded"`` (crashed
        engines or a promoted/emptied pool — still serving), or ``"dead"``
        (no live engine; nothing can be served)."""
        slots = []
        for s in self.strict_pool + self.relaxed_pool + self.dead_pool:
            eng = s.engine
            slots.append({
                "name": s.name,
                "role": s.role,
                "alive": eng.alive,
                "resident": s.resident,
                "prefilling": len(s.prefilling),
                "free_pages": eng.cache.allocator.free_pages if eng.alive else 0,
                "live_pages": eng.cache.allocator.live_pages if eng.alive else 0,
            })
        n_live = len(self.strict_pool) + len(self.relaxed_pool)
        if n_live == 0:
            status = "dead"
        elif (self.dead_pool or not self.strict_pool
              or not self.relaxed_pool):
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "draining": self.draining,
            "engines": slots,
            "queued_online": len(self.online_queue),
            "queued_offline": len(self.offline_queue),
            "engine_crashes": self.metrics.engine_crashes,
            "watchdog_aborts": self.metrics.watchdog_aborts,
            "promotions": self.metrics.promotions,
            "degraded_rounds": self.metrics.degraded_rounds,
        }

    def live_pages(self) -> dict[str, int]:
        """Allocator-held pages per live engine — the drain-time leak
        probe: after a graceful drain releases residents, leases, and the
        prefix trees, every count here must be zero."""
        return {s.name: s.engine.cache.allocator.live_pages
                for s in self.strict_pool + self.relaxed_pool}

    def release_retained(self) -> int:
        """Final step of a graceful drain: return pages that are held on
        purpose rather than by an in-flight request — outstanding fault-
        injection page leases and the radix prefix trees' own references
        (``release_all``: a decref per node, unlike the crash path's
        ``clear``). Returns the number of page references released; after
        this, any nonzero ``live_pages()`` entry is a genuine leak."""
        released = 0
        for lease in list(self._page_leases):
            slot, pages, _ = lease
            self._page_leases.remove(lease)
            if slot.engine.alive:
                slot.engine.cache.allocator.free(pages)
                released += len(pages)
        for s in self.strict_pool + self.relaxed_pool:
            if s.engine.cache.prefix is not None:
                released += s.engine.cache.prefix.release_all()
        return released

    # ------------------------------------------------------------------
    # fault injection + recovery (chaos replay)
    # ------------------------------------------------------------------
    def _slot_named(self, name: str) -> EngineSlot | None:
        for s in self.strict_pool + self.relaxed_pool:
            if s.name == name:
                return s
        return None

    def _apply_faults(self, now: float) -> None:
        """Round-boundary fault dispatch: crash engines, leak (and later
        restore) pool pages. Every decision comes from the seeded plan, so
        a chaos replay is exactly as deterministic as a clean one."""
        for lease in list(self._page_leases):
            slot, pages, until = lease
            if now >= until:
                self._page_leases.remove(lease)
                if slot.engine.alive:
                    slot.engine.cache.allocator.free(pages)
        if self.injector is None:
            return
        for name in self.injector.crashes_due(now):
            slot = self._slot_named(name)
            if slot is not None:
                self._crash_engine(slot)
        for ev in self.injector.leaks_due(now):
            slot = self._slot_named(ev.engine)
            if slot is None:
                continue
            alloc = slot.engine.cache.allocator
            pages = alloc.alloc(min(ev.pages, alloc.free_pages))
            if ev.duration > 0:
                self._page_leases.append((slot, pages, now + ev.duration))

    def _crash_engine(self, slot: EngineSlot) -> None:
        """Engine-process crash: device KV and host bookkeeping are gone.
        Every in-flight request is re-admitted from the frontend prompt log
        through the recompute path — greedy streams regenerate bit-identical
        tokens, so recovery preserves token parity. A crashed strict engine
        additionally promotes a drained relaxed engine so online traffic
        never loses its pool."""
        lost: dict[int, Request] = {}
        for r in slot.online + slot.offline:
            if not r.done:
                lost[r.rid] = r
        for entry in slot.prefilling:
            if not entry[0].done:
                lost[entry[0].rid] = entry[0]
        for entry in list(self.place_queue):
            if entry[1] is slot:
                self.place_queue.remove(entry)
                if not entry[0].done:
                    lost[entry[0].rid] = entry[0]
        for entry in list(self.offline_queue):
            if entry[2] is slot:       # home-pinned resume: state is gone
                self.offline_queue.remove(entry)
                if not entry[0].done:
                    lost[entry[0].rid] = entry[0]
        slot.engine.crash()
        slot.online.clear()
        slot.offline.clear()
        slot.prefilling.clear()
        pool = self.strict_pool if slot.role == "strict" else self.relaxed_pool
        pool.remove(slot)
        self.dead_pool.append(slot)
        self.metrics.engine_crashes += 1
        if slot.role == "strict":
            self._promote_relaxed()
        for r in sorted(lost.values(), key=lambda r: (r.arrival, r.rid)):
            self._readmit(r)
            self.metrics.recoveries += 1

    def _readmit(self, req: Request) -> None:
        """Requeue a request whose engine-side state is gone (crash, or
        exhausted migration retries): reset progress, charge the recompute
        waste, keep SLO-relevant timestamps. Greedy decoding is batch- and
        chunk-independent (the invariant the eviction path already relies
        on), so the regenerated stream is bit-identical to the lost one."""
        # prefix-cache claims were page-table updates, not compute — losing
        # them wastes nothing, so they never count as recompute
        if req.generated > 0:
            req.recompute_tokens += req.context_len - req.cached_tokens
        elif req.prefill_tokens_done > 0:
            req.recompute_tokens += (req.prefill_tokens_done
                                     - req.cached_tokens)
        elif req.prefill_layers_done > 0:
            req.recompute_tokens += req.prompt_len
        req.generated = 0
        req.prefill_layers_done = 0
        req.prefill_tokens_done = 0
        req.cached_tokens = 0
        req.phase = Phase.QUEUED
        toks = self.prompts[req.rid]
        if req.kind == Kind.ONLINE:
            self.online_queue.append((req, toks))
            self.online_queue.sort(key=lambda e: (e[0].arrival, e[0].rid))
        else:
            self.offline_queue.append((req, toks, None))

    def _promote_relaxed(self) -> None:
        """Strict failover: flip the most-drained relaxed engine to the
        strict role. Its decoding residents and landed KV move with it;
        in-flight prefills are aborted back to the queues (recompute),
        because strict rounds only run the prefill path once the relaxed
        pool is empty."""
        if not self.relaxed_pool:
            return
        slot = min(self.relaxed_pool,
                   key=lambda s: (sum(s.engine.cache.lengths.values()),
                                  s.name))
        self.relaxed_pool.remove(slot)
        for entry in list(slot.prefilling):
            self._abort_chunk_prefill(slot, entry)
        for idx, entry in enumerate(self.offline_queue):
            req, toks, home = entry
            if home is slot:           # layer-partial resume: unpin it
                slot.engine.abort_prefill(req.rid)
                slot.engine.requests.pop(req.rid, None)
                slot.engine.token_buf.pop(req.rid, None)
                self.offline_queue[idx] = (req, toks, None)
        slot.role = "strict"
        self.strict_pool.append(slot)
        self.metrics.promotions += 1

    def _admission_state(self) -> str:
        """Per-round graceful-degradation decision (``core.scheduling``):
        under overload, fresh offline admission stops first ("defer");
        only with ``max_offline_backlog`` configured is excess offline
        queue shed. Online work is never deferred or shed."""
        pools = self.relaxed_pool or self.strict_pool
        free = min((s.engine.cache.available_pages
                    / s.engine.cache.num_pages for s in pools), default=0.0)
        return sch.admission_decision(
            queued_online=len(self.online_queue),
            strict_pressure=max((s.pressure for s in self.strict_pool),
                                default=0.0),
            offline_backlog=len(self.offline_queue),
            free_page_frac=free,
            max_backlog=self.max_offline_backlog)

    def _shed_offline(self) -> None:
        """Shed the newest fresh offline entries beyond the bounded
        backlog. Sheds are surfaced (``summary()['shed_requests']``,
        ``self.shed``) — never silent."""
        excess = len(self.offline_queue) - (self.max_offline_backlog or 0)
        for i in range(len(self.offline_queue) - 1, -1, -1):
            if excess <= 0:
                break
            if self.offline_queue[i][2] is not None:
                continue               # pinned resumes hold pages; keep them
            req, _, _ = self.offline_queue.pop(i)
            self.shed.append(req)
            self.metrics.shed_requests += 1
            excess -= 1

    # ------------------------------------------------------------------
    # relaxed pool: prefill (layer-interruptible) + offline decode
    # ------------------------------------------------------------------
    def _relaxed_round(self, slot: EngineSlot, now: float) -> float:
        self._push_cost = 0.0
        if self.chunked:
            # fused mixed round: the §3.4.1 boundary is the chunk, chosen
            # here — deterministic under both clocks, no mid-layer polling
            pf = self._pick_chunk_prefill(slot)
            cost = self._decode_slot(slot, now, relaxed=True, prefill=pf)
        else:
            cost = self._prefill_one(slot, now)
            if slot.online or (self.policy == "ooco" and slot.offline):
                cost += self._decode_slot(slot, now + cost, relaxed=True)
        # push-migration KV transfers ride the interconnect while this
        # round's compute occupies the chips, so the round is charged
        # max(compute, transfer), not the sum — the same overlap the
        # §3.4.3 pull path models (deterministic: both terms are modeled)
        return max(cost, self._push_cost)

    # ------------------------------------------------------------------
    # chunk-granular prefill selection (token-budget scheduling)
    # ------------------------------------------------------------------
    def _pick_chunk_prefill(self, slot: EngineSlot):
        """Choose the prefill request this slot advances this round. §3.4.1
        fast preemption happens HERE, at a deterministic chunk boundary
        under both clocks: under ``ooco`` a queued online request pauses an
        in-progress offline prefill (the offline keeps its landed KV and
        resumes later without re-running any layer); ``online_priority``
        starts online work first but never pauses in-flight prefills
        (legacy semantics: preemption is an ooco mechanism); ``base_pd``
        keeps strict FIFO — its head-of-line blocking is the point of the
        baseline. Returns ``(req, toks)`` or None."""
        prog = slot.prefilling
        prog[:] = [e for e in prog if not e[0].done
                   and e[0].rid in slot.engine.requests]
        if self.policy == "base_pd":
            return prog[0] if prog else self._admit_prefill_fifo(slot)
        cur_online = next((e for e in prog if e[0].kind == Kind.ONLINE), None)
        if cur_online is not None:
            return cur_online
        if self.policy == "ooco" and self.online_queue:
            entry = self._admit_online_prefill(slot)
            if entry is not None:
                if prog:
                    self.metrics.chunk_preemptions += 1
                prog.insert(0, entry)
                return entry
        if prog:
            return prog[0]
        if self.online_queue:
            entry = self._admit_online_prefill(slot)
            if entry is not None:
                prog.append(entry)
                return entry
        entry = self._next_offline_for(slot)
        if entry is not None:
            req, toks, home = entry
            if home is None:
                slot.engine.add_request(req, toks)
                slot.engine.claim_prefix(req.rid)
            prog.append((req, toks))
            return (req, toks)
        return None

    def _admit_online_prefill(self, slot: EngineSlot):
        """Pop + admit the online queue head (evicting offline residents for
        space, as in the legacy path). None if it cannot fit."""
        eng = slot.engine
        req, toks = self.online_queue[0]
        if not eng.cache.can_fit(len(toks)):
            need = (eng.cache.pages_for(len(toks))
                    - eng.cache.available_pages) * eng.cache.page_size
            self._evict_from(slot, need)
        if not eng.cache.can_fit(len(toks)):
            return None
        self.online_queue.pop(0)
        eng.add_request(req, toks)
        eng.claim_prefix(req.rid)
        return (req, toks)

    def _admit_prefill_fifo(self, slot: EngineSlot):
        """base_pd admission: plain FIFO over both queues by arrival."""
        if (self.offline_queue
                and (not self.online_queue
                     or self.offline_queue[0][0].arrival
                     < self.online_queue[0][0].arrival)):
            entry = self._next_offline_for(slot)
            if entry is not None:
                req, toks, home = entry
                if home is None:
                    slot.engine.add_request(req, toks)
                    slot.engine.claim_prefix(req.rid)
                slot.prefilling.append((req, toks))
                return (req, toks)
        if self.online_queue:
            entry = self._admit_online_prefill(slot)
            if entry is not None:
                slot.prefilling.append(entry)
                return entry
        return None

    def _plan_round(self, slot: EngineSlot, relaxed: bool,
                    pf_req: Request | None) -> sch.MixedPlan:
        """Token-budget plan for one round (decode batch + prefill chunk).
        ooco routes decode through §3.4.4 mix-decoding inside the
        scheduler; the baselines keep their legacy decode selection and the
        budget only sizes the chunk."""
        remaining = (pf_req.prompt_len - pf_req.prefill_tokens_done
                     if pf_req is not None else 0)
        horizon = self._horizon_allowance(relaxed)
        if self.policy == "ooco":
            slo = (None if relaxed
                   else self._effective_slo(slot.online, slot.offline))
            return sch.token_budget_schedule(
                slot.online, slot.offline, pf_req, remaining, self.pm,
                slo=slo, budget_tokens=self.chunk_budget or None,
                relaxed_cap=self.relaxed_decode_cap,
                mem_budget_bytes=None if relaxed else self._pool_kv_bytes(slot),
                rng=self.rng, horizon=horizon)
        decode = self._select_batch(slot, relaxed)
        return sch.token_budget_schedule(
            slot.online, slot.offline, pf_req, remaining, self.pm,
            slo=None, budget_tokens=self.chunk_budget or None,
            relaxed_cap=self.relaxed_decode_cap, decode_override=decode,
            horizon=horizon)

    def _horizon_allowance(self, relaxed: bool) -> int:
        """Upper bound on this round's decode horizon before the per-round
        §3.4.1 clamp (``sch.decode_horizon_steps``) refines it."""
        if not relaxed or self.horizon_req == 1:
            return 1
        return (self.max_horizon if self.horizon_req == "auto"
                else min(self.horizon_req, self.max_horizon))

    def _choose_horizon(self, slot: EngineSlot, batch: list[Request],
                        allowance: int) -> int:
        """Per-round K: the §3.4.1-aware clamp (queued/resident online work
        forces K=1), the roofline choice for "auto", then the engine's page
        claim-ahead capacity."""
        if allowance <= 1 or not batch:
            return 1
        k = sch.decode_horizon_steps(
            batch, self.pm, requested=self.horizon_req,
            queued_online=bool(self.online_queue) or bool(self.incoming_online()),
            preempt_latency=0.25 * self.slo_ttft,
            max_horizon=allowance)
        if k > 1:
            k = slot.engine.max_horizon_for([r.rid for r in batch], k)
        return k

    def _choose_mixed_horizon(self, slot: EngineSlot, batch: list[Request],
                              pf_req: Request, chunk: int,
                              allowance: int) -> int:
        """Per-round K for a fused mixed round (chunk + decode in one
        scan). Online work anywhere in the dispatch forces K=1 — the
        §3.4.1 preemption boundary must stay a chunk boundary when latency
        is critical. Otherwise the roofline choice under the preemption
        bound (halved when online arrivals are already queued, so K
        shrinks rather than pinning — the chunk has to land either way),
        then the engine's combined chunk + decode page claim-ahead."""
        if allowance <= 1 or not batch:
            return 1   # splitting a chunk with no decode riding is waste
        if pf_req.kind is Kind.ONLINE or any(r.kind is Kind.ONLINE
                                             for r in batch):
            return 1
        queued = bool(self.online_queue) or bool(self.incoming_online())
        if self.horizon_req == "auto":
            k = self.pm.suggest_mixed_horizon(
                chunk, pf_req.prefill_tokens_done + chunk,
                [r.context_len for r in batch],
                preempt_latency=0.25 * self.slo_ttft,
                queued_online=queued, max_horizon=allowance)
        else:
            k = allowance
        k = min(k, chunk)
        if k > 1:
            k = slot.engine.max_mixed_horizon_for(
                [r.rid for r in batch], pf_req.rid, chunk, k)
        return max(k, 1)

    def _after_chunk(self, slot: EngineSlot, req: Request, now: float,
                     step_lat: float) -> float:
        """Post-chunk bookkeeping; returns any extra cost (placement)."""
        self.metrics.chunks += 1
        if req.prefill_tokens_done < req.prompt_len:
            return 0.0                       # mid-prefill: stays pinned
        slot.prefilling[:] = [e for e in slot.prefilling if e[0] is not req]
        if req.first_token_time is None:
            req.first_token_time = now + step_lat
        eng = slot.engine
        if req.done:
            eng.cache.free(req.rid)
            self._finish(req, eng, now + step_lat)
            return 0.0
        if self.policy == "ooco" and req.kind != Kind.ONLINE:
            slot.offline.append(req)         # decode on relaxed until pulled
            return 0.0
        # push transfer overlaps the source round's compute (charged as
        # max at the round level, not summed here)
        self._push_cost += self._place_on_strict(req, slot)
        return 0.0

    def _prefill_cost(self, est_latency: float, layers_run: int,
                      measured: float) -> float:
        if not self.clock.virtual:
            return measured
        return est_latency * layers_run / max(self.cfg.num_layers, 1)

    def _prefill_one(self, slot: EngineSlot, now: float) -> float:
        eng = slot.engine
        if (self.policy == "base_pd" and self.offline_queue
                and (not self.online_queue
                     or self.offline_queue[0][0].arrival
                     < self.online_queue[0][0].arrival)):
            # base_pd has no online/offline distinction at prefill: plain
            # FIFO, so offline prefills head-of-line block online TTFT
            return self._prefill_offline(slot, now)
        if self.online_queue:
            req, toks = self.online_queue.pop(0)
            if not eng.cache.can_fit(len(toks)):
                need = (eng.cache.pages_for(len(toks))
                        - eng.cache.available_pages) * eng.cache.page_size
                self._evict_from(slot, need)
            if not eng.cache.can_fit(len(toks)):
                self.online_queue.insert(0, (req, toks))
                return 0.0
            eng.add_request(req, toks)
            est = self.pm.prefill_estimate([len(toks)]).latency
            t0 = time.perf_counter()
            eng.prefill(req.rid)
            cost = self._prefill_cost(est, self.cfg.num_layers,
                                      time.perf_counter() - t0)
            self.metrics.prefill_modeled_seconds += cost
            if req.first_token_time is None:
                req.first_token_time = now + cost
            if req.done:
                eng.cache.free(req.rid)
                self._finish(req, eng, now + cost)
                return cost
            self._push_cost += self._place_on_strict(req, slot)
            return cost
        return self._prefill_offline(slot, now)

    def _prefill_offline(self, slot: EngineSlot, now: float) -> float:
        eng = slot.engine
        entry = self._next_offline_for(slot)
        if entry is None:
            return 0.0
        req, toks, home = entry
        if home is None:
            eng.add_request(req, toks)
        est = self.pm.prefill_estimate([len(toks)]).latency
        preempt = self._preempt_probe(slot, now, est) \
            if self.policy == "ooco" else None
        layers_before = req.prefill_layers_done
        t0 = time.perf_counter()
        status = eng.prefill(req.rid, should_preempt=preempt)
        cost = self._prefill_cost(est, req.prefill_layers_done - layers_before,
                                  time.perf_counter() - t0)
        self.metrics.prefill_modeled_seconds += cost
        if status == "preempted":
            req.phase = Phase.QUEUED
            self.offline_queue.insert(0, (req, toks, slot))
            return cost
        if req.first_token_time is None:
            req.first_token_time = now + cost
        if req.done:
            eng.cache.free(req.rid)
            self._finish(req, eng, now + cost)
            return cost
        if self.policy == "ooco":
            slot.offline.append(req)     # decode on relaxed until pulled
        else:
            self._push_cost += self._place_on_strict(req, slot)
        return cost

    def _next_offline_for(self, slot: EngineSlot):
        """First admissible offline queue entry for this engine: resumes are
        pinned to the engine holding the partial state; fresh prefills must
        fit and (ooco) pass the §3.4.2 gating cost model. Bounded FIFO scan."""
        eng = slot.engine
        scanned = 0
        for entry in list(self.offline_queue):
            req, toks, home = entry
            if home is not None and home is not slot:
                continue
            if home is None and self._admission != "admit":
                # degraded round: fresh offline work stays queued; pinned
                # resumes keep going (finishing them frees pages)
                continue
            scanned += 1
            if scanned > 4:
                break
            if home is None:
                if not eng.cache.can_fit(len(toks)):
                    continue
                if self.policy == "ooco" and req.prefill_layers_done == 0:
                    budget = self._free_kv_bytes(slot)
                    cached = 0
                    if (eng.cache.prefix is not None
                            and req.prefill_tokens_done == 0):
                        # planning peek, not a claim: how much of this
                        # prompt the prefix cache would serve (touch=False
                        # keeps the LRU order unperturbed by rejections)
                        _, cached = eng.cache.prefix.match(
                            toks, limit=len(toks) - 1, touch=False)
                    ok = sch.gating_decision(
                        req, slot.offline, self.pm,
                        evict_probability=self._evict_probability(),
                        horizon_seconds=self.gating_horizon,
                        mem_budget_bytes=budget,
                        cached_tokens=cached)
                    if not ok:
                        continue
            self.offline_queue.remove(entry)
            return entry
        return None

    def _preempt_probe(self, slot: EngineSlot, now: float, est_latency: float):
        """§3.4.1 layer-level interruption predicate. Wall mode polls the
        live queue/arrival feed; virtual mode interrupts at the first layer
        boundary past the next online arrival's timestamp (deterministic)."""
        if not self.clock.virtual:
            return lambda: bool(self.online_queue) or self.incoming_online()
        layer_dt = est_latency / max(self.cfg.num_layers, 1)
        nxt = self._next_online_arrival()
        polls = [0]

        def probe() -> bool:
            polls[0] += 1
            if self.online_queue:
                return True
            boundary = now + polls[0] * layer_dt
            return nxt is not None and nxt <= boundary

        return probe

    # ------------------------------------------------------------------
    # placement, migration, eviction (bottleneck-guided, §3.4.1/§3.4.3)
    # ------------------------------------------------------------------
    def _free_kv_bytes(self, slot: EngineSlot) -> float:
        cache = slot.engine.cache
        return (cache.available_pages * cache.page_size
                * max(self.pm.kv_bytes_per_token(), 1.0))

    def _pool_kv_bytes(self, slot: EngineSlot) -> float:
        cache = slot.engine.cache
        return (cache.num_pages * cache.page_size
                * max(self.pm.kv_bytes_per_token(), 1.0))

    def _place_on_strict(self, req: Request, src: EngineSlot) -> float:
        """Push a prefilled request to the strict pool (most free KV pages
        wins), evicting offline victims on the destination if needed. If no
        strict engine can hold it even after eviction — or the source IS a
        strict engine (degraded mode after failover) — it decodes in place
        on the source engine (never dropped)."""
        if not self.strict_pool or src in self.strict_pool:
            (src.online if req.kind == Kind.ONLINE
             else src.offline).append(req)
            return 0.0
        n = src.engine.cache.lengths[req.rid]
        dst = max(self.strict_pool,
                  key=lambda s: s.engine.cache.available_pages)
        if not dst.engine.cache.can_fit(n) and req.kind == Kind.ONLINE:
            # only online work may evict offline victims to claim space
            need = (dst.engine.cache.pages_for(n)
                    - dst.engine.cache.available_pages) \
                * dst.engine.cache.page_size
            self._evict_from(dst, need)
        if not dst.engine.cache.can_fit(n):
            if req.kind == Kind.ONLINE:
                src.online.append(req)   # decode in place, never dropped
            else:
                self.place_queue.append((req, src))
            return 0.0
        return self._migrate(req, src, dst)

    def _retry_placements(self) -> None:
        """Drain parked offline placements as strict capacity frees up."""
        if not self.strict_pool:
            return
        for entry in list(self.place_queue):
            req, src = entry
            if req.done:
                self.place_queue.remove(entry)
                continue
            dst = max(self.strict_pool,
                      key=lambda s: s.engine.cache.available_pages)
            if dst.engine.cache.can_fit(src.engine.cache.lengths[req.rid]):
                self.place_queue.remove(entry)
                self._migrate(req, src, dst)

    def _migrate(self, req: Request, src: EngineSlot, dst: EngineSlot) -> float:
        """Real KV movement between engines (RDMA->ICI analogue), retry-
        safe: the payload is exported with an integrity checksum while the
        source keeps its pages; each attempt may be failed or corrupted by
        the fault injector; failures retry with seeded exponential backoff
        charged to the virtual clock; and when the attempt budget is
        exhausted the request falls back to the recompute path (re-admitted
        from the prompt log) instead of being lost mid-transfer."""
        eng = src.engine
        k, v, n, checksum = eng.export_for_transfer(req.rid)
        per_attempt = (self.pm.migration_seconds(req.context_len)
                       if self.clock.virtual else 0.0)
        cost = 0.0
        for attempt in range(1, self.max_transfer_attempts + 1):
            outcome = ("ok" if self.injector is None
                       else self.injector.transfer_outcome(self.clock.now()))
            cost += per_attempt
            if outcome == "ok":
                dst.engine.migrate_in(
                    req.rid, req, eng.token_buf[req.rid], k, v, n,
                    sampling=eng.req_sampling.pop(req.rid, None),
                    checksum=checksum)
                eng.commit_transfer_out(req.rid)
                (dst.online if req.kind == Kind.ONLINE
                 else dst.offline).append(req)
                self.metrics.migrations += 1
                return cost
            if outcome == "corrupt":
                # payload arrives bit-flipped: the destination checksum
                # rejects it before any state lands, so the intact source
                # copy simply re-sends
                bad = k.clone()
                bad.view(-1)[0] = bad.view(-1)[0].abs() + 1.0
                try:
                    dst.engine.migrate_in(
                        req.rid, req, eng.token_buf[req.rid], bad, v, n,
                        sampling=eng.req_sampling.get(req.rid),
                        checksum=checksum)
                    raise AssertionError("corrupt transfer went undetected")
                except TransferIntegrityError:
                    pass
            self.metrics.migration_retries += 1
            if attempt < self.max_transfer_attempts:
                delay = self.injector.backoff_seconds(
                    attempt, self.backoff_base)
                if self.clock.virtual:
                    cost += delay
        # attempt budget exhausted: recompute fallback — release the source
        # copy and re-admit from the frontend prompt log (greedy replay
        # regenerates the same tokens; waste lands in recompute_tokens)
        eng.cache.free(req.rid)
        eng.requests.pop(req.rid, None)
        eng.token_buf.pop(req.rid, None)
        eng.req_sampling.pop(req.rid, None)
        self.metrics.migration_recomputes += 1
        self._readmit(req)
        return cost

    def _evict_from(self, slot: EngineSlot, need_tokens: float,
                    exclude: set[int] | None = None) -> None:
        """§3.4.1 bottleneck-aware victim selection on a real engine: free
        >= need_tokens of KV by evicting offline decodes (recompute later)."""
        if need_tokens <= 0:
            return
        exclude = exclude or set()
        candidates = [r for r in slot.offline if r.rid not in exclude]
        # refcount-aware ranking: a victim frees only its UNSHARED pages
        # (prefix-cache siblings keep theirs), so prefer unshared requests
        # and never pick one that would free nothing
        shared = {r.rid: slot.engine.cache.shared_tokens(r.rid)
                  for r in candidates} if self.prefix_cache else None
        victims = sch.select_eviction_victims(
            candidates, int(np.ceil(need_tokens)), slot.last_bottleneck,
            shared_tokens=shared)
        eng = slot.engine
        for r in victims:
            slot.offline.remove(r)
            toks = eng.token_buf[r.rid][: r.prompt_len]
            eng.evict(r.rid)       # frees pages, counts recompute_tokens
            eng.requests.pop(r.rid, None)
            eng.token_buf.pop(r.rid, None)
            # recompute from scratch: greedy replay regenerates the same
            # tokens; the waste is tracked in recompute_tokens
            r.generated = 0
            r.prefill_layers_done = 0
            r.prefill_tokens_done = 0
            r.cached_tokens = 0    # re-claimed (if still cached) on re-admit
            self.offline_queue.append((r, toks, None))
            self.metrics.evictions += 1

    def _evict_probability(self) -> float:
        if not self.strict_pool:
            return 0.0
        return 0.5 * sum(s.pressure for s in self.strict_pool) / len(self.strict_pool)

    # ------------------------------------------------------------------
    # decode rounds
    # ------------------------------------------------------------------
    def _strict_round(self, slot: EngineSlot, now: float) -> float:
        self._push_cost = 0.0
        pf = None
        pre = 0.0
        if not self.relaxed_pool:
            # total relaxed-pool loss (crashes/promotions): strict engines
            # take over prefill so the cluster degrades instead of wedging
            if self.chunked:
                pf = self._pick_chunk_prefill(slot)
            else:
                pre = self._prefill_one(slot, now)
        cost, batch = self._decode_slot(slot, now + pre, relaxed=False,
                                        want_batch=True, prefill=pf)
        cost += pre
        if self.policy == "ooco" and batch:
            pull = self._pull_migration(slot, batch)
            # the pull's KV transfer rides the interconnect while the next
            # round's compute occupies the chips, so the round is charged
            # max(compute, transfer), not the sum (same overlap the
            # simulator models; deterministic — both terms are modeled)
            cost = max(cost, pull)
        return max(cost, self._push_cost)

    def _effective_slo(self, online, offline) -> float:
        """ooco mix-decoding SLO bound. Virtual mode: the perf model IS the
        clock, use the SLO directly. Wall mode: scale by the observed /
        predicted latency ratio (measured-latency calibration)."""
        if self.clock.virtual:
            return self.slo_tpot
        sample = [r.context_len for r in (list(online) + list(offline)[:1])] or [8]
        pred = self.pm.decode_estimate(sample).latency or 1e-6
        scale = self.measured_tpot / pred
        return self.slo_tpot / max(scale, 1e-6)

    def _online_priority_cap(self) -> int:
        """Static decode-batch cap calibrated once at a conservative long
        context (HyGen/Echo-style heuristic baseline, paper §5.1.4)."""
        if self._op_cap is None:
            p95 = 1024
            lo, hi = 1, 4096
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if self.pm.decode_estimate([p95] * mid).latency <= self.slo_tpot:
                    lo = mid
                else:
                    hi = mid - 1
            self._op_cap = lo
        return self._op_cap

    def _select_batch(self, slot: EngineSlot, relaxed: bool) -> list[Request]:
        online, offline = slot.online, slot.offline
        if relaxed:
            return online + offline[: self.relaxed_decode_cap]
        if self.policy == "base_pd":
            return online + offline
        if self.policy == "online_priority":
            cap = self._online_priority_cap()
            rest = sorted(offline, key=lambda r: r.context_len)
            return (online + rest)[: max(cap, len(online))]
        return sch.mix_decoding_selection(
            online, offline, self._effective_slo(online, offline), self.pm,
            rng=self.rng, mem_budget_bytes=self._pool_kv_bytes(slot))

    def _fit_batch(self, slot: EngineSlot, batch: list[Request]) -> list[Request]:
        """Page-budget admission for this decode step: online rows may evict
        offline residents to grow their tables; offline rows that do not fit
        just sit out the round (no OutOfPagesError on the hot path)."""
        cache = slot.engine.cache
        out: list[Request] = []
        need = 0
        for r in batch:
            if r.rid not in slot.engine.requests:
                continue   # evicted mid-fit by an earlier online row
            inc = cache.pages_for(r.context_len) - len(cache.tables.get(r.rid, []))
            free = cache.available_pages
            if need + inc <= free:
                out.append(r)
                need += inc
                continue
            if r.kind == Kind.ONLINE:
                shortfall = (need + inc - free) * cache.page_size
                self._evict_from(slot, shortfall,
                                 exclude={x.rid for x in out} | {r.rid})
                if need + inc <= cache.available_pages:
                    out.append(r)
                    need += inc
        if not out and batch:
            # full pool with nothing admissible: vLLM-style recompute
            # preemption — evict other offline residents to unblock the
            # head request, so a fully-offline engine never deadlocks
            r = batch[0]
            inc = cache.pages_for(r.context_len) - len(cache.tables.get(r.rid, []))
            self._evict_from(
                slot, (inc - cache.available_pages) * cache.page_size,
                exclude={r.rid})
            if r.rid in slot.engine.requests and inc <= cache.available_pages:
                out = [r]
        return out

    def _decode_slot(self, slot: EngineSlot, now: float, *, relaxed: bool,
                     want_batch: bool = False, prefill=None):
        """One engine round: decode batch + (chunked mode) a fused prefill
        chunk in the same dispatch. ``prefill`` is the ``(req, toks)`` entry
        chosen by ``_pick_chunk_prefill``."""
        slot.online = [r for r in slot.online if not r.done]
        slot.offline = [r for r in slot.offline if not r.done]
        empty = ((0.0, []) if want_batch else 0.0)
        pf_req = prefill[0] if prefill is not None else None
        if not slot.online and not slot.offline and pf_req is None:
            return empty
        if self.chunked:
            plan = self._plan_round(slot, relaxed, pf_req)
            selected = plan.decode
            batch = self._fit_batch(slot, selected)
            chunk = plan.chunk_tokens if plan.prefill is not None else 0
            allowance = plan.horizon
            if chunk:
                # the decode batch's incremental pages are not allocated yet
                # (that happens inside the fused dispatch, AFTER the chunk's
                # scatter claims its pages) — reserve them here or the chunk
                # can starve the decode rows into OutOfPagesError. A
                # horizon allowance > 1 reserves claim-ahead to the horizon
                # END (one page claim per decode step per row), so neither
                # the chunk nor the decode side can starve the other
                # mid-scan
                cache = slot.engine.cache
                reserved = sum(
                    cache.pages_for(r.context_len - 1
                                    + min(allowance, max(r.remaining, 1)))
                    - len(cache.tables.get(r.rid, [])) for r in batch)
                chunk = self._fit_chunk(slot, pf_req, chunk,
                                        exclude={r.rid for r in batch},
                                        reserved_pages=reserved)
        else:
            selected = self._select_batch(slot, relaxed)
            batch = self._fit_batch(slot, selected)
            chunk = 0
            allowance = self._horizon_allowance(relaxed)
        if (not relaxed and not selected and not chunk and slot.offline
                and not slot.online):
            # mix decoding admitted no offline row and no online row is here
            # to protect. Its bound would hold these residents for good: in
            # wall mode it scales with measured_tpot, which moves only when a
            # strict slot decodes; in virtual mode it is slo_tpot against the
            # modelled step of contexts that do not grow while they wait. So
            # they decode (the reference strands them: ROADMAP queue 3)
            batch = self._fit_batch(slot, slot.offline)
        if chunk:
            # chunked rounds fuse the horizon too (mixed-horizon dispatch):
            # K decode iterations ride the scan while the chunk lands as K
            # sub-chunk slices; a dropped chunk (page pressure) or online
            # work in the round falls back to K=1, keeping today's
            # preemption boundary exactly when latency is critical
            horizon = self._choose_mixed_horizon(slot, batch, pf_req, chunk,
                                                 allowance)
        else:
            horizon = self._choose_horizon(slot, batch, allowance)
        if not batch and not chunk:
            if (pf_req is not None and prefill in slot.prefilling
                    and not slot.offline):
                # full pool with nothing decodable and no chunk admissible:
                # vLLM-style recompute preemption — drop the landed prefix
                # so pinned prefills can never wedge the engine
                self._abort_chunk_prefill(slot, prefill)
            return empty
        dec_ctx = [r.context_len for r in batch]
        if chunk and horizon > 1:
            # one dispatch overhead for the whole fused mixed horizon;
            # chunk work summed per sub-chunk, decode at midpoint context
            est = self.pm.mixed_horizon_estimate(
                chunk, pf_req.prefill_tokens_done + chunk, dec_ctx, horizon,
                cached_tokens=pf_req.cached_tokens)
            # chunk-only share of the fused round — the denominator of
            # effective prefill throughput in the prefix-reuse bench
            self.metrics.prefill_modeled_seconds += \
                self.pm.mixed_horizon_estimate(
                    chunk, pf_req.prefill_tokens_done + chunk, (), horizon,
                    cached_tokens=pf_req.cached_tokens).latency
        elif chunk:
            est = self.pm.mixed_estimate(
                chunk, pf_req.prefill_tokens_done + chunk, dec_ctx,
                cached_tokens=pf_req.cached_tokens)
            # chunk-only share of the fused round — the denominator of
            # effective prefill throughput in the prefix-reuse bench
            self.metrics.prefill_modeled_seconds += self.pm.mixed_estimate(
                chunk, pf_req.prefill_tokens_done + chunk, (),
                cached_tokens=pf_req.cached_tokens).latency
        elif horizon > 1:
            # one dispatch overhead for the whole horizon — the virtual
            # clock charges the amortization the fused dispatch buys
            est = self.pm.horizon_estimate(dec_ctx, horizon)
        else:
            est = self.pm.decode_estimate(dec_ctx)
        if (self.injector is not None
                and self.injector.dispatch_stuck(slot.name, now)):
            # injected wedge: the dispatch would never return; the watchdog
            # kills it once the round exceeds watchdog_mult x the roofline-
            # predicted latency, and the round retries from intact state
            # (nothing was committed, so token parity is untouched)
            self.metrics.watchdog_aborts += 1
            cost = (est.latency * self.watchdog_mult
                    if self.clock.virtual else 0.0)
            return (cost, []) if want_batch else cost
        slot.last_bottleneck = est.bottleneck
        if not relaxed:
            online_lat = (self.pm.decode_estimate(
                [r.context_len for r in slot.online]).latency
                if slot.online else 0.0)
            slot.pressure = 0.9 * slot.pressure + 0.1 * min(
                online_lat / self.slo_tpot, 1.0)
        virtual = self.clock.virtual
        before = [r.decode_time_sum for r in batch] if virtual else None
        active = ([min(horizon, r.remaining) for r in batch]
                  if horizon > 1 else None)
        t0 = time.perf_counter()
        if chunk and horizon > 1:
            slot.engine.mixed_horizon([r.rid for r in batch], pf_req.rid,
                                      chunk, horizon)
            self.metrics.mixed_horizon_rounds += 1
        elif chunk:
            slot.engine.mixed_step([r.rid for r in batch], pf_req.rid, chunk)
        elif horizon > 1:
            slot.engine.decode_horizon([r.rid for r in batch], horizon)
            self.metrics.horizon_rounds += 1
        else:
            slot.engine.decode_step([r.rid for r in batch])
        dt = time.perf_counter() - t0
        step_lat = est.latency if virtual else dt
        if virtual:
            # the engine charged measured wall time; replace with modeled
            # time so TPOT metrics are bit-deterministic across replays
            # (a horizon row is charged its amortized share of the fused
            # dispatch — early-exit rows only for the steps they ran)
            for i, (r, b) in enumerate(zip(batch, before)):
                share = (active[i] / horizon) if active is not None else 1.0
                r.decode_time_sum = b + est.latency * share
        if not relaxed:
            self.measured_tpot = 0.8 * self.measured_tpot + 0.2 * step_lat
        for r in batch:
            if r.done:
                self._finish(r, slot.engine, now + step_lat)
        cost = step_lat
        if chunk:
            cost += self._after_chunk(slot, pf_req, now, step_lat)
        return (cost, batch) if want_batch else cost

    def _abort_chunk_prefill(self, slot: EngineSlot, entry) -> None:
        """Discard a pinned chunk prefill's landed prefix and requeue the
        request (recompute later, counted in ``recompute_tokens``)."""
        req, toks = entry
        slot.prefilling.remove(entry)
        eng = slot.engine
        eng.abort_prefill(req.rid)
        eng.requests.pop(req.rid, None)
        eng.token_buf.pop(req.rid, None)
        if req.kind == Kind.ONLINE:
            self.online_queue.insert(0, (req, toks))
        else:
            self.offline_queue.append((req, toks, None))

    def _fit_chunk(self, slot: EngineSlot, req: Request, chunk: int,
                   exclude: set[int], reserved_pages: int = 0) -> int:
        """Page-budget admission for the round's prefill chunk: shrink it to
        the KV capacity left after the decode batch's reservations
        (``reserved_pages``, claimed inside the dispatch after the chunk's
        scatter; online prefills may evict offline residents first). A zero
        here just defers the chunk — the landed prefix stays pinned and
        resumes later."""
        cache = slot.engine.cache
        done = req.prefill_tokens_done
        slack = len(cache.tables.get(req.rid, [])) * cache.page_size - done

        def free_tok() -> int:
            free = cache.available_pages - reserved_pages
            return max(free, 0) * cache.page_size + max(slack, 0)

        avail = free_tok()
        if req.kind == Kind.ONLINE and chunk > avail:
            self._evict_from(slot, chunk - avail, exclude=exclude | {req.rid})
            avail = free_tok()
        return min(chunk, avail)

    def _pull_migration(self, slot: EngineSlot, batch: list[Request]) -> float:
        """§3.4.3 pull-model migration: a strict engine with SLO headroom
        computes its bottleneck-filling length preference (Alg. 1) and
        absorbs matching offline decodes from the relaxed pool. Returns the
        modeled transfer cost (charged to the strict round — pulls are not
        free under the virtual clock)."""
        all_included = len(batch) == slot.resident
        pref = sch.migration_decision(
            batch, all_included,
            self.slo_tpot if self.clock.virtual
            else self._effective_slo(slot.online, slot.offline),
            self.pm, mem_budget_bytes=self._free_kv_bytes(slot))
        if pref is None:
            return 0.0
        src_of = {r.rid: rs for rs in self.relaxed_pool
                  for r in rs.offline if not r.done}
        chosen = sch.select_for_migration(
            [r for rs in self.relaxed_pool for r in rs.offline if not r.done],
            pref)
        cost = 0.0
        for r in chosen:
            src = src_of[r.rid]
            if not slot.engine.cache.can_fit(src.engine.cache.lengths[r.rid]):
                break
            src.offline.remove(r)
            cost += self._migrate(r, src, slot)
            self.metrics.pulls += 1
        return cost

    # ------------------------------------------------------------------
    def _finish(self, req: Request, eng: ServingEngine, t: float) -> None:
        req.phase = Phase.FINISHED
        req.finish_time = t
        self.tokens[req.rid] = eng.token_buf[req.rid].tolist()
        self.finished.append(req)
        if self.draining:
            self.metrics.drained += 1

    # ------------------------------------------------------------------
    # trace-driven event loop
    # ------------------------------------------------------------------
    def run(self, online: list[TraceRequest], offline: list[TraceRequest], *,
            duration: float | None = None, max_prompt: int = 64,
            max_output: int = 32, drain: bool = True,
            max_rounds: int = 200_000) -> dict:
        """Admit trace arrivals, step the pools until the work drains (or
        ``duration`` in no-drain mode), return the metrics summary.

        Prompt tokens are synthesized deterministically from ``seed`` and
        quantized to multiples of 8 (bounds jit-compilation variants);
        arrivals after ``duration`` are dropped. Idle rounds skip to the
        next arrival — virtually (clock jump) or by sleeping (wall)."""
        rng = np.random.default_rng(self.seed)
        self.clock.reset()   # construction/compile time is not trace time
        pending = sorted(
            [(t.arrival, 0, i, t) for i, t in enumerate(online)]
            + [(t.arrival, 1, i, t) for i, t in enumerate(offline)])
        if duration is not None:
            pending = [p for p in pending if p[0] <= duration]
        self._next_online_arrival = lambda: next(
            (p[0] for p in pending if p[1] == 0), None)
        # scan past any due offline arrivals: an online request queued
        # behind them must still trigger the §3.4.1 wall-mode probe
        self.incoming_online = lambda: any(
            p[0] <= self.clock.now() for p in pending if p[1] == 0)
        hard_cap = 10 * duration if duration else float("inf")

        def make_tokens(t: TraceRequest) -> list[int]:
            if getattr(t, "tokens", None) is not None:
                # trace carries explicit content (shared-prefix workloads);
                # trim to the runtime cap but keep the prefix intact so
                # cross-request reuse survives the clip
                return [int(x) for x in t.tokens[:max_prompt]]
            n = int(np.clip(-(-t.prompt_len // 8) * 8, 8, max_prompt))
            return [int(x) for x in rng.integers(0, self.cfg.vocab_size, n)]

        while True:
            now = self.clock.now()
            while pending and pending[0][0] <= now:
                arr, kcode, _, t = pending.pop(0)
                kind = Kind.ONLINE if kcode == 0 else Kind.OFFLINE
                toks = make_tokens(t)
                req = Request(kind, arr, len(toks),
                              max(min(t.output_len, max_output), 1))
                self.submit(req, toks)
            if duration is not None and now >= duration and not drain:
                break
            if now > hard_cap or self.metrics.rounds >= max_rounds:
                break
            worked = self.step()
            if not worked:
                if pending:
                    self.metrics.idle_rounds += 1
                    self.clock.idle_until(pending[0][0])
                    continue
                break
        return self.summary()

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        """TTFT/TPOT percentiles, SLO attainment, offline goodput, and the
        preemption/migration/eviction counters — the policy-comparison
        record (deterministic under the virtual clock: no wall times)."""
        elapsed = max(self.clock.now(), 1e-9)
        # SLO accounting under live lifecycles: a CLIENT-cancelled request
        # leaves the attainment denominator (the server cannot violate an
        # SLO the client walked away from), but a DEADLINE abort is always
        # billed as a violation — a deadline miss must never launder itself
        # into attainment by being aborted.
        online = [r for r in self.all_requests if r.kind == Kind.ONLINE
                  and not (r.phase is Phase.CANCELLED
                           and r.cancel_reason != "deadline")]
        offline = [r for r in self.all_requests if r.kind == Kind.OFFLINE]
        ttfts = [r.ttft() for r in online if r.ttft() is not None]
        tpots = [r.avg_tpot() for r in online if r.avg_tpot() is not None]
        viol = sum(1 for r in online
                   if (r.phase is Phase.CANCELLED
                       and r.cancel_reason == "deadline")
                   or r.violates(self.slo_ttft, self.slo_tpot, now=elapsed))
        off_tokens = int(sum(r.generated for r in offline))
        # §3.4.1 preemptions: layer-level interruptions (legacy path) plus
        # chunk-boundary pauses of in-progress offline prefills
        preempt = (sum(s.engine.stats.preemptions
                       for s in self.relaxed_pool + self.dead_pool)
                   + self.metrics.chunk_preemptions)
        pools = self.strict_pool + self.relaxed_pool + self.dead_pool
        return {
            "policy": self.policy,
            "n_strict": len(self.strict_pool),
            "n_relaxed": len(self.relaxed_pool),
            "clock": "virtual" if self.clock.virtual else "wall",
            "elapsed": float(elapsed),
            "online_requests": len(online),
            "online_finished": sum(1 for r in online if r.done),
            "online_slo_attainment": 1.0 - viol / max(len(online), 1),
            "online_ttft_p50": _pct(ttfts, 50),
            "online_ttft_p99": _pct(ttfts, 99),
            "online_tpot_p50": _pct(tpots, 50),
            "online_tpot_p99": _pct(tpots, 99),
            "offline_requests": len(offline),
            "offline_finished": sum(1 for r in offline if r.done),
            "offline_tokens": off_tokens,
            "offline_tokens_per_s": off_tokens / elapsed,
            "recompute_tokens": int(sum(r.recompute_tokens
                                        for r in self.all_requests)),
            "preemptions": int(preempt),
            "chunks": self.metrics.chunks,
            "chunk_preemptions": self.metrics.chunk_preemptions,
            # host_syncs = device->host syncs on the token path (one per
            # engine dispatch that returns tokens); horizon_steps = decode
            # iterations executed inside K>1 fused horizons — together they
            # record how much host round-tripping the horizons removed
            "host_syncs": int(sum(s.engine.stats.host_syncs for s in pools)),
            "horizon_steps": int(sum(s.engine.stats.horizon_steps
                                     for s in pools)),
            "horizon_rounds": self.metrics.horizon_rounds,
            "mixed_horizon_rounds": self.metrics.mixed_horizon_rounds,
            # dispatch counts per kind across all engines — amortization is
            # observable directly (a mixed_horizon dispatch covers K decode
            # steps AND K prefill sub-chunks), not just via host_syncs
            "dispatches_by_kind": {
                kind: int(sum(s.engine.stats.dispatches_by_kind[kind]
                              for s in pools))
                for kind in ("prefill", "decode", "mixed", "horizon",
                             "mixed_horizon")},
            "migrations": self.metrics.migrations,
            "pulls": self.metrics.pulls,
            "evictions": self.metrics.evictions,
            # cross-request KV reuse: prompt claims against the radix
            # prefix cache (hits / tokens served / pages shared at claim
            # time) and tree pages dropped under pool pressure
            "prefix_cache": self.prefix_cache,
            "prefix_hits": int(sum(s.engine.stats.prefix_hits
                                   for s in pools)),
            "cached_tokens": int(sum(s.engine.stats.cached_tokens
                                     for s in pools)),
            "shared_pages": int(sum(s.engine.stats.shared_pages
                                    for s in pools)),
            "prefix_evictions": int(sum(
                s.engine.cache.prefix.evictions for s in pools
                if s.engine.cache.prefix is not None)),
            "prefill_tokens": int(sum(s.engine.stats.prefill_tokens
                                      for s in pools)),
            "prefill_modeled_seconds": float(
                self.metrics.prefill_modeled_seconds),
            "rounds": self.metrics.rounds,
            "idle_rounds": self.metrics.idle_rounds,
            # fault-tolerance counters: nonzero only under injected chaos
            # or genuine overload; shed work is surfaced here, never silent
            "faults_injected": (self.injector.faults_injected
                                if self.injector else 0),
            "engine_crashes": self.metrics.engine_crashes,
            "promotions": self.metrics.promotions,
            "recoveries": self.metrics.recoveries,
            "migration_retries": self.metrics.migration_retries,
            "migration_recomputes": self.metrics.migration_recomputes,
            "watchdog_aborts": self.metrics.watchdog_aborts,
            "shed_requests": self.metrics.shed_requests,
            "degraded_rounds": self.metrics.degraded_rounds,
            # live lifecycle (gateway): every submitted request ends in
            # exactly one terminal state — finished, cancelled (client),
            # deadline-aborted, rejected at admission, or shed
            "cancelled": self.metrics.cancelled,
            "deadline_aborts": self.metrics.deadline_aborts,
            "rejected_online": self.metrics.rejected_online,
            "drained": self.metrics.drained,
        }

    def finished_signature(self) -> list[tuple]:
        """Trace-stable identity of every finished request + its full token
        stream (rids are process-global, so determinism tests compare this)."""
        return sorted(
            (r.kind.value, round(r.arrival, 9), r.prompt_len, r.output_len,
             tuple(self.tokens.get(r.rid, ())))
            for r in self.finished)
