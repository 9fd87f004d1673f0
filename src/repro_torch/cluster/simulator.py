"""Discrete-event simulator of the latency-disaggregated cluster (§3.1–3.4).

Instances are mesh-slice analogues of xllm instances; their step durations
come from the roofline perf model (the paper validates it at ≈5 % error, and
we re-validate against real timed engine runs in the benchmarks). The three
policies of §5.1.4 — base_pd, online_priority, ooco — share the event loop
and differ only in the scheduling decisions, which for OOCO are the *same
functions* (`core.scheduling`) the real engine executes.

Time model:
  online request:  arrive -> relaxed prefill queue -> prefill (layer-
  interruptible under ooco) -> KV migration (bytes/B_c) -> strict decode
  batch -> finish.   TTFT = prefill completion; TPOT = decode step times.
  offline request:  gated prefill on relaxed -> decode on relaxed (ooco) or
  migrate to strict; evictable (recompute) when online needs the space.

The port of ``repro.cluster.simulator``: the same event loop and arithmetic
over the port's scheduler, perf model and traces, so ``run()`` returns the
reference's dict value for value. It runs nothing on a device.
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import scheduling as sch
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Kind, Phase, Request
from repro_torch.data.traces import TraceRequest


@dataclass
class SimConfig:
    slo_ttft: float = 4.0
    slo_tpot: float = 0.10
    n_relaxed: int = 1
    n_strict: int = 1
    tp: int = 1
    kv_util: float = 0.90          # HBM fraction usable for KV after weights
    duration: float = 600.0
    violation_threshold: float = 0.03
    gating_horizon: float = 20.0   # §3.4.2 cost-model horizon (s)
    seed: int = 0
    offline_relaxed_batch_cap: int = 256


@dataclass
class InstanceState:
    iid: str
    kind: str                       # "relaxed" | "strict"
    resident: dict[int, Request] = field(default_factory=dict)
    serial: int = 0                 # quantum serial (stale-event filter)
    idle: bool = True
    # current prefill job (relaxed only)
    cur_req: Request | None = None
    cur_start: float = 0.0
    cur_end: float = 0.0
    cur_layer_dt: float = 0.0
    cur_total_layers: int = 0
    cur_done_layers: int = 0        # layers completed before this quantum
    busy_until: float = 0.0


class Simulator:
    def __init__(self, cfg_model, hw, policy: str, sim: SimConfig):
        self.cfg = cfg_model
        self.hw = hw
        self.pm = PerfModel(cfg_model, hw, tp=sim.tp)
        self.policy = policy
        self.sim = sim
        self.rng = random.Random(sim.seed)
        self.kv_budget = hw.hbm_capacity * sim.kv_util - self.pm.weight_bytes()
        assert self.kv_budget > 0, "model weights do not fit the instance"
        self.relaxed = [InstanceState(f"relaxed{i}", "relaxed")
                        for i in range(sim.n_relaxed)]
        self.strict = [InstanceState(f"strict{i}", "strict")
                       for i in range(sim.n_strict)]
        self.instances = {i.iid: i for i in self.relaxed + self.strict}
        self.online_queue: list[Request] = []      # waiting for prefill
        self.offline_queue: list[Request] = []     # waiting for (re)prefill
        self.events: list = []
        self._seq = itertools.count()
        self.now = 0.0
        self.online_done: list[Request] = []
        self.offline_tokens = 0
        self.offline_done = 0
        self.counters = {"relaxed_decode_quanta": 0, "relaxed_decode_tokens": 0,
                         "strict_offline_tokens": 0, "pulled": 0,
                         "prefills_online": 0, "prefills_offline": 0,
                         "interruptions": 0}
        self.all_online: list[Request] = []
        self.n_layers = cfg_model.num_layers + cfg_model.encoder_layers

    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    def _wake(self, inst: InstanceState, t: float):
        if inst.idle:
            inst.idle = False
            inst.serial += 1
            self._push(t, "ready", (inst.iid, inst.serial))

    def kv_used(self, inst: InstanceState) -> float:
        if not inst.resident:
            return 0.0
        return self.pm.kv_bytes([r.context_len for r in inst.resident.values()])

    # ------------------------------------------------------------------
    def run(self, online: list[TraceRequest], offline: list[TraceRequest]) -> dict:
        for tr in online:
            r = Request(Kind.ONLINE, tr.arrival, tr.prompt_len, tr.output_len)
            self.all_online.append(r)
            self._push(tr.arrival, "arrive", r)
        for tr in offline:
            r = Request(Kind.OFFLINE, tr.arrival, tr.prompt_len, tr.output_len)
            self._push(tr.arrival, "arrive", r)
        end = self.sim.duration
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            if t > end:
                break
            self.now = t
            if kind == "arrive":
                self._on_arrive(payload)
            elif kind == "ready":
                iid, serial = payload
                inst = self.instances[iid]
                if serial == inst.serial:
                    self._on_ready(inst)
            elif kind == "migrate_done":
                self._on_migrate_done(*payload)
            elif kind == "dispatch_retry":
                req, src_iid = payload
                self._dispatch_to_strict(req, self.instances[src_iid])
        return self._metrics()

    # ------------------------------------------------------------------
    def _on_arrive(self, req: Request):
        if req.kind == Kind.ONLINE:
            self.online_queue.append(req)
            inst = min(self.relaxed, key=lambda i: i.busy_until)
            if self.policy == "ooco":
                self._maybe_interrupt(inst)
            self._wake(inst, self.now)
        else:
            self.offline_queue.append(req)
            for inst in self.relaxed:
                self._wake(inst, self.now)

    def _maybe_interrupt(self, inst: InstanceState):
        """§3.4.1 layer-level interruption of a running OFFLINE prefill."""
        cur = inst.cur_req
        if cur is None or cur.kind != Kind.OFFLINE or inst.kind != "relaxed":
            return
        if not self.online_queue:
            return
        done_f = (self.now - inst.cur_start) / max(inst.cur_layer_dt, 1e-9)
        boundary_layers = int(np.ceil(done_f))
        boundary_t = inst.cur_start + boundary_layers * inst.cur_layer_dt
        if boundary_t >= inst.cur_end - 1e-12:
            return  # about to finish anyway
        # truncate the quantum at the next layer boundary
        cur.prefill_layers_done = inst.cur_done_layers + boundary_layers
        cur.phase = Phase.QUEUED
        self.offline_queue.insert(0, cur)   # resume later, keep progress
        inst.cur_req = None
        self.counters["interruptions"] += 1
        inst.serial += 1
        inst.idle = False
        inst.busy_until = boundary_t
        self._push(boundary_t, "ready", (inst.iid, inst.serial))

    # ------------------------------------------------------------------
    def _on_ready(self, inst: InstanceState):
        if inst.kind == "strict":
            self._strict_quantum(inst)
        else:
            self._relaxed_quantum(inst)

    # ------------------- strict (decode) -------------------------------
    def _strict_quantum(self, inst: InstanceState):
        reqs = list(inst.resident.values())
        online = [r for r in reqs if r.kind == Kind.ONLINE]
        offline = [r for r in reqs if r.kind == Kind.OFFLINE]
        batch = self._select_decode(inst, online, offline)
        if not batch:
            inst.idle = True
            return
        est = self.pm.decode_estimate([r.context_len for r in batch])
        inst.last_bottleneck = est.bottleneck
        lat = est.latency
        # strict-pool pressure EMA feeds the gating cost model (§3.4.2):
        # eviction risk is real only when decode runs near the TPOT SLO
        online_lat = (self.pm.decode_estimate(
            [r.context_len for r in online]).latency if online else 0.0)
        self._pressure = 0.9 * getattr(self, "_pressure", 0.0) + 0.1 * min(
            online_lat / self.sim.slo_tpot, 1.0)
        t_end = self.now + lat
        for r in batch:
            r.generated += 1
            r.decode_time_sum += lat
            if r.kind == Kind.OFFLINE:
                self.offline_tokens += 1
                self.counters["strict_offline_tokens"] += 1
            if r.done:
                r.phase = Phase.FINISHED
                r.finish_time = t_end
                inst.resident.pop(r.rid, None)
                if r.kind == Kind.ONLINE:
                    self.online_done.append(r)
                else:
                    self.offline_done += 1
        # §3.4.3 pull-model migration (ooco only), concurrent with compute
        if self.policy == "ooco" and any(
                r.kind == Kind.OFFLINE for ri in self.relaxed
                for r in ri.resident.values()):
            self._pull_migration(inst, batch)
        inst.busy_until = t_end
        inst.serial += 1
        inst.idle = False
        self._push(t_end, "ready", (inst.iid, inst.serial))

    def _select_decode(self, inst, online, offline) -> list[Request]:
        slo = self.sim.slo_tpot
        if self.policy == "base_pd":
            return online + offline  # no SLO-aware selection at all
        if self.policy == "online_priority":
            # static decode-batch cap calibrated once at a conservative long
            # context (existing co-location systems lack a per-step roofline
            # model — HyGen/Echo-style heuristics, paper §5.1.4/§6)
            cap = getattr(self, "_op_cap", None)
            if cap is None:
                p95 = 4096  # conservative context assumption
                lo, hi = 1, 4096
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if self.pm.decode_estimate([p95] * mid).latency <= slo:
                        lo = mid
                    else:
                        hi = mid - 1
                cap = self._op_cap = lo
            rest = sorted(offline, key=lambda x: x.context_len)
            return (online + rest)[:max(cap, len(online))]
        return sch.mix_decoding_selection(
            online, offline, slo, self.pm, rng=self.rng,
            mem_budget_bytes=self.kv_budget)

    def _pull_migration(self, inst: InstanceState, batch):
        all_included = len(batch) == len(inst.resident)
        pref = sch.migration_decision(
            batch, all_included, self.sim.slo_tpot, self.pm,
            mem_budget_bytes=self.kv_budget - self.kv_used(inst))
        if pref is None:
            return
        candidates = [r for ri in self.relaxed
                      for r in ri.resident.values() if r.kind == Kind.OFFLINE]
        chosen = sch.select_for_migration(candidates, pref)
        for r in chosen:
            self.counters["pulled"] += 1
            src = self.instances[r.location]
            src.resident.pop(r.rid, None)
            r.phase = Phase.MIGRATING
            delay = self.pm.migration_seconds(r.context_len)
            self._push(self.now + delay, "migrate_done", (r, inst.iid))

    # ------------------- relaxed (prefill + offline decode) ------------
    def _relaxed_quantum(self, inst: InstanceState):
        # 1) finish the quantum that just ended
        if inst.cur_req is not None:
            self._finish_prefill(inst, inst.cur_req)
            inst.cur_req = None
        # 2) pick next work
        nxt = self._next_prefill(inst)
        if nxt is not None:
            self._start_prefill(inst, nxt)
            return
        # 3) ooco: offline decode on the latency-relaxed instance
        if self.policy == "ooco" and inst.resident:
            self.counters["relaxed_decode_quanta"] += 1
            reqs = sorted(inst.resident.values(), key=lambda r: r.context_len)
            batch = reqs[: self.sim.offline_relaxed_batch_cap]
            est = self.pm.decode_estimate([r.context_len for r in batch])
            t_end = self.now + est.latency
            for r in batch:
                r.generated += 1
                r.decode_time_sum += est.latency
                self.offline_tokens += 1
                self.counters["relaxed_decode_tokens"] += 1
                if r.done:
                    r.phase = Phase.FINISHED
                    r.finish_time = t_end
                    inst.resident.pop(r.rid, None)
                    self.offline_done += 1
            inst.busy_until = t_end
            inst.serial += 1
            inst.idle = False
            self._push(t_end, "ready", (inst.iid, inst.serial))
            return
        inst.idle = True

    def _next_prefill(self, inst) -> Request | None:
        if self.policy == "base_pd":
            # FIFO over both kinds: offline prefill head-of-line blocks online
            merged = sorted(self.online_queue + self.offline_queue,
                            key=lambda r: r.arrival)
            for r in merged:
                if self._admit_prefill(inst, r):
                    (self.online_queue if r.kind == Kind.ONLINE
                     else self.offline_queue).remove(r)
                    return r
            return None
        if self.online_queue:
            r = self.online_queue.pop(0)
            return r
        # offline prefill only when no online work (both ooco + online_priority)
        used = self.kv_used(inst)
        budget_left = self.kv_budget - used
        for r in list(self.offline_queue)[:4]:  # FIFO head, bounded scan
            if self.pm.kv_bytes([r.context_len]) > budget_left:
                continue
            if self.policy == "ooco" and r.prefill_layers_done == 0:
                ok = sch.gating_decision(
                    r, list(inst.resident.values()), self.pm,
                    evict_probability=self._evict_probability(),
                    horizon_seconds=self.sim.gating_horizon,
                    mem_budget_bytes=budget_left)
                if not ok:
                    continue
            self.offline_queue.remove(r)
            return r
        return None

    def _admit_prefill(self, inst, r: Request) -> bool:
        need = self.pm.kv_bytes([r.context_len])
        return self.kv_used(inst) + need <= self.kv_budget

    def _evict_probability(self) -> float:
        """Eviction-risk estimate for the gating cost model (§3.4.2):
        offline requests only get evicted when online decode pressure on the
        strict pool approaches the SLO, so use that pressure EMA."""
        return 0.5 * getattr(self, "_pressure", 0.0)

    def _start_prefill(self, inst, req: Request):
        est = self.pm.prefill_estimate([req.context_len])
        frac = 1.0 - req.prefill_layers_done / self.n_layers
        dur = est.latency * frac
        req.phase = Phase.PREFILLING
        self.counters["prefills_online" if req.kind == Kind.ONLINE
                      else "prefills_offline"] += 1
        inst.cur_req = req
        inst.cur_start = self.now
        inst.cur_end = self.now + dur
        inst.cur_layer_dt = est.latency / self.n_layers
        inst.cur_done_layers = req.prefill_layers_done
        inst.busy_until = inst.cur_end
        inst.serial += 1
        inst.idle = False
        self._push(inst.cur_end, "ready", (inst.iid, inst.serial))

    def _finish_prefill(self, inst, req: Request):
        req.prefill_layers_done = self.n_layers
        req.prefill_end = self.now
        if req.generated == 0:
            req.generated = 1           # prefill emits the first token
            if req.kind == Kind.OFFLINE:
                self.offline_tokens += 1
            if req.first_token_time is None:
                req.first_token_time = self.now
            if req.done:
                req.phase = Phase.FINISHED
                req.finish_time = self.now
                if req.kind == Kind.ONLINE:
                    self.online_done.append(req)
                else:
                    self.offline_done += 1
                return
        if req.kind == Kind.ONLINE or self.policy != "ooco":
            self._dispatch_to_strict(req, inst)
        else:
            # ooco offline: decode on the relaxed node until pulled
            req.phase = Phase.DECODING
            req.location = inst.iid
            inst.resident[req.rid] = req

    def _dispatch_to_strict(self, req: Request, src: InstanceState):
        """Move a prefilled request to a strict instance (push model for
        online, §3.4.3; baselines use it for offline too). KV transfer is
        modeled at B_c bytes/s (RDMA->ICI adaptation, DESIGN §3)."""
        dst = max(self.strict, key=lambda i: self.kv_budget - self.kv_used(i))
        need = self.pm.kv_bytes([req.context_len])
        free = self.kv_budget - self.kv_used(dst)
        if need > free:
            freed = self._evict_for(dst, need - free, requester=req)
            free += freed
        if need > free:
            # cannot fit yet — retry shortly (KV stays at the source)
            self._push(self.now + 0.025, "dispatch_retry", (req, src.iid))
            return
        req.phase = Phase.MIGRATING
        delay = self.pm.migration_seconds(req.context_len)
        self._push(self.now + delay, "migrate_done", (req, dst.iid))

    def _evict_for(self, dst: InstanceState, need_bytes: float,
                   requester: Request) -> float:
        """Free KV space on a strict instance for an incoming request."""
        offline = [r for r in dst.resident.values() if r.kind == Kind.OFFLINE]
        if self.policy == "base_pd":
            # vLLM-style recompute preemption: latest arrival first, any kind
            victims_pool = sorted(dst.resident.values(),
                                  key=lambda r: -r.arrival)
        elif self.policy == "online_priority":
            victims_pool = sorted(offline, key=lambda r: r.context_len)
        else:  # ooco: bottleneck-aware victim selection (§3.4.1)
            per_tok = self.pm.kv_bytes_per_token() / self.sim.tp
            need_tokens = (int(np.ceil(need_bytes / per_tok)) if per_tok > 0
                           else sum(r.context_len for r in offline))
            bn = getattr(dst, "last_bottleneck", "memory")
            victims_pool = sch.select_eviction_victims(offline, need_tokens, bn)
        freed = 0.0
        for v in victims_pool:
            if freed >= need_bytes:
                break
            freed += self.pm.kv_bytes([v.context_len])
            dst.resident.pop(v.rid, None)
            v.phase = Phase.EVICTED
            v.evictions += 1
            v.recompute_tokens += v.context_len
            v.prefill_layers_done = 0
            if v.kind == Kind.ONLINE:
                # recompute: goes back through the online prefill queue
                self.online_queue.append(v)
            else:
                self.offline_queue.append(v)
        for inst in self.relaxed:
            self._wake(inst, self.now)
        return freed

    # ------------------------------------------------------------------
    def _on_migrate_done(self, req: Request, iid: str):
        inst = self.instances[iid]
        req.phase = Phase.DECODING
        req.location = iid
        inst.resident[req.rid] = req
        self._wake(inst, self.now)

    # ------------------------------------------------------------------
    def _metrics(self) -> dict:
        end = self.sim.duration
        counted = [r for r in self.all_online if r.arrival <= end]
        viol = sum(1 for r in counted
                   if r.violates(self.sim.slo_ttft, self.sim.slo_tpot, now=end))
        n = max(len(counted), 1)
        ttfts = [r.ttft() for r in counted if r.ttft() is not None]
        tpots = [r.avg_tpot() for r in counted if r.avg_tpot() is not None]
        return {
            "policy": self.policy,
            "online_requests": len(counted),
            "online_violation_rate": viol / n,
            "online_p50_ttft": float(np.median(ttfts)) if ttfts else float("nan"),
            "online_p99_ttft": float(np.percentile(ttfts, 99)) if ttfts else float("nan"),
            "online_p50_tpot": float(np.median(tpots)) if tpots else float("nan"),
            "offline_tokens": self.offline_tokens,
            "offline_token_throughput": self.offline_tokens / end,
            "offline_completed": self.offline_done,
            "offline_request_throughput": self.offline_done / end,
            **{f"c_{k}": v for k, v in self.counters.items()},
        }
