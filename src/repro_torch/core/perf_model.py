"""Roofline-based LLM inference performance model (paper §3.3, Tables 2–4, Eq. 1).

An operator-level behavioural simulator: for a given Prefill or Decode batch
it enumerates the model's GEMM / attention / SSM / communication operators,
assigns each theoretical FLOPs and memory traffic (Table 3), and predicts
latency as  max(FLOPs / F_a, Bytes / M_a)  per operator (Eq. 1), summed plus
a static per-iteration overhead (O_p / O_d) and communication time
(bytes / B_c).

Two calibrations ship (repro/core/hardware.py): a TPU-v5e analytic set used
by the cluster simulator, and a CPU-measured set fitted from timed JAX
engine runs, used to validate the paper's ≈5 % error claim
(benchmarks/bench_perfmodel_accuracy.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np

from repro_torch.models.config import AUDIO, HYBRID, MOE, SSM, VLM, ModelConfig


@dataclass(frozen=True)
class HardwareParams:
    """Table 4 symbols. FLOP/s and bytes/s are *achievable*, not peak."""

    name: str
    F_g: float    # achievable FLOP/s, GEMM
    F_ap: float   # achievable FLOP/s, prefill attention
    F_ad: float   # achievable FLOP/s, decode attention
    M_g: float    # achievable bytes/s, GEMM
    M_a: float    # achievable bytes/s, attention
    O_p: float    # static overhead per prefill iteration (s)
    O_d: float    # static overhead per decode iteration (s)
    B_c: float    # effective interconnect bytes/s (KV migration / collectives)
    hbm_capacity: float  # bytes per chip
    peak_flops: float    # theoretical peak (roofline ceiling, reporting only)
    peak_hbm_bw: float


@dataclass
class OpCost:
    name: str
    flops: float
    bytes: float
    kind: str  # gemm | attn_p | attn_d | ssm | comm | other

    def latency(self, hw: HardwareParams) -> float:
        if self.kind == "comm":
            return self.bytes / hw.B_c
        f = {"gemm": hw.F_g, "attn_p": hw.F_ap, "attn_d": hw.F_ad}.get(self.kind, hw.F_g)
        m = hw.M_a if self.kind in ("attn_p", "attn_d") else hw.M_g
        return max(self.flops / f, self.bytes / m)  # Eq. 1


@dataclass
class StepEstimate:
    """Prediction for one Prefill or Decode iteration."""

    latency: float
    flops: float
    bytes: float
    compute_time: float       # sum of per-op flops/F terms
    memory_time: float        # sum of per-op bytes/M terms
    comm_time: float
    overhead: float
    kv_bytes: float           # decode-cache bytes touched (capacity pressure)
    bottleneck: str           # "compute" | "memory" | "balanced" | "overhead"
    ops: list[OpCost] = field(default_factory=list)

    @property
    def compute_util(self) -> float:
        return self.compute_time / self.latency if self.latency else 0.0

    @property
    def memory_util(self) -> float:
        return self.memory_time / self.latency if self.latency else 0.0


class PerfModel:
    """Operator-level simulator for one model on one instance type.

    tp: tensor-parallel degree of the instance (the paper deploys 72B with
    TP=4); FLOPs/bytes are divided across chips and TP collectives added.
    """

    def __init__(self, cfg: ModelConfig, hw: HardwareParams, *, tp: int = 1,
                 d: int = 2):
        self.cfg = cfg
        self.hw = hw
        self.tp = tp
        self.d = d  # bytes per value (Table 2)

    # ------------------------------------------------------------------
    # Table 3 operator models
    # ------------------------------------------------------------------
    def _gemm(self, name: str, N: int, Din: int, Dout: int) -> OpCost:
        d = self.d
        flops = 2.0 * N * Din * Dout
        bytes_ = d * (N * Din + Din * Dout + N * Dout)
        return OpCost(name, flops / self.tp, bytes_ / self.tp, "gemm")

    def _attention(self, name: str, Dh: int, Sq: int, Skv: int, Hq: int,
                   Hkv: int, decode: bool) -> OpCost:
        # Table 3: FLOPs = 4 Dh Sq Skv (two GEMMs over the score matrix);
        # Memory = 2 d (Sq Dh + Skv Dh Hq/Hkv scaled to kv heads) — fused
        # kernel, intermediate scores stay on-chip (Flash semantics).
        d = self.d
        dh_total = Hq * (Dh // max(Hq, 1)) if False else Dh  # Dh = total hidden
        flops = 4.0 * dh_total * Sq * Skv
        bytes_ = 2.0 * d * (Sq * dh_total + Skv * dh_total * Hkv / Hq)
        kind = "attn_d" if decode else "attn_p"
        return OpCost(name, flops / self.tp, bytes_ / self.tp, kind)

    def _comm(self, name: str, bytes_: float) -> OpCost:
        return OpCost(name, 0.0, bytes_, "comm")

    # ------------------------------------------------------------------
    # per-layer operator inventories
    # ------------------------------------------------------------------
    def _layer_ops(self, n_tokens: int, attn_sq: Sequence[int],
                   attn_skv: Sequence[int], decode: bool) -> list[OpCost]:
        """Operators of one transformer layer for a batch with ``n_tokens``
        total tokens; attention is per-request (Sq_i, Skv_i) pairs."""
        cfg = self.cfg
        d = cfg.d_model
        hd = cfg.head_dim_
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        ops: list[OpCost] = []
        if cfg.family == SSM:
            return self._rwkv_layer_ops(n_tokens, decode)
        ops.append(self._gemm("qkv", n_tokens, d, (Hq + 2 * Hkv) * hd))
        Dh = Hq * hd
        for sq, skv in zip(attn_sq, attn_skv):
            ops.append(self._attention("attn", Dh, sq, skv, Hq, Hkv, decode))
        ops.append(self._gemm("o_proj", n_tokens, Hq * hd, d))
        if cfg.is_moe:
            ops.append(self._gemm("router", n_tokens, d, cfg.num_experts))
            # active-expert GEMMs: k experts per token; weights read for
            # min(E, tokens*k) experts (decode batches touch every expert)
            eff_tokens = n_tokens * cfg.experts_per_token
            n_active_exp = min(cfg.num_experts, eff_tokens)
            dff = cfg.d_ff
            flops = 3 * 2.0 * eff_tokens * d * dff
            w_bytes = self.d * 3 * n_active_exp * d * dff
            a_bytes = self.d * (2 * eff_tokens * d + eff_tokens * dff * 3)
            ops.append(OpCost("moe_ffn", flops / self.tp,
                              (w_bytes + a_bytes) / self.tp, "gemm"))
        else:
            n_mats = 2 if cfg.mlp_act == "gelu_mlp" else 3
            for i in range(n_mats - 1):
                ops.append(self._gemm(f"mlp_up{i}", n_tokens, d, cfg.d_ff))
            ops.append(self._gemm("mlp_down", n_tokens, cfg.d_ff, d))
        if self.tp > 1:
            # 2 all-reduces per layer (after attn, after mlp), ring: 2(tp-1)/tp
            ar = 2 * (self.tp - 1) / self.tp * n_tokens * d * self.d
            ops.append(self._comm("tp_allreduce", 2 * ar))
        return ops

    def _mamba_layer_ops(self, n_tokens: int, decode: bool) -> list[OpCost]:
        cfg = self.cfg
        d, di, ns, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
        ops = [self._gemm("mamba_in", n_tokens, d, 2 * di + 2 * ns + nh)]
        # SSD scan: per token, state update nh*hd*ns MACs x2 + output x2
        hd = cfg.ssm_head_dim
        flops = 6.0 * n_tokens * nh * hd * ns
        state_bytes = 4.0 * nh * hd * ns  # f32 state read+write per step
        n_steps = n_tokens if decode else max(1, n_tokens // cfg.ssm_chunk)
        bytes_ = self.d * 2 * n_tokens * di + state_bytes * 2 * n_steps
        ops.append(OpCost("ssd_scan", flops / self.tp, bytes_ / self.tp,
                          "attn_d" if decode else "attn_p"))
        ops.append(self._gemm("mamba_out", n_tokens, di, d))
        return ops

    def _rwkv_layer_ops(self, n_tokens: int, decode: bool) -> list[OpCost]:
        cfg = self.cfg
        d, H, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
        ops = [self._gemm(n, n_tokens, d, H * hd)
               for n in ("tm_r", "tm_k", "tm_v", "tm_g")]
        ops.append(self._gemm("tm_out", n_tokens, H * hd, d))
        ops.append(self._gemm("w_lora", n_tokens, d, cfg.rwkv_lora_dim))
        # wkv recurrence: per token per head 4*hd*hd MACs; f32 state traffic
        flops = 8.0 * n_tokens * H * hd * hd
        bytes_ = self.d * 2 * n_tokens * d + 8.0 * H * hd * hd * n_tokens * (
            1.0 if decode else 1.0 / max(cfg.ssm_chunk, 1))
        ops.append(OpCost("wkv", flops / self.tp, bytes_ / self.tp,
                          "attn_d" if decode else "attn_p"))
        ops.append(self._gemm("cm_k", n_tokens, d, cfg.d_ff))
        ops.append(self._gemm("cm_v", n_tokens, cfg.d_ff, d))
        ops.append(self._gemm("cm_r", n_tokens, d, d))
        return ops

    def _all_layers(self, n_tokens: int, attn_sq, attn_skv, decode: bool) -> list[OpCost]:
        cfg = self.cfg
        ops: list[OpCost] = []
        if cfg.family == HYBRID:
            per_mamba = self._mamba_layer_ops(n_tokens, decode)
            n_attn = cfg.num_layers // cfg.shared_attn_every
            per_attn = self._layer_ops(n_tokens, attn_sq, attn_skv, decode)
            ops += [dataclasses.replace(o) for _ in range(cfg.num_layers) for o in per_mamba]
            ops += [dataclasses.replace(o) for _ in range(n_attn) for o in per_attn]
        elif cfg.family == AUDIO:
            dec = self._layer_ops(n_tokens, attn_sq, attn_skv, decode)
            # cross attention ≈ one more attention + 2 projections per layer
            ops += [dataclasses.replace(o) for _ in range(cfg.num_layers) for o in dec]
            cross = [self._attention("cross", cfg.num_heads * cfg.head_dim_,
                                     sq, cfg.num_frontend_tokens, cfg.num_heads,
                                     cfg.num_kv_heads, decode) for sq in attn_sq]
            ops += [dataclasses.replace(o) for _ in range(cfg.num_layers) for o in cross]
        else:
            per = self._layer_ops(n_tokens, attn_sq, attn_skv, decode)
            ops += [dataclasses.replace(o) for _ in range(cfg.num_layers) for o in per]
        # logits are computed for one position per request (last token /
        # current decode token)
        ops.append(self._gemm("lm_head", len(attn_sq), cfg.d_model, cfg.vocab_size))
        return ops

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _page_table_op(self, cached_tokens: int) -> OpCost:
        """A prefix-cache hit converts prefill work into a page-table
        update: one page-id write (~4 B/token amortized) plus a refcount
        bump per claimed page — pure bookkeeping bandwidth, zero FLOPs."""
        return OpCost("page_table", 0.0, 4.0 * cached_tokens, "other")

    def prefill_estimate(self, seq_lens: Sequence[int],
                         cached_tokens: Sequence[int] | None = None
                         ) -> StepEstimate:
        """One prefill iteration over requests with the given prompt
        lengths. ``cached_tokens[i]`` prompt tokens of request *i* are
        served from the prefix cache (page-table update, no compute); only
        the uncached suffix runs through the stack, though each suffix
        query still attends over the full cached context."""
        seq_lens = list(seq_lens)
        if cached_tokens is None:
            cached = [0] * len(seq_lens)
        else:
            # a hit never covers the whole prompt (last token is always
            # computed so the first output token exists)
            cached = [min(max(int(c), 0), s - 1)
                      for c, s in zip(cached_tokens, seq_lens)]
        new = [s - c for s, c in zip(seq_lens, cached)]
        n_tokens = int(sum(new))
        # causal attention: a suffix query attends over the cached prefix
        # plus, on average, half of the new span
        ops = self._all_layers(n_tokens, new,
                               [max(c + n // 2, 1)
                                for c, n in zip(cached, new)], decode=False)
        tot_cached = sum(cached)
        if tot_cached:
            ops.append(self._page_table_op(tot_cached))
        # only the suffix KV is newly written; cached pages are resident
        return self._sum(ops, self.hw.O_p, kv_bytes=self.kv_bytes(new))

    def mixed_estimate(self, chunk_tokens: int, chunk_ctx: int,
                       decode_ctx: Sequence[int] = (), *,
                       cached_tokens: int = 0) -> StepEstimate:
        """One **fused mixed step**: a prefill chunk of ``chunk_tokens``
        (query positions ``[chunk_ctx - chunk_tokens, chunk_ctx)`` attending
        to the ``chunk_ctx`` tokens landed so far) executed in the same
        dispatch as a decode batch over ``decode_ctx``.

        Ops run back-to-back on the same instance, so per-op latencies sum,
        but the static dispatch overhead is paid **once** — the structural
        win of fusing over the serialized prefill-then-decode rounds
        (Sarathi-style chunked prefill, paper §3.4.1 boundary granularity).

        ``cached_tokens`` of ``chunk_ctx`` came from the prefix cache: they
        were never computed here, so the step only adds KV capacity for the
        residual context and pays a page-table bookkeeping op for the
        claim. The chunk's attention span is unchanged — suffix queries
        attend over cached keys just the same.
        """
        chunk_tokens = int(chunk_tokens)
        cached_tokens = max(0, min(int(cached_tokens),
                                   int(chunk_ctx) - chunk_tokens))
        decode_ctx = np.asarray(list(decode_ctx), np.float64)
        overhead = max(self.hw.O_p if chunk_tokens else 0.0,
                       self.hw.O_d if decode_ctx.size else 0.0)
        lat, fl, by, comp, mem, comm, kvb = overhead, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
        if chunk_tokens:
            # chunk queries average Skv = ctx_before + chunk/2 keys (causal)
            skv = max(int(chunk_ctx) - chunk_tokens // 2, 1)
            ops = self._all_layers(chunk_tokens, [chunk_tokens], [skv],
                                   decode=False)
            if cached_tokens:
                ops.append(self._page_table_op(cached_tokens))
            p = self._sum(ops, 0.0, kv_bytes=0.0)
            lat += p.latency
            fl += p.flops
            by += p.bytes
            comp += p.compute_time
            mem += p.memory_time
            comm += p.comm_time
            kvb += self.kv_bytes([max(int(chunk_ctx) - cached_tokens, 1)])
        if decode_ctx.size:
            d = self._fast_decode(decode_ctx)
            lat += d.latency - self.hw.O_d
            fl += d.flops
            by += d.bytes
            comp += d.compute_time
            mem += d.memory_time
            kvb += d.kv_bytes
        work = lat - overhead
        if work <= 0 or overhead > work:
            bn = "overhead"
        elif comp > 1.3 * mem:
            bn = "compute"
        elif mem > 1.3 * comp:
            bn = "memory"
        else:
            bn = "balanced"
        return StepEstimate(latency=lat, flops=fl, bytes=by, compute_time=comp,
                            memory_time=mem, comm_time=comm, overhead=overhead,
                            kv_bytes=kvb, bottleneck=bn)

    def prefill_saturation_tokens(self, max_t: int = 8192) -> int:
        """Roofline ridge point for prefill: the smallest token count whose
        step is compute-bound (GEMM flops/F_g >= bytes/M_g) with the static
        overhead an amortized minority (O_p <= 10% of step latency). Below
        this, a prefill chunk wastes bandwidth/dispatch; above it, extra
        chunk length only adds latency without improving utilization —
        which is exactly the chunk-size sweet spot chunked-prefill
        schedulers aim for. Memoized (schedulers call this every round)."""
        cached = getattr(self, "_prefill_sat_cache", None)
        if cached is not None and cached[0] == max_t:
            return cached[1]

        def saturated(T: int) -> bool:
            ops = self._layer_ops(T, [T], [max(T // 2, 1)], decode=False)
            gf = sum(o.flops for o in ops if o.kind == "gemm")
            gb = sum(o.bytes for o in ops if o.kind == "gemm")
            lat = self.prefill_estimate([T]).latency
            return (gf / self.hw.F_g >= gb / self.hw.M_g
                    and self.hw.O_p <= 0.1 * lat)

        lo, hi = 1, max_t
        if not saturated(hi):
            self._prefill_sat_cache = (max_t, max_t)
            return max_t
        while lo < hi:
            mid = (lo + hi) // 2
            if saturated(mid):
                hi = mid
            else:
                lo = mid + 1
        self._prefill_sat_cache = (max_t, lo)
        return lo

    def suggest_chunk_tokens(self, decode_ctx: Sequence[int] = (), *,
                             slo: float | None = None, chunk_ctx: int = 0,
                             bucket: int = 8, max_chunk: int = 4096,
                             cached_tokens: int = 0) -> int:
        """Pick the prefill-chunk token budget for a fused mixed step from
        the roofline ridge: start at ``prefill_saturation_tokens`` (decode
        rows share the GEMM, so their batch size is subtracted), round up to
        a bucket multiple, then — if an SLO bounds this step (latency-strict
        rounds) — shrink to the largest bucket multiple whose
        ``mixed_estimate`` stays within it. Returns 0 when even one bucket
        of prefill would break the SLO."""
        decode_ctx = list(decode_ctx)
        ridge = self.prefill_saturation_tokens(max_chunk)
        budget = max(ridge - len(decode_ctx), bucket)
        budget = min(-(-budget // bucket) * bucket, max_chunk)
        if slo is None:
            return budget
        lo, hi, best = 1, budget // bucket, 0
        while lo <= hi:
            mid = (lo + hi) // 2
            t = mid * bucket
            # a warm-started chunk's context is at least cached + chunk
            if self.mixed_estimate(t, max(chunk_ctx, cached_tokens + t),
                                   decode_ctx,
                                   cached_tokens=cached_tokens).latency <= slo:
                best, lo = t, mid + 1
            else:
                hi = mid - 1
        return best

    def horizon_estimate(self, decode_ctx: Sequence[int],
                         steps: int) -> StepEstimate:
        """One **K-step fused decode horizon**: ``steps`` consecutive decode
        iterations for a batch with the given context lengths executed as a
        single dispatch, so the static per-iteration overhead ``O_d`` is
        paid ONCE per horizon instead of once per token — the structural
        win of multi-step decode, exactly like ``mixed_estimate`` pays one
        overhead for the fused chunk+decode round.

        Per-step attention grows by one token per request inside the
        horizon; the sum over steps equals ``steps`` x the estimate at the
        midpoint context ``c + (K-1)/2`` (exact while attention cost is
        linear in context — i.e. away from a sliding-window cap)."""
        ctx = np.asarray(list(decode_ctx), np.float64)
        steps = max(int(steps), 1)
        hw = self.hw
        if ctx.size == 0:
            return StepEstimate(hw.O_d, 0, 0, 0, 0, 0, hw.O_d, 0, "overhead")
        if steps == 1:
            return self._fast_decode(ctx)
        gf, gb, gl, gc, gm = self._decode_batch_terms(float(len(ctx)))
        mid = ctx + (steps - 1) / 2.0
        af, ab, ac, am = self._decode_attn_fb(mid)
        al = self.decode_attn_time(mid).sum()
        lat = float(hw.O_d + steps * (gl + al))
        fl, by = float(steps * (gf + af)), float(steps * (gb + ab))
        comp, mem = float(steps * (gc + ac)), float(steps * (gm + am))
        work = lat - hw.O_d
        if hw.O_d > work:
            bn = "overhead"
        elif comp > 1.3 * mem:
            bn = "compute"
        elif mem > 1.3 * comp:
            bn = "memory"
        else:
            bn = "balanced"
        return StepEstimate(latency=lat, flops=fl, bytes=by, compute_time=comp,
                            memory_time=mem, comm_time=0.0, overhead=hw.O_d,
                            kv_bytes=self.kv_bytes(ctx + steps - 1),
                            bottleneck=bn)

    def suggest_decode_horizon(self, decode_ctx: Sequence[int], *,
                               slo: float | None = None,
                               preempt_latency: float | None = None,
                               dispatch_overhead: float | None = None,
                               overhead_frac: float = 0.02,
                               max_horizon: int = 16) -> int:
        """Roofline-chosen multi-step decode horizon K.

        Amortization: the smallest K that makes the per-dispatch overhead
        (``O_d``, or the larger measured ``dispatch_overhead`` when the
        caller has timed the real host gap between sync and next dispatch)
        an ``overhead_frac`` minority of the horizon's latency — beyond
        that, longer horizons buy nothing on the roofline and only coarsen
        scheduling granularity.

        Bounds: a horizon is ONE uninterruptible dispatch whose tokens
        arrive in a burst at the end, so its total latency must stay under
        the TPOT ``slo`` (latency-strict rounds) and under the §3.4.1
        ``preempt_latency`` bound (a queued online request waits at most
        one horizon before preemption can fire). Returns 1 when even a
        single step sits at a bound — never worse than today's behavior."""
        ctx = np.asarray(list(decode_ctx), np.float64)
        if ctx.size == 0:
            return 1
        ov = float(self.hw.O_d if dispatch_overhead is None
                   else max(dispatch_overhead, self.hw.O_d))
        w = max(self._fast_decode(ctx).latency - self.hw.O_d, 1e-12)
        k = int(np.ceil(ov * (1.0 - overhead_frac) / (overhead_frac * w)))
        k = min(max(k, 1), max(int(max_horizon), 1))
        bound = min((b for b in (slo, preempt_latency) if b is not None),
                    default=None)
        if bound is not None:
            while k > 1 and (self.horizon_estimate(ctx, k).latency
                             - self.hw.O_d + ov) > bound:
                k -= 1
        return k

    def mixed_horizon_estimate(self, chunk_tokens: int, chunk_ctx: int,
                               decode_ctx: Sequence[int] = (),
                               steps: int = 1, *,
                               cached_tokens: int = 0) -> StepEstimate:
        """One **fused mixed-horizon dispatch**: ``steps`` decode iterations
        for the batch over ``decode_ctx`` run in a single ``lax.scan``
        while the prefill chunk of ``chunk_tokens`` lands as ``steps``
        sub-chunk slices (``scheduling.split_chunk``), the final slice
        ending at ``chunk_ctx``. One static dispatch overhead per horizon.

        Chunk work is summed per sub-chunk (K slices stream the weights K
        times — the real cost of splitting, so the estimate is honest about
        when fusing does NOT pay); decode attention is evaluated at the
        midpoint context ``c + (K-1)/2`` exactly like
        ``horizon_estimate``."""
        chunk_tokens = int(chunk_tokens)
        steps = max(int(steps), 1)
        if chunk_tokens <= 0:
            return self.horizon_estimate(decode_ctx, steps)
        if steps == 1:
            return self.mixed_estimate(chunk_tokens, chunk_ctx, decode_ctx,
                                       cached_tokens=cached_tokens)
        steps = min(steps, chunk_tokens)
        cached_tokens = max(0, min(int(cached_tokens),
                                   int(chunk_ctx) - chunk_tokens))
        ctx = np.asarray(list(decode_ctx), np.float64)
        hw = self.hw
        overhead = max(hw.O_p, hw.O_d if ctx.size else 0.0)
        lat, fl, by, comp, mem, comm, kvb = (overhead, 0.0, 0.0, 0.0, 0.0,
                                             0.0, 0.0)
        # chunk side: sum the per-sub-chunk estimates (same int arithmetic
        # as mixed_estimate applied slice by slice)
        done = int(chunk_ctx) - chunk_tokens
        base, rem = divmod(chunk_tokens, steps)
        pos = done
        for i in range(steps):
            s = base + 1 if i < rem else base
            skv = max(pos + s - s // 2, 1)
            ops = self._all_layers(s, [s], [skv], decode=False)
            p = self._sum(ops, 0.0, kv_bytes=0.0)
            lat += p.latency
            fl += p.flops
            by += p.bytes
            comp += p.compute_time
            mem += p.memory_time
            comm += p.comm_time
            pos += s
        if cached_tokens:
            p = self._sum([self._page_table_op(cached_tokens)], 0.0,
                          kv_bytes=0.0)
            lat += p.latency
            fl += p.flops
            by += p.bytes
            comp += p.compute_time
            mem += p.memory_time
        kvb += self.kv_bytes([max(int(chunk_ctx) - cached_tokens, 1)])
        if ctx.size:
            gf, gb, gl, gc, gm = self._decode_batch_terms(float(len(ctx)))
            mid = ctx + (steps - 1) / 2.0
            af, ab, ac, am = self._decode_attn_fb(mid)
            al = self.decode_attn_time(mid).sum()
            lat += float(steps * (gl + al))
            fl += float(steps * (gf + af))
            by += float(steps * (gb + ab))
            comp += float(steps * (gc + ac))
            mem += float(steps * (gm + am))
            kvb += self.kv_bytes(ctx + steps - 1)
        work = lat - overhead
        if work <= 0 or overhead > work:
            bn = "overhead"
        elif comp > 1.3 * mem:
            bn = "compute"
        elif mem > 1.3 * comp:
            bn = "memory"
        else:
            bn = "balanced"
        return StepEstimate(latency=lat, flops=fl, bytes=by, compute_time=comp,
                            memory_time=mem, comm_time=comm, overhead=overhead,
                            kv_bytes=kvb, bottleneck=bn)

    def suggest_mixed_horizon(self, chunk_tokens: int, chunk_ctx: int,
                              decode_ctx: Sequence[int] = (), *,
                              slo: float | None = None,
                              preempt_latency: float | None = None,
                              queued_online: bool = False,
                              dispatch_overhead: float | None = None,
                              overhead_frac: float = 0.02,
                              max_horizon: int = 16) -> int:
        """Horizon K for a fused mixed round (chunk + decode in one scan).

        Amortization targets the DECODE side (the chunk's weight streaming
        is paid per sub-chunk either way, so splitting a chunk with no
        decode batch riding is strictly worse — returns 1). Fusing is NOT
        free for the chunk: every scan iteration re-streams the weights,
        so a K-horizon pays K weight streams to land the SAME chunk one
        round used to land in one stream — K only wins when the amortized
        dispatch overhead plus the extra decode tokens beat that cost. K
        is therefore chosen to maximize the round's MODELED token
        throughput, ``(chunk + K * batch) / latency(K)``, over candidate
        horizons up to the decode-amortization bound (overhead-dominated
        hardware pushes K up; streaming-dominated hardware keeps K at 1).
        The §3.4.1 bound applies to the whole dispatch: a horizon is one
        uninterruptible unit, so chunk-boundary preemption becomes
        horizon-boundary preemption and the horizon's end-to-end latency
        must fit under ``min(slo, preempt_latency)``. With online arrivals
        already queued (``queued_online``) the remaining preemption budget
        is half — K shrinks rather than pinning to 1, because the chunk
        still has to land either way."""
        chunk_tokens = int(chunk_tokens)
        ctx = list(decode_ctx)
        if chunk_tokens <= 0:
            return self.suggest_decode_horizon(
                ctx, slo=slo, preempt_latency=preempt_latency,
                dispatch_overhead=dispatch_overhead,
                overhead_frac=overhead_frac, max_horizon=max_horizon)
        if not ctx:
            return 1
        arr = np.asarray(ctx, np.float64)
        ov = float(self.hw.O_d if dispatch_overhead is None
                   else max(dispatch_overhead, self.hw.O_d))
        w = max(self._fast_decode(arr).latency - self.hw.O_d, 1e-12)
        k = int(np.ceil(ov * (1.0 - overhead_frac) / (overhead_frac * w)))
        k = min(max(k, 1), max(int(max_horizon), 1), chunk_tokens)
        if k > 1:
            # modeled-throughput argmax over candidate horizons (powers of
            # two up to the amortization bound): tokens landed per modeled
            # second, counting the chunk once and one decode token per
            # resident per iteration
            cands = sorted({1, k} | {c for c in (2, 4, 8, 16, 32)
                                     if c < k})
            extra = ov - max(self.hw.O_p, self.hw.O_d)

            def tput(c):
                est = self.mixed_horizon_estimate(
                    chunk_tokens, chunk_ctx, ctx, c)
                return (chunk_tokens + c * len(ctx)) / (
                    est.latency + max(extra, 0.0))
            k = max(cands, key=tput)
        bound = min((b for b in (slo, preempt_latency) if b is not None),
                    default=None)
        if bound is not None:
            if queued_online:
                bound = bound / 2.0
            model_ov = max(self.hw.O_p, self.hw.O_d)
            while k > 1 and (self.mixed_horizon_estimate(
                    chunk_tokens, chunk_ctx, ctx, k).latency
                    - model_ov + max(ov, model_ov)) > bound:
                k -= 1
        return k

    def decode_estimate(self, context_lens: Sequence[int],
                        detail: bool = False) -> StepEstimate:
        """One decode step for a batch whose requests have the given context
        (KV) lengths. n_tokens = batch size (one new token each).

        The default path is numpy-vectorized (the schedulers/simulator call
        this thousands of times per run); detail=True builds the per-op list.
        """
        if not detail:
            return self._fast_decode(np.asarray(context_lens, np.float64))
        B = len(context_lens)
        lens = [self._effective_ctx(c) for c in context_lens]
        ops = self._all_layers(B, [1] * B, lens, decode=True)
        return self._sum(ops, self.hw.O_d, kv_bytes=self.kv_bytes(context_lens))

    # ------------------------------------------------------------------
    # vectorized decode estimate (identical math, no per-op objects)
    #
    # Split into a batch-size-dependent part (GEMMs / SSM scan / comm) and a
    # per-request attention part, so the schedulers can evaluate latency
    # curves over candidate batches in O(1) per candidate (Alg. 1/2 run this
    # every decode step — see decode_latency_curve).
    # ------------------------------------------------------------------
    def _decode_batch_terms(self, n):
        """Batch-size-dependent terms. n: scalar or array of batch sizes.
        Returns (flops, bytes, latency, comp_time, mem_time) arrays."""
        cfg, hw, d = self.cfg, self.hw, self.d
        n = np.asarray(n, np.float64)

        def gemm(N, Din, Dout, count=1.0):
            f = 2.0 * N * Din * Dout * count / self.tp
            b = d * (N * Din + Din * Dout + N * Dout) * count / self.tp
            return f, b, np.maximum(f / hw.F_g, b / hw.M_g), f / hw.F_g, b / hw.M_g

        terms = []
        dm, hd = cfg.d_model, cfg.head_dim_
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        if cfg.family == SSM:
            H, rhd = cfg.rwkv_heads, cfg.rwkv_head_dim
            L = cfg.num_layers
            for (Din, Dout, cnt) in [(dm, H * rhd, 4 * L), (H * rhd, dm, L),
                                     (dm, cfg.rwkv_lora_dim, L), (dm, cfg.d_ff, L),
                                     (cfg.d_ff, dm, L), (dm, dm, L)]:
                terms.append(gemm(n, Din, Dout, cnt))
            f = 8.0 * n * H * rhd * rhd * L / self.tp
            b = (d * 2 * n * dm + 8.0 * H * rhd * rhd * n) * L / self.tp
            terms.append((f, b, np.maximum(f / hw.F_ad, b / hw.M_a),
                          f / hw.F_ad, b / hw.M_a))
        else:
            if cfg.family == HYBRID:
                L_attn = cfg.num_layers // cfg.shared_attn_every
                L_m = cfg.num_layers
                di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
                terms.append(gemm(n, dm, 2 * di + 2 * ns + nh, L_m))
                terms.append(gemm(n, di, dm, L_m))
                sf = 6.0 * n * nh * cfg.ssm_head_dim * ns * L_m / self.tp
                sb = (d * 2 * n * di + 8.0 * nh * cfg.ssm_head_dim * ns * n) * L_m / self.tp
                terms.append((sf, sb, np.maximum(sf / hw.F_ad, sb / hw.M_a),
                              sf / hw.F_ad, sb / hw.M_a))
            else:
                L_attn = cfg.num_layers
            terms.append(gemm(n, dm, (Hq + 2 * Hkv) * hd, L_attn))
            terms.append(gemm(n, Hq * hd, dm, L_attn))
            if cfg.is_moe:
                terms.append(gemm(n, dm, cfg.num_experts, L_attn))
                eff_tok = n * cfg.experts_per_token
                n_act = np.minimum(cfg.num_experts, eff_tok)
                f = 3 * 2.0 * eff_tok * dm * cfg.d_ff * L_attn / self.tp
                b = (d * 3 * n_act * dm * cfg.d_ff
                     + d * (2 * eff_tok * dm + 3 * eff_tok * cfg.d_ff)) * L_attn / self.tp
                terms.append((f, b, np.maximum(f / hw.F_g, b / hw.M_g),
                              f / hw.F_g, b / hw.M_g))
            elif cfg.family == AUDIO:
                terms.append(gemm(n, dm, cfg.d_ff, L_attn))
                terms.append(gemm(n, cfg.d_ff, dm, L_attn))
            else:
                n_up = 1 if cfg.mlp_act == "gelu_mlp" else 2
                terms.append(gemm(n, dm, cfg.d_ff, n_up * L_attn))
                terms.append(gemm(n, cfg.d_ff, dm, L_attn))
            if self.tp > 1:
                ar = 4 * (self.tp - 1) / self.tp * n * dm * d * L_attn
                terms.append((np.zeros_like(n), ar, ar / hw.B_c,
                              np.zeros_like(n), np.zeros_like(n)))
        terms.append(gemm(n, dm, cfg.vocab_size))
        return tuple(sum(t[i] for t in terms) for i in range(5))

    def decode_attn_time(self, ctx: np.ndarray) -> np.ndarray:
        """Per-request attention latency contribution (seconds each)."""
        cfg, hw, d = self.cfg, self.hw, self.d
        ctx = np.asarray(ctx, np.float64)
        if cfg.family == SSM:
            return np.zeros_like(ctx)
        eff = np.minimum(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        if cfg.local_global:
            eff = (np.minimum(ctx, cfg.sliding_window) + ctx) / 2.0
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        Dh = Hq * cfg.head_dim_
        L_attn = (cfg.num_layers // cfg.shared_attn_every
                  if cfg.family == HYBRID else cfg.num_layers)
        f = 4.0 * Dh * eff / self.tp
        b = 2.0 * d * (Dh + eff * Dh * Hkv / Hq) / self.tp
        lat = np.maximum(f / hw.F_ad, b / hw.M_a) * L_attn
        if cfg.family == AUDIO:  # cross attention over the encoder output
            cf = 4.0 * Dh * cfg.num_frontend_tokens / self.tp
            cb = 2.0 * d * (Dh + cfg.num_frontend_tokens * Dh * Hkv / Hq) / self.tp
            lat = lat + max(cf / hw.F_ad, cb / hw.M_a) * cfg.num_layers
        return lat

    def _decode_attn_fb(self, ctx: np.ndarray):
        """(flops, bytes, comp_time, mem_time) totals for the attention part."""
        cfg, hw, d = self.cfg, self.hw, self.d
        ctx = np.asarray(ctx, np.float64)
        if cfg.family == SSM:
            return 0.0, 0.0, 0.0, 0.0
        eff = np.minimum(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        if cfg.local_global:
            eff = (np.minimum(ctx, cfg.sliding_window) + ctx) / 2.0
        Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
        Dh = Hq * cfg.head_dim_
        L_attn = (cfg.num_layers // cfg.shared_attn_every
                  if cfg.family == HYBRID else cfg.num_layers)
        f = (4.0 * Dh * eff / self.tp).sum() * L_attn
        b = (2.0 * d * (Dh + eff * Dh * Hkv / Hq) / self.tp).sum() * L_attn
        if cfg.family == AUDIO:
            B = len(ctx)
            f += 4.0 * Dh * cfg.num_frontend_tokens * B * cfg.num_layers / self.tp
            b += (2.0 * d * (Dh + cfg.num_frontend_tokens * Dh * Hkv / Hq)
                  * B * cfg.num_layers / self.tp)
        return f, b, f / hw.F_ad, b / hw.M_a

    def decode_latency_curve(self, base_ctx, extras_sorted) -> np.ndarray:
        """Latency of base batch plus the first k extras, for k = 0..K.
        O(B + K) total — used by Alg. 2's largest-prefix search."""
        base_ctx = np.asarray(base_ctx, np.float64)
        extras = np.asarray(extras_sorted, np.float64)
        B0, K = len(base_ctx), len(extras)
        ns = B0 + np.arange(K + 1, dtype=np.float64)
        gl = self._decode_batch_terms(ns)[2]
        a0 = self.decode_attn_time(base_ctx).sum() if B0 else 0.0
        pref = np.concatenate([[0.0], np.cumsum(self.decode_attn_time(extras))])
        return self.hw.O_d + gl + a0 + pref

    def _fast_decode(self, ctx: np.ndarray) -> StepEstimate:
        hw = self.hw
        B = len(ctx)
        if B == 0:
            return StepEstimate(hw.O_d, 0, 0, 0, 0, 0, hw.O_d, 0, "overhead")
        gf, gb, gl, gc, gm = self._decode_batch_terms(float(B))
        af, ab, ac, am = self._decode_attn_fb(ctx)
        al = self.decode_attn_time(ctx).sum()
        fl, by = float(gf + af), float(gb + ab)
        lat = float(hw.O_d + gl + al)
        comp, mem = float(gc + ac), float(gm + am)
        work = lat - hw.O_d
        if hw.O_d > work:
            bn = "overhead"
        elif comp > 1.3 * mem:
            bn = "compute"
        elif mem > 1.3 * comp:
            bn = "memory"
        else:
            bn = "balanced"
        return StepEstimate(latency=lat, flops=fl, bytes=by, compute_time=comp,
                            memory_time=mem, comm_time=0.0, overhead=hw.O_d,
                            kv_bytes=self.kv_bytes(ctx), bottleneck=bn)

    def _effective_ctx(self, c: int) -> float:
        w = self.cfg.sliding_window
        if self.cfg.local_global:
            # half the layers are windowed — approximate per-layer mix
            return (min(c, w) + c) / 2.0 if w else c
        return min(c, w) if w else c

    def kv_bytes(self, context_lens) -> float:
        """Decode-state bytes for these requests (capacity + migration cost)."""
        cfg = self.cfg
        ctx = np.asarray(list(context_lens) if not isinstance(
            context_lens, np.ndarray) else context_lens, np.float64)
        if ctx.size == 0:
            return 0.0
        eff = np.minimum(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        if cfg.local_global:
            eff = (np.minimum(ctx, cfg.sliding_window) + ctx) / 2.0
        per_tok = self.kv_bytes_per_token()
        fixed = self.state_bytes_fixed()
        return float(per_tok * eff.sum() + fixed * ctx.size) / self.tp

    def kv_bytes_per_request(self, ctx: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        ctx = np.asarray(ctx, np.float64)
        eff = np.minimum(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        if cfg.local_global:
            eff = (np.minimum(ctx, cfg.sliding_window) + ctx) / 2.0
        return (self.kv_bytes_per_token() * eff + self.state_bytes_fixed()) / self.tp

    def kv_bytes_per_token(self) -> float:
        cfg = self.cfg
        if cfg.family == SSM:
            return 0.0
        n_attn_layers = (cfg.num_layers // cfg.shared_attn_every
                         if cfg.family == HYBRID else cfg.num_layers)
        return 2.0 * self.d * cfg.num_kv_heads * cfg.head_dim_ * n_attn_layers

    def state_bytes_fixed(self) -> float:
        """Per-request O(1) state (SSM/conv/rwkv) independent of length."""
        cfg = self.cfg
        if cfg.family == SSM:
            H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
            return (4.0 * H * hd * hd + 2 * self.d * cfg.d_model) * cfg.num_layers
        if cfg.family == HYBRID:
            nh, hd, ns = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
            conv = self.d * (cfg.ssm_conv - 1) * (cfg.ssm_d_inner + 2 * ns)
            return (4.0 * nh * hd * ns + conv) * cfg.num_layers
        return 0.0

    def weight_bytes(self) -> float:
        return self.d * self.cfg.num_params() / self.tp

    def migration_seconds(self, context_len: int) -> float:
        """KV/state transfer time relaxed->strict over the interconnect."""
        b = self.kv_bytes([context_len])
        return b / self.hw.B_c

    def _sum(self, ops: list[OpCost], overhead: float, kv_bytes: float) -> StepEstimate:
        lat = overhead
        comp = mem = comm = fl = by = 0.0
        for o in ops:
            lat += o.latency(self.hw)
            fl += o.flops
            by += o.bytes
            if o.kind == "comm":
                comm += o.bytes / self.hw.B_c
            else:
                f = {"gemm": self.hw.F_g, "attn_p": self.hw.F_ap,
                     "attn_d": self.hw.F_ad}.get(o.kind, self.hw.F_g)
                m = self.hw.M_a if o.kind.startswith("attn") else self.hw.M_g
                comp += o.flops / f
                mem += o.bytes / m
        work = lat - overhead
        if work <= 0:
            bn = "overhead"
        elif overhead > work:
            bn = "overhead"
        elif comp > 1.3 * mem:
            bn = "compute"
        elif mem > 1.3 * comp:
            bn = "memory"
        else:
            bn = "balanced"
        return StepEstimate(latency=lat, flops=fl, bytes=by, compute_time=comp,
                            memory_time=mem, comm_time=comm, overhead=overhead,
                            kv_bytes=kv_bytes, bottleneck=bn, ops=ops)

    # ------------------------------------------------------------------
    def compute_saturated_batch(self, ctx_len: int = 512, max_b: int = 4096) -> int:
        """bs_sat (Alg. 1): smallest decode batch where GEMM time is
        compute-bound (flops/F_g >= bytes/M_g). Binary search; memoized on a
        power-of-two ctx bucket (schedulers call this every decode step)."""
        key = (max(ctx_len, 1).bit_length(), max_b)
        cache = getattr(self, "_bs_sat_cache", None)
        if cache is None:
            cache = self._bs_sat_cache = {}
        if key in cache:
            return cache[key]
        cache[key] = v = self._compute_saturated_batch(ctx_len, max_b)
        return v

    def _compute_saturated_batch(self, ctx_len: int, max_b: int) -> int:
        lo, hi = 1, max_b
        if not self._gemm_compute_bound(hi, ctx_len):
            return max_b
        while lo < hi:
            mid = (lo + hi) // 2
            if self._gemm_compute_bound(mid, ctx_len):
                hi = mid
            else:
                lo = mid + 1
        return lo

    def _gemm_compute_bound(self, B: int, ctx: int) -> bool:
        est = self.decode_estimate([ctx] * B, detail=True)
        gemm_f = sum(o.flops for o in est.ops if o.kind == "gemm")
        gemm_b = sum(o.bytes for o in est.ops if o.kind == "gemm")
        return gemm_f / self.hw.F_g >= gemm_b / self.hw.M_g
