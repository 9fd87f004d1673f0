"""OOCO's four scheduling points (paper §3.4, Algorithms 1 & 2).

All functions are pure decisions over request views + the perf model, so the
discrete-event simulator and the real JAX engine execute the *same* logic.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Sequence

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Kind, Request

LatencyFn = Callable[[Sequence[int]], float]  # context lens -> predicted step s


def _latency(pm: PerfModel, reqs: Sequence[Request]) -> float:
    if not reqs:
        return 0.0
    return pm.decode_estimate([r.context_len for r in reqs]).latency


# ---------------------------------------------------------------------------
# §3.4.4  Mix Decoding Selection (Algorithm 2)
# ---------------------------------------------------------------------------

def mix_decoding_selection(
    online: Sequence[Request],
    offline: Sequence[Request],
    slo: float,
    pm: PerfModel,
    *,
    max_probe: int = 8,
    rng: random.Random | None = None,
    mem_budget_bytes: float | None = None,
) -> list[Request]:
    """Per decode step: all online requests first, then offline requests under
    the TPOT SLO — randomized probing (anti-starvation) followed by
    sort-by-length + binary-search for the largest feasible prefix."""
    import numpy as np

    rng = rng or random.Random(0)
    batch: list[Request] = list(online)
    if not offline:
        return batch

    # incremental latency bookkeeping: L = O_d + gemm(B) + sum(attn terms)
    attn_sum = float(pm.decode_attn_time(
        np.array([r.context_len for r in batch], np.float64)).sum()) if batch else 0.0
    kv_sum = pm.kv_bytes([r.context_len for r in batch]) if batch else 0.0

    def lat_of(B: int, attn: float) -> float:
        return pm.hw.O_d + float(pm._decode_batch_terms(float(B))[2]) + attn

    if lat_of(len(batch), attn_sum) > slo:
        return batch  # online already at/over SLO: best-effort, no offline

    remaining = list(offline)
    probes = min(max_probe, len(remaining))
    for _ in range(probes):
        r = remaining.pop(rng.randrange(len(remaining)))
        a = float(pm.decode_attn_time(np.array([r.context_len], np.float64))[0])
        kv = pm.kv_bytes([r.context_len])
        if lat_of(len(batch) + 1, attn_sum + a) <= slo and (
                mem_budget_bytes is None or kv_sum + kv <= mem_budget_bytes):
            batch.append(r)
            attn_sum += a
            kv_sum += kv
        # else: discard for this step (Alg. 2 line 7)

    if remaining and lat_of(len(batch), attn_sum) < slo:
        remaining.sort(key=lambda r: r.context_len)
        ctx = np.array([r.context_len for r in remaining], np.float64)
        curve = pm.decode_latency_curve(
            np.array([r.context_len for r in batch], np.float64), ctx)
        ok = curve <= slo
        if mem_budget_bytes is not None:
            per_kv = pm.kv_bytes_per_request(ctx)
            kv_curve = kv_sum + np.concatenate([[0.0], np.cumsum(per_kv)])
            ok &= kv_curve <= mem_budget_bytes
        # largest feasible prefix (curve is monotone in k)
        k = int(np.searchsorted(~ok[1:], True)) if len(ok) > 1 else 0
        batch.extend(remaining[:k])
    return batch


# ---------------------------------------------------------------------------
# Token-budget scheduling for fused mixed prefill/decode rounds
# ---------------------------------------------------------------------------

@dataclass
class MixedPlan:
    """One engine round under the token-budget scheduler: the decode batch
    plus (optionally) a prefill chunk fused into the same dispatch, and/or
    a multi-step horizon. ``horizon > 1`` with ``prefill`` set means a
    fused *mixed-horizon* round: one dispatch runs ``horizon`` decode
    iterations while landing the chunk as ``horizon`` sub-chunk slices
    (``split_chunk``), so the round's token budget covers
    ``decode x horizon + chunk_tokens`` total tokens."""
    decode: list[Request]
    prefill: Request | None = None
    chunk_tokens: int = 0      # prompt tokens of `prefill` to run this round
    horizon: int = 1           # fused decode iterations this round

    @property
    def total_tokens(self) -> int:
        return len(self.decode) * self.horizon + self.chunk_tokens


def split_chunk(chunk_tokens: int, steps: int) -> list[int]:
    """Split a prefill chunk into per-iteration sub-chunk sizes for a
    mixed-horizon dispatch: ``steps`` slices, each >= 1 token, differing by
    at most one token, summing exactly to ``chunk_tokens``. The larger
    slices come first so the final slice is never the odd one out."""
    steps = max(min(int(steps), int(chunk_tokens)), 1)
    base, rem = divmod(int(chunk_tokens), steps)
    return [base + 1 if i < rem else base for i in range(steps)]


def token_budget_schedule(
    online: Sequence[Request],
    offline: Sequence[Request],
    prefill: Request | None,
    prefill_remaining: int,
    pm: PerfModel,
    *,
    slo: float | None = None,
    budget_tokens: int | None = None,
    relaxed_cap: int | None = None,
    mem_budget_bytes: float | None = None,
    rng: random.Random | None = None,
    bucket: int = 8,
    decode_override: list[Request] | None = None,
    horizon: int = 1,
) -> MixedPlan:
    """Sarathi-style token-budget plan replacing the prefill-then-decode
    serialization: decode tokens ride first (one token each — they carry the
    latency SLO), and the leftover roofline budget becomes the prefill
    chunk, so every fused round sits near the compute/memory ridge instead
    of alternating between a memory-bound decode step and an
    over-long compute-bound prefill.

    ``slo`` set (latency-strict rounds): the decode batch comes from
    §3.4.4 mix-decoding selection and the chunk shrinks until the
    perf-model-predicted fused-step latency stays within the SLO (possibly
    to zero — decode SLO always wins). ``slo`` None (latency-relaxed
    rounds): decode is capped by ``relaxed_cap`` and the chunk floor is one
    bucket, so a resident decode batch can never starve prefill progress.
    ``budget_tokens`` overrides the roofline suggestion (``--chunk-tokens
    N``); ``decode_override`` lets a caller keep its own decode-batch
    policy (the runtime's baselines) while the budget sizes the chunk.
    ``horizon`` is the caller's multi-step decode-horizon allowance. On a
    chunkless round the plan carries it directly (token budget =
    decode-batch x horizon). When a chunk rides a latency-relaxed round
    the plan now keeps ``horizon > 1`` too — the round becomes one fused
    mixed-horizon dispatch whose budget is split into ``horizon``
    sub-chunks — clamped to ``chunk // bucket`` so every non-final
    sub-chunk is at least one bucket (~one page) of prefill. Strict
    rounds keep single-step fused semantics (``horizon == 1``)."""
    if decode_override is not None:
        decode = list(decode_override)
    elif slo is not None:
        decode = mix_decoding_selection(
            online, offline, slo, pm, rng=rng,
            mem_budget_bytes=mem_budget_bytes)
    else:
        decode = list(online) + list(offline)[:relaxed_cap]
    if prefill is None or prefill_remaining <= 0:
        return MixedPlan(decode, horizon=max(int(horizon), 1))
    dec_ctx = [r.context_len for r in decode]
    netted = budget_tokens is None
    if netted:
        # roofline ridge budget, already net of the decode batch's GEMM
        # share (the SLO cap is applied once, exactly, below)
        budget_tokens = pm.suggest_chunk_tokens(dec_ctx, bucket=bucket)
    if slo is not None:
        # latency-bound round: decode tokens spend the same budget (they
        # share the step's GEMMs), so the chunk gets the leftover
        chunk = max(budget_tokens if netted else budget_tokens - len(decode),
                    0)
    elif prefill.kind is Kind.ONLINE:
        # the chunk budget bounds how much OFFLINE prefill work can delay
        # latency-critical work per round (§3.4.1); an online prefill IS
        # the latency-critical work — chunking it only defers its own TTFT
        chunk = prefill_remaining
    else:
        # latency-relaxed round: the budget is a roofline floor, not a
        # latency cap — shrinking the chunk below it for resident decodes
        # only multiplies rounds (and their static overheads)
        chunk = max(budget_tokens, bucket)
    chunk = min(chunk, prefill_remaining)
    if slo is not None and chunk > 0:
        # largest bucket-multiple chunk whose fused step meets the SLO
        lo, hi, best = 1, -(-chunk // bucket), 0
        while lo <= hi:
            mid = (lo + hi) // 2
            t = min(mid * bucket, chunk)
            est = pm.mixed_estimate(
                t, prefill.prefill_tokens_done + t, dec_ctx,
                cached_tokens=getattr(prefill, "cached_tokens", 0))
            if est.latency <= slo:
                best, lo = t, mid + 1
            else:
                hi = mid - 1
        chunk = best
    if chunk <= 0:
        return MixedPlan(decode, horizon=max(int(horizon), 1))
    horizon = max(int(horizon), 1)
    if slo is not None:
        # latency-strict chunked round: one uninterruptible dispatch per
        # horizon would stretch the preemption boundary past the SLO math
        # above, which sized the chunk for a single fused step
        horizon = 1
    elif horizon > 1:
        # every non-final sub-chunk must carry at least one bucket (~one
        # page) of prefill, or splitting only multiplies scatter overhead
        horizon = max(1, min(horizon, int(chunk) // max(int(bucket), 1)))
    return MixedPlan(decode, prefill, int(chunk), horizon)


def decode_horizon_steps(
    batch: Sequence[Request],
    pm: PerfModel,
    *,
    requested: int | str | None,
    strict: bool = False,
    queued_online: bool = False,
    preempt_latency: float | None = None,
    max_horizon: int = 16,
) -> int:
    """§3.4.1-aware multi-step decode-horizon choice for one engine round.

    Latency-relaxed all-offline rounds amortize the per-dispatch overhead
    over roofline-chosen horizons (``requested="auto"`` routes through
    ``PerfModel.suggest_decode_horizon`` under the ``preempt_latency``
    bound — a horizon is one uninterruptible dispatch, so a queued online
    request waits at most one horizon). Latency-strict rounds, rounds
    decoding ANY online request, and rounds with an online request already
    queued clamp to K=1 so fast preemption and pull migration keep today's
    boundaries. K is also capped by the longest remaining output in the
    batch — steps past every row's ``max_new_tokens`` are pure waste."""
    if requested in (None, 0, 1, "0", "1") or not batch:
        return 1
    if strict or queued_online:
        return 1
    if any(r.kind is Kind.ONLINE for r in batch):
        return 1
    cap = min(int(max_horizon), max(r.remaining for r in batch))
    if cap <= 1:
        return 1
    if requested == "auto":
        k = pm.suggest_decode_horizon(
            [r.context_len for r in batch],
            preempt_latency=preempt_latency, max_horizon=cap)
    else:
        k = int(requested)
    return max(1, min(k, cap))


# ---------------------------------------------------------------------------
# §3.4.3  Offline Request Migration (Algorithm 1)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LengthPreference:
    """Pull-model preference a latency-strict node sends to relaxed nodes."""
    target_len: int      # preferred context length of requests to pull
    mode: str            # "longest" | "bounded" | "shortest"
    count: int = 1       # how many requests it is willing to absorb


def migration_decision(
    batch: Sequence[Request],
    all_node_requests_included: bool,
    slo: float,
    pm: PerfModel,
    *,
    mem_budget_bytes: float,
    slo_margin: float = 0.85,
    max_probe_len: int = 1 << 17,
) -> LengthPreference | None:
    """Algorithm 1: a latency-strict node with SLO headroom computes the
    request-length preference that best fills its dominant bottleneck."""
    import numpy as np

    ctx = np.array([r.context_len for r in batch], np.float64)
    B = len(batch)
    # O(1)-per-probe decomposition: L(B ∪ extras) = O_d + gemm(B+k) + Σ attn
    attn_base = float(pm.decode_attn_time(ctx).sum()) if B else 0.0
    kv_base = pm.kv_bytes(ctx) if B else 0.0

    def lat_with(l: int, k: int) -> float:
        a = float(pm.decode_attn_time(np.array([l], np.float64))[0])
        return (pm.hw.O_d + float(pm._decode_batch_terms(float(B + k))[2])
                + attn_base + k * a)

    def mem_ok(l: int, k: int) -> bool:
        per = float(pm.kv_bytes_per_request(np.array([l], np.float64))[0])
        return kv_base + k * per <= mem_budget_bytes

    lat = pm.hw.O_d + (float(pm._decode_batch_terms(float(B))[2]) + attn_base
                       if B else 0.0)
    if not (lat < slo * slo_margin and all_node_requests_included):
        return None  # no migration (Alg. 1 line 16)

    bs_sat = pm.compute_saturated_batch(int(ctx.mean()) if B else 512)

    def max_len_under(k: int) -> int:
        lo, hi, best = 1, max_probe_len, 0
        while lo <= hi:
            mid = (lo + hi) // 2
            if lat_with(mid, k) <= slo and mem_ok(mid, k):
                best, lo = mid, mid + 1
            else:
                hi = mid - 1
        return best

    if B >= bs_sat:
        # compute-saturated: batch growth buys nothing — fill *memory
        # capacity* with the longest request that fits SLO + memory
        best = max_len_under(1)
        if best:
            return LengthPreference(best, "longest")
        return None

    # not saturated: try to reach saturation within the SLO
    need = bs_sat - B
    if lat_with(1, need) <= slo and mem_ok(1, need):
        best = max_len_under(need)
        if best:
            return LengthPreference(best, "bounded", count=need)
    # cannot reach saturation: maximize batch size with the shortest requests
    return LengthPreference(1, "shortest", count=max(need, 1))


def select_for_migration(
    candidates: Sequence[Request],
    pref: LengthPreference,
) -> list[Request]:
    """Latency-relaxed side of the pull: pick the decoding offline requests
    closest to the preference (paper: 'most closed to Pref')."""
    if not candidates:
        return []
    ranked = sorted(candidates, key=lambda r: abs(r.context_len - pref.target_len))
    if pref.mode == "longest":
        # respect the upper bound strictly: never exceed target
        ranked = [r for r in ranked if r.context_len <= pref.target_len] or ranked[:1]
    return ranked[: pref.count]


# ---------------------------------------------------------------------------
# §3.4.1  Online preemption — eviction victim selection on strict nodes
# ---------------------------------------------------------------------------

def select_eviction_victims(
    offline_running: Sequence[Request],
    needed_tokens: int,
    bottleneck: str,
    shared_tokens: "dict[int, int] | None" = None,
) -> list[Request]:
    """Free >= needed_tokens of KV space for an incoming online request.

    compute-bound node: evict FEW LONG requests (preserves decode batch
    size, which is what compute efficiency depends on); otherwise evict
    SHORT ones (cheap recompute). Paper §3.4.1.

    ``shared_tokens`` maps rid -> tokens living on refcount>1 pages (the
    prefix cache). Evicting such a request frees only its UNSHARED tail —
    the shared pages stay resident for siblings — so victims are ranked by
    the space they actually release, unshared requests are preferred, and a
    victim that frees nothing is never picked while an alternative exists.

    Online requests are never eviction victims, even if the caller passes a
    mixed resident list (§3.4.1 evicts offline work only)."""
    candidates = [r for r in offline_running if r.kind is not Kind.ONLINE]
    shared = shared_tokens or {}

    def releasable(r: Request) -> int:
        return max(r.context_len - shared.get(r.rid, 0), 0)

    key = ((lambda r: (-releasable(r), -r.context_len))
           if bottleneck == "compute"
           else (lambda r: (shared.get(r.rid, 0) > 0, r.context_len)))
    ranked = sorted(candidates, key=key)
    victims, freed = [], 0
    for r in ranked:
        if freed >= needed_tokens:
            break
        if releasable(r) == 0 and shared:
            continue   # frees nothing: shared pages survive the eviction
        victims.append(r)
        freed += releasable(r) if shared else r.context_len
    if freed >= needed_tokens:
        return victims
    # cannot satisfy the demand: fall back to every candidate that frees
    # anything at all (legacy behavior when no sharing info is supplied)
    return [r for r in candidates if not shared or releasable(r) > 0] \
        or candidates


# ---------------------------------------------------------------------------
# Graceful degradation — overload admission control (offline sheds first)
# ---------------------------------------------------------------------------

def admission_decision(
    *,
    queued_online: int,
    strict_pressure: float,
    offline_backlog: int,
    free_page_frac: float = 1.0,
    max_backlog: int | None = None,
    pressure_high: float = 0.95,
    queue_high: int = 8,
    free_low: float = 0.02,
) -> str:
    """Overload gate for admitting NEW offline work: ``"admit"`` |
    ``"defer"`` | ``"shed"``.

    The degradation order is the point (HyGen/ConServe: SLO guarantees must
    hold under adverse conditions): when the cluster is overloaded — a deep
    online queue, the strict pool's pressure EMA pinned near the SLO with
    online work still waiting, or the relaxed pool's free pages nearly
    exhausted — fresh offline prefills stop being admitted (*defer*: they
    stay queued, costing nothing), so online SLO attainment decays last.
    Only when the offline backlog itself exceeds ``max_backlog`` (bounded
    queue — the operator's memory guard) is offline work *shed*, and sheds
    are always surfaced in ``summary()['shed_requests']``, never silent.
    Online work is never deferred or shed here. ``max_backlog=None``
    disables shedding entirely (defer-only degradation, the default)."""
    overloaded = (queued_online >= queue_high
                  or (queued_online > 0 and strict_pressure >= pressure_high)
                  or free_page_frac <= free_low)
    if not overloaded:
        return "admit"
    if max_backlog is not None and offline_backlog > max_backlog:
        return "shed"
    return "defer"


# ---------------------------------------------------------------------------
# Live-serving deadlines (gateway)
# ---------------------------------------------------------------------------

def deadline_state(req: Request, now: float) -> str:
    """Classify a live request against its client deadlines: ``"ok"`` |
    ``"ttft_blown"`` | ``"total_blown"``.

    Pure decision function (the runtime loop enforces the abort): a request
    whose TTFT deadline passed while it was still waiting for its first
    token, or whose total deadline passed before it finished, is not worth
    another FLOP — prefilling or decoding it only steals budget from
    requests that can still meet their SLOs. Deadlines are seconds relative
    to arrival; ``None`` means unbounded."""
    elapsed = now - req.arrival
    if (req.total_deadline is not None and not req.done
            and elapsed > req.total_deadline):
        return "total_blown"
    if (req.ttft_deadline is not None and req.first_token_time is None
            and elapsed > req.ttft_deadline):
        return "ttft_blown"
    return "ok"


# ---------------------------------------------------------------------------
# §3.4.2  Offline Request Gating (cost model)
# ---------------------------------------------------------------------------

def gating_decision(
    candidate: Request,
    current_offline_batch: Sequence[Request],
    pm: PerfModel,
    *,
    evict_probability: float,
    horizon_seconds: float,
    mem_budget_bytes: float,
    cached_tokens: int = 0,
) -> bool:
    """Prefill a new offline request on a relaxed node only if the expected
    throughput gain from the larger decode batch exceeds the expected
    recompute cost from potential eviction.

    ``cached_tokens`` is the candidate's prefix-cache hit length: cached
    tokens cost a page-table update instead of prefill FLOPs and add no new
    KV bytes, so a warm candidate is both cheaper to admit and cheaper to
    lose — the gate sees its true residual work."""
    cached = max(0, min(int(cached_tokens), candidate.prompt_len - 1))
    ctx = [r.context_len for r in current_offline_batch]
    # shared pages are already resident: only the suffix adds KV pressure
    if pm.kv_bytes(ctx + [candidate.prompt_len - cached]) > mem_budget_bytes:
        return False
    if not ctx:
        return True  # idle node: always worth prefilling
    lat_now = pm.decode_estimate(ctx).latency
    lat_new = pm.decode_estimate(ctx + [candidate.prompt_len]).latency
    rate_now = len(ctx) / lat_now
    rate_new = (len(ctx) + 1) / lat_new
    gain_tokens = max(rate_new - rate_now, 0.0) * horizon_seconds
    prefill_s = pm.prefill_estimate([candidate.prompt_len],
                                    [cached]).latency
    cost_tokens = evict_probability * prefill_s * rate_new
    return gain_tokens > cost_tokens
