"""Request-trace generation and scaling (paper §5.1.2–5.1.3, Fig. 1, Table 5).

The paper's OOC trace is unreleased and the Azure traces are not available
offline, so we synthesize traces that reproduce the *published statistics*:

* arrival process = tide (hour-scale sinusoid) x bursts (minute-scale
  multiplicative spikes) x Poisson thinning  — the Fig. 1 structure;
* prompt/output lengths: lognormal distributions matched to the Table 5
  means (and CoV ~1, typical of production LLM traces).

``scale_trace`` implements §5.1.3 exactly: rate changes via random dropping
(down) or replication with interpolated timestamps (up), preserving the
temporal fluctuation pattern.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

# Table 5: average prompt / output lengths per dataset.
DATASET_STATS = {
    "ooc_online": (1892.47, 1062.62),
    "ooc_offline": (1200.52, 671.51),
    "azure_conv": (1512.30, 98.75),
    "azure_code": (2317.18, 22.74),
}


@dataclass(frozen=True)
class TraceRequest:
    arrival: float
    prompt_len: int
    output_len: int
    # explicit prompt token ids (shared-prefix workloads, where content —
    # not just length — matters for cross-request KV reuse); None = the
    # runtime synthesizes random tokens from its seed as before
    tokens: tuple[int, ...] | None = None


def _lognormal_lengths(rng: np.random.Generator, mean: float, n: int,
                       cov: float = 1.0, lo: int = 4, hi: int = 32768) -> np.ndarray:
    sigma2 = math.log(1.0 + cov ** 2)
    mu = math.log(mean) - sigma2 / 2
    x = rng.lognormal(mu, math.sqrt(sigma2), n)
    return np.clip(x, lo, hi).astype(int)


def _rate_profile(rng: np.random.Generator, duration: float, dt: float,
                  tide_period: float, burst_rate_per_hour: float,
                  burst_mult: tuple[float, float], burst_len: tuple[float, float],
                  ) -> np.ndarray:
    """Multiplicative tide x bursts intensity profile, mean ≈ 1."""
    t = np.arange(0.0, duration, dt)
    tide = 1.0 + 0.6 * np.sin(2 * np.pi * t / tide_period + rng.uniform(0, 2 * np.pi))
    burst = np.ones_like(t)
    n_bursts = rng.poisson(burst_rate_per_hour * duration / 3600.0)
    for _ in range(n_bursts):
        start = rng.uniform(0, duration)
        length = rng.uniform(*burst_len)
        mult = rng.uniform(*burst_mult)
        sel = (t >= start) & (t < start + length)
        burst[sel] = np.maximum(burst[sel], mult)
    prof = tide * burst
    return prof / prof.mean()


def online_trace(dataset: str, *, duration: float = 600.0, mean_qps: float = 2.0,
                 seed: int = 0, tide_period: float = 300.0,
                 burst_rate_per_hour: float = 30.0) -> list[TraceRequest]:
    """Synthesize an online trace with Fig.-1-style fluctuations.

    tide_period defaults to 300 s so a short simulated window still contains
    full tide cycles (a time-compressed version of the hourly pattern)."""
    key = {"ooc": "ooc_online"}.get(dataset, dataset)
    p_mean, o_mean = DATASET_STATS[key]
    rng = np.random.default_rng(seed)
    dt = 1.0
    prof = _rate_profile(rng, duration, dt, tide_period, burst_rate_per_hour,
                         burst_mult=(2.0, 5.0), burst_len=(10.0, 45.0))
    out: list[TraceRequest] = []
    for i, lam in enumerate(prof * mean_qps * dt):
        n = rng.poisson(lam)
        if not n:
            continue
        ts = rng.uniform(i * dt, (i + 1) * dt, n)
        pl = _lognormal_lengths(rng, p_mean, n)
        ol = _lognormal_lengths(rng, o_mean, n, hi=8192)
        out += [TraceRequest(float(a), int(p), int(o)) for a, p, o in zip(ts, pl, ol)]
    out.sort(key=lambda r: r.arrival)
    return out


def offline_requests(n: int, *, seed: int = 1) -> list[TraceRequest]:
    """Offline (batch) jobs with OOC-offline length statistics; arrivals are
    assigned by the QPS controller at evaluation time (§5.2: uniform QPS)."""
    rng = np.random.default_rng(seed)
    pl = _lognormal_lengths(rng, DATASET_STATS["ooc_offline"][0], n)
    ol = _lognormal_lengths(rng, DATASET_STATS["ooc_offline"][1], n, hi=8192)
    return [TraceRequest(0.0, int(p), int(o)) for p, o in zip(pl, ol)]


def shared_prefix_requests(num_prefixes: int = 2, variants: int = 2,
                           queries: int = 4, *, prefix_tokens: int = 48,
                           variant_tokens: int = 16, query_tokens: int = 8,
                           output_len: int = 4, vocab: int = 256,
                           seed: int = 3) -> list[TraceRequest]:
    """Shared-prefix offline workload: ``num_prefixes`` system prompts x
    ``variants`` few-shot variants x ``queries`` user queries (the ConServe/
    sglang analytics shape — prompts share long block-aligned prefixes by
    construction, so a radix prefix cache serves most prefill tokens from
    resident pages). Every request carries EXPLICIT token ids:

      [system prompt | few-shot variant | unique query]

    with the system prompt shared by ``variants * queries`` requests and
    each (prompt, variant) pair shared by ``queries``. Token content is
    drawn deterministically from ``seed``; arrivals are assigned by the QPS
    controller (``with_uniform_qps``) like the other offline generators."""
    rng = np.random.default_rng(seed)
    out: list[TraceRequest] = []
    for p in range(num_prefixes):
        sys_toks = rng.integers(0, vocab, prefix_tokens)
        for v in range(variants):
            var_toks = rng.integers(0, vocab, variant_tokens)
            for q in range(queries):
                qry_toks = rng.integers(0, vocab, query_tokens)
                toks = tuple(int(x) for x in
                             np.concatenate([sys_toks, var_toks, qry_toks]))
                out.append(TraceRequest(0.0, len(toks), output_len,
                                        tokens=toks))
    return out


def with_uniform_qps(reqs: list[TraceRequest], qps: float,
                     start: float = 0.0) -> list[TraceRequest]:
    """Uniform arrival spacing for offline load control (§5.2)."""
    if qps <= 0:
        return []
    return [dataclasses.replace(r, arrival=start + i / qps)
            for i, r in enumerate(reqs)]


def scale_trace(trace: list[TraceRequest], factor: float,
                seed: int = 0) -> list[TraceRequest]:
    """§5.1.3 trace scaling. factor < 1: random dropping; factor > 1:
    replicate lengths, interpolate timestamps. Temporal patterns (burst
    durations, peak/trough ratios) are preserved."""
    rng = np.random.default_rng(seed)
    if factor == 1.0 or not trace:
        return list(trace)
    if factor < 1.0:
        keep = rng.random(len(trace)) < factor
        return [r for r, k in zip(trace, keep) if k]
    out = list(trace)
    extra = int((factor - 1.0) * len(trace))
    idx = rng.integers(0, len(trace) - 1, extra)
    for i in idx:
        a, b = trace[i], trace[min(i + 1, len(trace) - 1)]
        t = rng.uniform(min(a.arrival, b.arrival), max(a.arrival, b.arrival) + 1e-9)
        src = trace[int(rng.integers(0, len(trace)))]  # replicate lengths
        out.append(TraceRequest(float(t), src.prompt_len, src.output_len))
    out.sort(key=lambda r: r.arrival)
    return out


def trace_stats(trace: list[TraceRequest]) -> dict:
    if not trace:
        return {"n": 0}
    pl = np.array([r.prompt_len for r in trace])
    ol = np.array([r.output_len for r in trace])
    ts = np.array([r.arrival for r in trace])
    dur = max(ts.max() - ts.min(), 1e-9)
    # burstiness: peak 10s-window rate over mean rate
    bins = np.histogram(ts, bins=max(int(dur / 10), 1))[0]
    return {
        "n": len(trace),
        "avg_prompt": float(pl.mean()),
        "avg_output": float(ol.mean()),
        "mean_qps": len(trace) / dur,
        "peak_over_mean": float(bins.max() / max(bins.mean(), 1e-9)),
    }
