"""Open-loop traffic from a mix file (``traffic/<mix>.json``), frozen here
so that a change to the program cannot move the yardstick.

Lengths follow ``repro_torch.data.traces``: lognormal with the mix's mean
and coefficient of variation, clipped to the mix's bounds and floored to
whole tokens. Here they are the distribution's quantiles at evenly spaced
probabilities, not random draws, and the arrivals are a Poisson process's
gaps (the exponential's quantiles at the rate). Their order, which length
arrives when, is drawn once from the mix's own ``schedule_seed``: every run
seed offers the same load in the same order, and the run seed draws the
prompt tokens (and, elsewhere, the weights). An online TTFT p90 over some
tens of requests moved 2x between orders at one rate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass(frozen=True)
class Req:
    due: float            # seconds after the window opens (offline: 0)
    prompt: np.ndarray    # int64 token ids
    output_len: int


def lognormal_quantiles(mean: float, cov: float, n: int, lo: int, hi: int) -> np.ndarray:
    """n lengths: the lognormal's quantiles at (i + 1/2) / n, clipped to
    [lo, hi] and floored, as ``traces._lognormal_lengths`` floors draws."""
    if n <= 0:
        return np.zeros(0, np.int64)
    sigma2 = math.log(1.0 + cov ** 2)
    mu = math.log(mean) - sigma2 / 2
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(mu + math.sqrt(sigma2) * z)
    return np.clip(x, lo, hi).astype(np.int64)


def poisson_arrivals(rate: float, seconds: float, order: np.random.Generator) -> np.ndarray:
    """round(rate * seconds) arrival times in [0, seconds): the gaps are the
    exponential's quantiles at ``rate``, scaled to sum to ``seconds`` and
    put in an order drawn from ``order``; the first arrival is at 0."""
    n = int(round(rate * seconds))
    if n <= 0:
        return np.zeros(0)
    p = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-p) / rate
    gaps = order.permutation(gaps * (seconds / gaps.sum()))
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def _lengths(side: dict, n: int, order: np.random.Generator):
    p = lognormal_quantiles(side["prompt_mean"], side["cov"], n,
                            side["prompt_min"], side["prompt_max"])
    o = lognormal_quantiles(side["output_mean"], side["cov"], n,
                            side["output_min"], side["output_max"])
    return order.permutation(p), order.permutation(o)


def online_requests(mix: dict, rate: float, seconds: float, seed: int,
                    vocab: int) -> list[Req]:
    """The online requests due in a window of ``seconds`` at ``rate``."""
    order = np.random.default_rng([mix["schedule_seed"], 1])
    due = poisson_arrivals(rate, seconds, order)
    plen, olen = _lengths(mix["online"], len(due), order)
    toks = np.random.default_rng([seed, 2]).integers(0, vocab, int(plen.sum()))
    cuts = np.cumsum(plen)[:-1]
    return [Req(float(t), p, int(o))
            for t, p, o in zip(due, np.split(toks, cuts), olen)]


def offline_backlog(mix: dict, n: int, seed: int, vocab: int) -> list[Req]:
    """The offline backlog: ``n`` requests, all due at once."""
    order = np.random.default_rng([mix["schedule_seed"], 3])
    plen, olen = _lengths(mix["offline"], n, order)
    toks = np.random.default_rng([seed, 4]).integers(0, vocab, int(plen.sum()))
    cuts = np.cumsum(plen)[:-1]
    return [Req(0.0, p, int(o)) for p, o in zip(np.split(toks, cuts), olen)]


def max_context(mix: dict) -> int:
    """The longest context any request of the mix can reach."""
    return max(s["prompt_max"] + s["output_max"]
               for s in (mix["online"], mix["offline"]))
