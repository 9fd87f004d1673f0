"""The end-to-end arithmetic, from what the client saw: each online
request's due time and the times its tokens reached it, each a host-clock
reading at the return of the ``step()`` that produced the token, in seconds
after the window opened."""
from __future__ import annotations

import numpy as np


def p90(xs) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), 90))


def ttfts(online: list[dict], close: float) -> list[float]:
    """Every online request due in the window: its first token's time less
    its due time, or, with no first token by the close, the wait so far."""
    return [(r["times"][0] if r["times"] else close) - r["due"] for r in online]


def tpots(online: list[dict]) -> list[float]:
    """(last token's time - first token's time) / (tokens - 1), over the
    online requests with at least two tokens in the window."""
    return [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1)
            for r in online if len(r["times"]) >= 2]


def slo_attainment(online: list[dict], close: float, slo_ttft: float,
                   slo_tpot: float) -> float:
    """Share of the online requests due in the window that met both limits at
    the client: a first token within ``slo_ttft`` of the due time, and,
    with two tokens or more, a time per output token within ``slo_tpot``.
    A request with no first token by the close missed."""
    if not online:
        return 0.0
    ok = 0
    for r, t in zip(online, ttfts(online, close)):
        ok += bool(r["times"]) and t <= slo_ttft and all(
            x <= slo_tpot for x in tpots([r]))
    return ok / len(online)


def summary(online: list[dict], close: float, offline_tokens: int,
            slo_ttft: float, slo_tpot: float) -> dict:
    tt, tp = ttfts(online, close), tpots(online)
    return {
        "online_ttft_p90_s": p90(tt) if tt else None,
        "online_tpot_p90_ms": 1e3 * p90(tp) if tp else None,
        "offline_tokens_per_s": offline_tokens / close,
        "slo_attainment": slo_attainment(online, close, slo_ttft, slo_tpot),
        "online_due": len(online),
        "online_unserved": sum(1 for r in online if not r["times"]),
        "online_finished": sum(1 for r in online if r["finished"]),
        "online_tpot_samples": len(tp),
    }
