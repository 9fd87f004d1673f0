"""Request abstraction shared by the schedulers, the cluster simulator and
the serving engine."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum


class Kind(str, Enum):
    ONLINE = "online"
    OFFLINE = "offline"


class Phase(str, Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    MIGRATING = "migrating"
    DECODING = "decoding"
    EVICTED = "evicted"     # must re-prefill (recompute) before decoding again
    FINISHED = "finished"
    CANCELLED = "cancelled"  # terminal: client abort or deadline exceeded


_ids = itertools.count()


@dataclass
class Request:
    kind: Kind
    arrival: float
    prompt_len: int
    output_len: int                  # ground-truth tokens to generate
    rid: int = field(default_factory=lambda: next(_ids))

    # --- client-visible lifecycle limits (seconds relative to arrival) ---
    ttft_deadline: float | None = None   # abort if no first token by then
    total_deadline: float | None = None  # abort if not finished by then

    # --- runtime state ---
    phase: Phase = Phase.QUEUED
    generated: int = 0
    prefill_layers_done: int = 0     # layer-level interruption progress
    prefill_tokens_done: int = 0     # chunked-prefill progress (tokens landed)
    cached_tokens: int = 0           # leading tokens claimed from the prefix
                                     # cache (counted in prefill_tokens_done)
    location: str | None = None      # instance id currently holding state
    prefill_end: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None
    decode_time_sum: float = 0.0     # accumulated decode step latencies
    evictions: int = 0
    recompute_tokens: int = 0        # wasted prefill tokens from evictions
    cancel_reason: str | None = None  # "client" | "deadline" once CANCELLED

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated

    @property
    def remaining(self) -> int:
        return self.output_len - self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.output_len

    # --- SLO accounting (paper §2.1: TTFT + TPOT per request) ---
    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def avg_tpot(self) -> float | None:
        if self.generated <= 1:
            return None
        return self.decode_time_sum / max(self.generated - 1, 1)

    def violates(self, ttft_slo: float, tpot_slo: float, now: float | None = None) -> bool:
        t = self.ttft()
        if t is None:
            # still waiting: violated once the deadline has passed
            return now is not None and (now - self.arrival) > ttft_slo
        if t > ttft_slo:
            return True
        tp = self.avg_tpot()
        return tp is not None and tp > tpot_slo
