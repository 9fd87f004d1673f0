"""Deterministic fault injection for the pool runtime (chaos replay).

Production brings failures the paper's evaluation never sees: engine
processes crash, KV transfers drop or corrupt on the wire, a dispatch
wedges, an allocator leaks pages. This module turns those into *seeded,
replayable* events so every chaos run is bit-reproducible under the
``VirtualClock`` — the same ``FaultPlan`` + ``chaos_seed`` produce the same
crash rounds, the same flaky-transfer outcomes, the same jittered backoff
delays, and therefore the same metrics JSON and token streams (asserted in
``tests/test_fault_tolerance.py`` and the ``chaos-replay`` CI job).

Fault types (``FaultEvent.kind``):

* ``crash`` — the named engine dies at virtual time ``at``: device KV and
  host bookkeeping are lost; the runtime recovers every in-flight request
  through the recompute path (see ``PoolRuntime._crash_engine``).
* ``stuck`` — the named engine's next dispatch at/after ``at`` hangs; the
  runtime's watchdog aborts it after ``watchdog_mult`` x the
  roofline-predicted round latency (charged to the clock, no tokens
  emitted).
* ``page_leak`` — ``pages`` pool pages of the named engine vanish from the
  free list at ``at`` (allocator leak / fragmentation analogue) and return
  after ``duration`` seconds (0 = never).
* ``migration_fail`` — the next ``count`` KV-transfer attempts at/after
  ``at`` fail in-flight (dropped on the wire, detected before import).
* ``migration_corrupt`` — like ``migration_fail`` but the payload arrives
  bit-flipped; the destination's transfer checksum catches it
  (``kv_cache.verify_transfer``) and the runtime retries.
* ``migration_flaky`` — every transfer attempt fails independently with
  probability ``p``, drawn from the injector's seeded RNG (deterministic
  given the seed and the replay's attempt order).

Plans parse from JSON (a list of event objects, inline or a file path) or
from a compact CLI spec::

    crash:relaxed1@3.0,stuck:relaxed0@2.0,page_leak:strict0@1.5:pages=64:duration=2.0,migration_flaky:p=0.25
"""
from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field

FAULT_KINDS = ("crash", "stuck", "page_leak", "migration_fail",
               "migration_corrupt", "migration_flaky")


@dataclass
class FaultEvent:
    kind: str
    engine: str | None = None   # crash/stuck/page_leak target
    at: float = 0.0             # clock time the event arms
    count: int = 1              # migration_fail/corrupt: attempts to fail
    pages: int = 0              # page_leak: pages withheld
    duration: float = 0.0       # page_leak: seconds until restored (0=never)
    p: float = 0.0              # migration_flaky: per-attempt failure prob

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.kind in ("crash", "stuck", "page_leak") and not self.engine:
            raise ValueError(f"fault {self.kind!r} needs an engine name")
        if self.kind == "page_leak" and self.pages <= 0:
            raise ValueError("page_leak needs pages > 0")
        if self.kind == "migration_flaky" and not 0.0 < self.p <= 1.0:
            raise ValueError("migration_flaky needs 0 < p <= 1")
        if self.at < 0 or self.duration < 0 or self.count < 1:
            raise ValueError(f"bad fault timing fields in {self}")


@dataclass
class FaultPlan:
    events: list[FaultEvent] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: "str | FaultPlan | list | None") -> "FaultPlan | None":
        """Accept a FaultPlan, a list of event dicts, a JSON string, a JSON
        file path, or the compact comma spec. None/'' -> None (no faults)."""
        if spec is None or spec == "":
            return None
        if isinstance(spec, FaultPlan):
            return spec
        if isinstance(spec, list):
            return cls([e if isinstance(e, FaultEvent) else FaultEvent(**e)
                        for e in spec])
        spec = spec.strip()
        if os.path.isfile(spec):
            with open(spec) as f:
                spec = f.read().strip()
        if spec.startswith("["):
            return cls.parse(json.loads(spec))
        return cls([_parse_compact_event(tok)
                    for tok in spec.split(",") if tok.strip()])


def _parse_compact_event(tok: str) -> FaultEvent:
    """``kind[:engine][@t][:k=v...]`` — '@t' may ride any ':'-field."""
    fields = tok.strip().split(":")
    kw: dict = {}

    def take_at(s: str) -> str:
        if "@" in s:
            s, at = s.rsplit("@", 1)
            kw["at"] = float(at)
        return s

    kind = take_at(fields[0])
    for f in fields[1:]:
        f = take_at(f)
        if not f:
            continue
        if "=" in f:
            k, v = f.split("=", 1)
            if k not in ("engine", "kind"):
                kw[k] = float(v) if k in ("at", "duration", "p") else int(v)
            else:
                kw[k] = v
        else:
            kw["engine"] = f
    return FaultEvent(kind=kind, **kw)


class FaultInjector:
    """Stateful, seeded dispatcher of a ``FaultPlan`` over a replay.

    All randomness (flaky-transfer coin flips, backoff jitter) comes from
    one ``random.Random(seed)`` consumed in the deterministic round-loop
    order, so a chaos replay is exactly as reproducible as a clean one.
    The runtime polls the ``*_due`` hooks at round boundaries and the
    ``transfer_*`` hooks per migration attempt; the injector only *decides*
    — the runtime executes (crashes engines, withholds pages, retries)."""

    def __init__(self, plan: FaultPlan, seed: int = 0):
        self.plan = plan
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults_injected = 0
        self._fired: set[int] = set()       # indices of one-shot events done
        self._fail_budget: list = []        # armed migration_fail/corrupt evs
        self._flaky_p = 0.0

    # -- round-boundary hooks ------------------------------------------
    def crashes_due(self, now: float) -> list[str]:
        return self._pop_due("crash", now)

    def leaks_due(self, now: float) -> list[FaultEvent]:
        out = []
        for i, ev in enumerate(self.plan.events):
            if ev.kind == "page_leak" and i not in self._fired and now >= ev.at:
                self._fired.add(i)
                self.faults_injected += 1
                out.append(ev)
        return out

    def dispatch_stuck(self, engine: str, now: float) -> bool:
        """One-shot: the named engine's next dispatch at/after ``at`` hangs."""
        for i, ev in enumerate(self.plan.events):
            if (ev.kind == "stuck" and ev.engine == engine
                    and i not in self._fired and now >= ev.at):
                self._fired.add(i)
                self.faults_injected += 1
                return True
        return False

    def _pop_due(self, kind: str, now: float) -> list[str]:
        out = []
        for i, ev in enumerate(self.plan.events):
            if ev.kind == kind and i not in self._fired and now >= ev.at:
                self._fired.add(i)
                self.faults_injected += 1
                out.append(ev.engine)
        return out

    # -- per-migration-attempt hooks -----------------------------------
    def _arm_transfer_events(self, now: float) -> None:
        for i, ev in enumerate(self.plan.events):
            if i in self._fired or now < ev.at:
                continue
            if ev.kind in ("migration_fail", "migration_corrupt"):
                self._fired.add(i)
                self._fail_budget.append([ev.kind, ev.count])
            elif ev.kind == "migration_flaky":
                self._fired.add(i)
                self._flaky_p = max(self._flaky_p, ev.p)

    def transfer_outcome(self, now: float) -> str:
        """Fate of one KV-transfer attempt: 'ok' | 'fail' | 'corrupt'.
        Planned one-shot failures drain first, then the flaky coin flips
        (seeded — identical outcome sequence across replays)."""
        self._arm_transfer_events(now)
        while self._fail_budget:
            ent = self._fail_budget[0]
            if ent[1] <= 0:
                self._fail_budget.pop(0)
                continue
            ent[1] -= 1
            self.faults_injected += 1
            return "fail" if ent[0] == "migration_fail" else "corrupt"
        if self._flaky_p > 0.0 and self.rng.random() < self._flaky_p:
            self.faults_injected += 1
            return "fail"
        return "ok"

    def backoff_seconds(self, attempt: int, base: float) -> float:
        """Exponential backoff with seeded jitter, charged to the clock."""
        return base * (2.0 ** max(attempt - 1, 0)) * (1.0 + 0.5 * self.rng.random())
