"""The port's live front end: ``repro_torch.cluster.gateway`` and
``repro_torch.launch.api`` over ``PoolRuntime``, on the reduced qwen2.5-7b in
f32 (the JAX package's weights carried across), with the reference suite's
cases (tests/test_gateway.py):

* ``PoolRuntime.submit`` validation and bounded online admission;
* ``PoolRuntime.cancel`` at every lifecycle stage (queued, mid-chunked-
  prefill, mid-decode, parked in ``place_queue``), freeing every KV page and
  billing no recompute; deadlines under ``VirtualClock``, and a submit/
  cancel/deadline script whose ``summary()`` equals the JAX runtime's;
* interruptible ``WallClock.idle_until``;
* the asyncio ``Gateway`` end to end on a wall clock whose idle slices yield
  instead of sleeping, and one greedy request streamed through it whose
  tokens equal the JAX ``Gateway``'s;
* ``python -m repro_torch.launch.api --device cpu --selftest`` (ephemeral
  port) exits 0 with zero leaked pages; without a card and without
  ``--device cpu`` it raises.

Every input is fixed; no test binds a fixed port or draws random examples.
"""
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.cluster.gateway import Gateway as JaxGateway
from repro.cluster.runtime import PoolRuntime as JaxRuntime
from repro.cluster.runtime import VirtualClock as JaxClock
from repro.cluster.runtime import WallClock as JaxWallClock
from repro.cluster.runtime import replay_hw as jax_replay_hw
from repro.configs import get_config as jax_get_config
from repro.core.request import Kind as JKind, Request as JRequest
from repro.models.model import build_model as jax_build_model
from repro_torch.cluster.gateway import OUTCOMES, Gateway, GatewayClosed, TokenStream
from repro_torch.cluster.runtime import (AdmissionRejected, PoolRuntime,
                                         VirtualClock, WallClock, replay_hw)
from repro_torch.configs import get_config
from repro_torch.core.request import Kind, Phase, Request
from repro_torch.interop import params_from_jax
from repro_torch.launch import api
from repro_torch.models.model import build_model

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SLO_TTFT = 1.0
SLO_TPOT = 0.030


@pytest.fixture(scope="module")
def built():
    jc = dataclasses.replace(jax_get_config("qwen2.5-7b").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype="float32")
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return tc, build_model(tc), tp, [None], (jc, jm, jp)   # [None]: shared kernel donor


def _make_rt(built, *, num_pages=256, clock=None, **kw):
    cfg, model, params, donor, _ = built
    kw.setdefault("policy", "ooco")
    kw.setdefault("n_strict", 1)
    kw.setdefault("n_relaxed", 1)
    kw.setdefault("hw", replay_hw())
    rt = PoolRuntime(cfg, clock=clock or VirtualClock(), device="cpu",
                     num_pages=num_pages, page_size=8, slo_ttft=SLO_TTFT,
                     slo_tpot=SLO_TPOT, model=model, params=params,
                     kernels_from=donor[0], **kw)
    donor[0] = donor[0] or rt.kernel_donor
    return rt


def _submit_online(rt, prompt_len=8, output_len=4, **kw):
    req = Request(Kind.ONLINE, rt.clock.now(), prompt_len, output_len, **kw)
    rt.submit(req, [1] * prompt_len)
    return req


def _step_until(rt, cond, max_steps=200):
    for _ in range(max_steps):
        if cond():
            return True
        rt.step()
    return cond()


def _total_live_pages(rt):
    return sum(rt.live_pages().values())


# ---------------------------------------------------------------------------
# submit validation + backpressure
# ---------------------------------------------------------------------------

class TestSubmitValidation:
    def test_empty_prompt_rejected(self, built):
        rt = _make_rt(built)
        with pytest.raises(ValueError, match="empty token list"):
            rt.submit(Request(Kind.ONLINE, 0.0, 0, 4), [])

    def test_length_mismatch_rejected(self, built):
        rt = _make_rt(built)
        with pytest.raises(ValueError, match="prompt_len=8 but 5 tokens"):
            rt.submit(Request(Kind.ONLINE, 0.0, 8, 4), [1] * 5)

    def test_duplicate_rid_rejected(self, built):
        rt = _make_rt(built)
        req = _submit_online(rt)
        with pytest.raises(ValueError, match="duplicate rid"):
            rt.submit(req, [1] * 8)
        assert len(rt.online_queue) == 1   # first submit intact

    def test_bad_max_online_queue_rejected(self, built):
        with pytest.raises(ValueError, match="max_online_queue"):
            _make_rt(built, max_online_queue=0)


class TestBackpressure:
    def test_online_overflow_raises_and_counts(self, built):
        rt = _make_rt(built, max_online_queue=2)
        a, b = _submit_online(rt), _submit_online(rt)
        with pytest.raises(AdmissionRejected, match="admission queue full"):
            _submit_online(rt)
        assert rt.metrics.rejected_online == 1
        rejected = rt.rejected[0]
        assert rejected.phase is Phase.CANCELLED and rejected.cancel_reason == "rejected"
        assert {e[0].rid for e in rt.online_queue} == {a.rid, b.rid}
        assert rejected.rid not in rt.by_rid
        assert rt.summary()["rejected_online"] == 1

    def test_offline_not_bounded_by_online_queue(self, built):
        rt = _make_rt(built, max_online_queue=1)
        _submit_online(rt)
        rt.submit(Request(Kind.OFFLINE, 0.0, 8, 4), [1] * 8)   # must not raise
        assert len(rt.offline_queue) == 1

    def test_queue_drain_reopens_admission(self, built):
        rt = _make_rt(built, max_online_queue=1)
        first = _submit_online(rt)
        with pytest.raises(AdmissionRejected):
            _submit_online(rt)
        assert _step_until(rt, lambda: not rt.online_queue)
        second = _submit_online(rt)   # space again once scheduled
        assert second.rid in rt.by_rid and first.rid in rt.by_rid


# ---------------------------------------------------------------------------
# cancellation at every lifecycle stage
# ---------------------------------------------------------------------------

class TestCancel:
    def test_unknown_rid(self, built):
        with pytest.raises(ValueError, match="unknown rid"):
            _make_rt(built).cancel(10**9)

    def test_cancel_while_queued(self, built):
        rt = _make_rt(built)
        req = _submit_online(rt)
        assert rt.cancel(req.rid) is req and req.phase is Phase.CANCELLED
        assert req.cancel_reason == "client"
        assert not rt.online_queue and req.rid not in rt.prompts
        assert rt.metrics.cancelled == 1
        assert _total_live_pages(rt) == 0

    def test_double_cancel_and_cancel_after_finish(self, built):
        rt = _make_rt(built)
        req = _submit_online(rt)
        rt.cancel(req.rid)
        with pytest.raises(ValueError, match="already cancelled"):
            rt.cancel(req.rid)
        done = _submit_online(rt)
        assert _step_until(rt, lambda: done.phase is Phase.FINISHED)
        with pytest.raises(ValueError, match="already finished"):
            rt.cancel(done.rid)

    def test_cancel_mid_chunked_prefill(self, built):
        """Cancel between chunk boundaries: the chunk state and its pages
        vanish, no recompute is billed, and the runtime keeps stepping."""
        rt = _make_rt(built, chunk_tokens=16)
        slot = rt.relaxed_pool[0]
        req = Request(Kind.ONLINE, 0.0, 48, 4)
        toks = [1] * 48
        rt.submit(req, toks)
        rt.online_queue.pop()              # simulate chunk admission...
        slot.engine.add_request(req, toks)
        slot.prefilling.append((req, toks))
        slot.engine.mixed_step([], req.rid, 16)   # ...land exactly 1 chunk
        assert slot.engine.prefill_progress(req.rid) == 16
        assert _total_live_pages(rt) > 0
        rt.cancel(req.rid)
        assert req.rid not in slot.engine.chunk_state and not slot.prefilling
        assert req.recompute_tokens == 0
        assert _total_live_pages(rt) == 0
        other = _submit_online(rt)   # the pool is still serviceable
        assert _step_until(rt, lambda: other.phase is Phase.FINISHED)

    def test_cancel_mid_decode(self, built):
        rt = _make_rt(built)
        req = _submit_online(rt, output_len=32)
        assert _step_until(rt, lambda: 0 < req.generated < req.output_len)
        rt.cancel(req.rid)
        assert req.phase is Phase.CANCELLED and req.recompute_tokens == 0
        rt.release_retained()   # drop the prefix tree's own page refs
        assert _total_live_pages(rt) == 0
        assert all(req.rid not in s.engine.requests
                   for s in rt.strict_pool + rt.relaxed_pool)

    def test_cancel_parked_migration(self, built):
        rt = _make_rt(built)
        req = Request(Kind.OFFLINE, 0.0, 8, 4)
        rt.submit(req, [1] * 8)
        entry = rt.offline_queue.pop()
        rt.place_queue.append((entry[0], rt.relaxed_pool[0]))
        rt.cancel(req.rid)
        assert not rt.place_queue and req.phase is Phase.CANCELLED
        rt.step()   # no stale placement resurrects the request
        assert req.rid not in {e[0].rid for e in rt.offline_queue}

    def test_cancelled_excluded_from_slo_denominator(self, built):
        rt = _make_rt(built)
        done, gone = _submit_online(rt), _submit_online(rt)
        rt.cancel(gone.rid)
        assert _step_until(rt, lambda: done.phase is Phase.FINISHED)
        s = rt.summary()
        assert s["online_requests"] == 1 and s["cancelled"] == 1


# ---------------------------------------------------------------------------
# deadlines (deterministic under VirtualClock)
# ---------------------------------------------------------------------------

class TestDeadlines:
    def test_total_deadline_aborts_and_bills_violation(self, built):
        rt = _make_rt(built)
        req = _submit_online(rt, output_len=512, total_deadline=0.05)
        assert _step_until(rt, lambda: req.phase is Phase.CANCELLED)
        assert req.cancel_reason == "deadline" and rt.metrics.deadline_aborts == 1
        rt.release_retained()
        assert _total_live_pages(rt) == 0
        s = rt.summary()
        assert s["deadline_aborts"] == 1 and s["online_requests"] == 1
        assert s["online_slo_attainment"] == 0.0

    def test_ttft_deadline_aborts_queued_request(self, built):
        rt = _make_rt(built)
        req = _submit_online(rt, ttft_deadline=0.01)
        rt.online_queue.clear()            # starved: never scheduled
        rt.clock.advance(0.02)
        rt.step()
        assert req.phase is Phase.CANCELLED and req.cancel_reason == "deadline"

    def test_loose_deadline_finishes_normally(self, built):
        rt = _make_rt(built)
        req = _submit_online(rt, total_deadline=60.0, ttft_deadline=30.0)
        assert _step_until(rt, lambda: req.phase is Phase.FINISHED)
        assert rt.summary()["deadline_aborts"] == 0


def _lifecycle_script(rt, R, K):
    """Submits, a mid-decode cancel, a deadline abort and a queued cancel on
    either package's virtual-clock runtime; returns its summary."""
    reqs = []
    for i, (kind, n, out, dl) in enumerate([
            (K.ONLINE, 12, 6, None), (K.OFFLINE, 20, 8, None),
            (K.ONLINE, 9, 40, None), (K.ONLINE, 16, 512, 0.05),
            (K.OFFLINE, 7, 5, None), (K.ONLINE, 5, 4, None)]):
        r = R(kind, rt.clock.now(), n, out, total_deadline=dl)
        rt.submit(r, [(3 * i + j) % 500 + 1 for j in range(n)])
        reqs.append(r)
    rt.cancel(reqs[5].rid)                                   # still queued
    for _ in range(200):
        if 0 < reqs[2].generated:
            break
        rt.step()
    rt.cancel(reqs[2].rid)                                   # mid-decode
    for _ in range(400):
        if all(r.phase.value in ("finished", "cancelled") for r in reqs):
            break
        rt.step()
    rt.release_retained()
    return rt.summary(), [r.phase.value for r in reqs], rt.live_pages()


def test_lifecycle_summary_matches_jax(built):
    _, _, _, _, (jc, jm, jp) = built
    jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw(), backend="ref",
                     num_pages=256, page_size=8, slo_ttft=SLO_TTFT, slo_tpot=SLO_TPOT,
                     model=jm, params=jp)
    trt = _make_rt(built)
    jsum, jphases, jlive = _lifecycle_script(jrt, JRequest, JKind)
    tsum, tphases, tlive = _lifecycle_script(trt, Request, Kind)
    assert tsum == jsum and tphases == jphases
    assert tphases == ["finished", "finished", "cancelled", "cancelled", "finished",
                       "cancelled"]
    assert tsum["cancelled"] == 2 and tsum["deadline_aborts"] == 1
    assert set(tlive.values()) == set(jlive.values()) == {0}


def _strand_offline_resident(rt, R, K):
    """One offline request prefilled onto the strict slot, its only resident."""
    slot = rt.strict_pool[0]
    req = R(K.OFFLINE, 0.0, 8, 4)
    rt.submit(req, [1] * 8)
    rt.offline_queue.clear()
    slot.engine.add_request(req, [1] * 8)
    slot.engine.prefill(req.rid)
    slot.offline.append(req)
    return req


@pytest.mark.parametrize("clock", ["wall", "virtual"])
def test_strict_slot_never_strands_offline_residents(built, clock):
    """A mix-decoding bound that admits no offline row leaves a strict slot
    that holds only offline residents with nothing to protect, and they
    decode. Wall mode: a measured TPOT over the SLO (a slow host); it moves
    only when a strict slot decodes. Virtual mode: a modelled one-row step
    over ``slo_tpot``, fixed while the row waits. The JAX runtime keeps that
    row waiting (ROADMAP queue 3)."""
    if clock == "wall":
        rt = _wall_rt(built)
        rt.measured_tpot = 100 * SLO_TPOT
    else:
        rt = _make_rt(built)
        rt.slo_tpot = 1e-9
        _, _, _, _, (jc, jm, jp) = built
        jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw(), backend="ref",
                         num_pages=256, page_size=8, slo_ttft=SLO_TTFT, slo_tpot=1e-9,
                         model=jm, params=jp)
        jreq = _strand_offline_resident(jrt, JRequest, JKind)
        for _ in range(4):
            jrt.step()
        assert jreq.generated == 1
    req = _strand_offline_resident(rt, Request, Kind)
    assert rt.step() and req.generated == 2
    assert _step_until(rt, lambda: req.phase is Phase.FINISHED)
    rt.release_retained()
    assert _total_live_pages(rt) == 0


# ---------------------------------------------------------------------------
# evict accounting
# ---------------------------------------------------------------------------

class TestEvictAccounting:
    def test_evict_bills_only_uncached_context(self, built):
        rt = _make_rt(built)
        slot = rt.relaxed_pool[0]
        req = Request(Kind.OFFLINE, 0.0, 16, 8)
        rt.submit(req, [1] * 16)
        rt.offline_queue.clear()
        slot.engine.add_request(req, [1] * 16)
        slot.engine.prefill(req.rid)
        req.generated = 4
        req.cached_tokens = 10           # prefix-cache claim: free to redo
        slot.engine.evict(req.rid)
        assert req.recompute_tokens == req.context_len - 10
        slot.engine.release(req.rid)

    def test_evict_never_bills_negative(self, built):
        rt = _make_rt(built)
        slot = rt.relaxed_pool[0]
        req = Request(Kind.OFFLINE, 0.0, 8, 4)
        rt.submit(req, [1] * 8)
        rt.offline_queue.clear()
        slot.engine.add_request(req, [1] * 8)
        slot.engine.prefill(req.rid)
        req.cached_tokens = req.context_len + 5   # clamp, don't go negative
        slot.engine.evict(req.rid)
        assert req.recompute_tokens == 0
        slot.engine.release(req.rid)


# ---------------------------------------------------------------------------
# interruptible wall-clock idle
# ---------------------------------------------------------------------------

class TestWallClockInterrupt:
    def test_idle_until_wakes_on_interrupt(self):
        ev = threading.Event()
        clock = WallClock(interrupt=ev)
        timer = threading.Timer(0.02, ev.set)
        timer.start()
        t0 = time.perf_counter()
        clock.idle_until(clock.now() + 30.0)   # would block without the event
        timer.join(timeout=5.0)
        assert time.perf_counter() - t0 < 5.0 and not timer.is_alive()

    def test_idle_until_sleeps_in_slices(self, monkeypatch):
        naps = []
        monkeypatch.setattr(time, "sleep", lambda s: naps.append(s))
        clock = WallClock()
        target = clock.now() + 10 * WallClock.IDLE_SLICE
        deadline = time.perf_counter() + 5.0
        while clock.now() < target and time.perf_counter() < deadline:
            clock.idle_until(target)
        assert naps and max(naps) <= WallClock.IDLE_SLICE + 1e-9


# ---------------------------------------------------------------------------
# the asyncio gateway, end to end (wall clock, idle slices that yield)
# ---------------------------------------------------------------------------

@pytest.fixture()
def quiet_sleep(monkeypatch):
    """Idle slices yield instead of sleeping, so the wall-clock cases are
    fast; correctness must not depend on real sleep durations."""
    monkeypatch.setattr(WallClock, "IDLE_SLICE", 0.0005)
    monkeypatch.setattr(JaxWallClock, "IDLE_SLICE", 0.0005)


def _wall_rt(built, **kw):
    return _make_rt(built, clock=WallClock(), hw=None, **kw)


class TestGateway:
    def test_rejects_virtual_clock(self, built):
        with pytest.raises(ValueError, match="WallClock"):
            Gateway(_make_rt(built))

    def test_submit_stream_finish_and_drain(self, built, quiet_sleep):
        async def run():
            rt = _wall_rt(built)
            gw = Gateway(rt)
            await gw.start()
            stream = await gw.submit(list(range(1, 9)), max_new_tokens=6)
            assert isinstance(stream, TokenStream)
            toks = [t async for t in stream]
            assert stream.outcome == "finished" and len(toks) == 6
            assert toks == rt.generated_tokens(stream.rid)
            report = await gw.drain(timeout=30.0)
            assert all(v == 0 for v in report["leaked_pages"].values())
            assert report["summary"]["online_finished"] == 1
            with pytest.raises(GatewayClosed):
                await gw.submit([1, 2, 3])
        asyncio.run(run())

    def test_cancel_while_queued_closes_stream(self, built, quiet_sleep):
        async def run():
            rt = _wall_rt(built)
            gw = Gateway(rt)
            # admit before the runtime thread exists: the request is still
            # queued when the cancel lands
            gw._loop = asyncio.get_running_loop()
            gw._accepting = True
            stream = await gw.submit(list(range(1, 9)), max_new_tokens=8)
            assert len(rt.online_queue) == 1
            assert await stream.cancel()
            toks = [t async for t in stream]
            assert toks == [] and stream.outcome == "cancelled"
            assert not rt.online_queue
            await gw.start()
            report = await gw.drain(timeout=30.0)
            assert all(v == 0 for v in report["leaked_pages"].values())
            assert report["summary"]["cancelled"] == 1
        asyncio.run(run())

    def test_cancel_mid_stream_and_health(self, built, quiet_sleep):
        async def run():
            rt = _wall_rt(built)
            gw = Gateway(rt)
            await gw.start()
            health = gw.health()
            assert health["status"] == "ok" and health["accepting"]
            stream = await gw.submit(list(range(1, 9)), max_new_tokens=64)
            async for _ in stream:
                break                      # first token, then walk away
            cancelled = await stream.cancel()
            async for _ in stream:         # drain to the terminal event
                pass
            assert stream.outcome == ("cancelled" if cancelled else "finished")
            assert await gw.cancel(stream.rid) is False   # idempotent
            report = await gw.drain(timeout=30.0)
            assert all(v == 0 for v in report["leaked_pages"].values())
            assert not gw.health()["accepting"]
        asyncio.run(run())

    def test_concurrent_streams_partition_and_zero_leak(self, built, quiet_sleep):
        async def run():
            rt = _wall_rt(built, max_online_queue=64)
            gw = Gateway(rt)
            await gw.start()

            async def client(i):
                kw = {"max_new_tokens": 4}
                if i % 4 == 1:
                    kw["total_deadline"] = 120.0
                kind = Kind.OFFLINE if i % 4 == 2 else Kind.ONLINE
                stream = await gw.submit([i + 1] * 8, kind=kind, **kw)
                if i % 4 == 3 and await stream.cancel():
                    return stream.rid, "cancelled", []
                toks = [t async for t in stream]
                return stream.rid, stream.outcome, toks

            done = await asyncio.gather(*(client(i) for i in range(12)))
            outcomes = [o for _, o, _ in done]
            assert all(o in ("finished", "cancelled") for o in outcomes)
            for rid, o, toks in done:
                if o == "finished":
                    assert toks == rt.generated_tokens(rid) and len(toks) == 4
            report = await gw.drain(timeout=60.0)
            s = report["summary"]
            assert all(v == 0 for v in report["leaked_pages"].values())
            n_cancel = outcomes.count("cancelled")
            assert s["cancelled"] == n_cancel
            assert s["online_finished"] + s["offline_finished"] == 12 - n_cancel
            assert s["deadline_aborts"] == 0
            # every request ends in exactly one terminal state
            terminal = [r.rid for r in rt.finished] + [r.rid for r in rt.cancelled]
            assert sorted(terminal) == sorted(rid for rid, _, _ in done)
        asyncio.run(run())

    def test_runtime_crash_surfaces_as_error_outcome(self, built, quiet_sleep):
        async def run():
            rt = _wall_rt(built)
            gw = Gateway(rt)
            gw._loop = asyncio.get_running_loop()
            gw._accepting = True
            stream = await gw.submit(list(range(1, 9)), max_new_tokens=4)

            def boom():
                raise RuntimeError("injected scheduler bug")
            rt.step = boom
            await gw.start()
            toks = [t async for t in stream]
            assert toks == [] and stream.outcome == "error" and "error" in OUTCOMES
            assert gw.health()["status"] == "dead"
            assert "injected scheduler bug" in gw.health()["gateway_error"]
            await gw.stop()
        asyncio.run(run())


def test_submit_and_cancel_land_while_the_runtime_is_busy(built, quiet_sleep):
    """The runtime thread takes the lock again after every round; clients
    waiting for it are served first, so a submit and a cancel land while a
    long request is still decoding instead of after it."""
    async def run():
        rt = _wall_rt(built)
        gw = Gateway(rt)
        await gw.start()
        busy = await gw.submit(list(range(1, 9)), kind=Kind.OFFLINE, max_new_tokens=400)
        async for _ in busy:
            break
        late = await gw.submit(list(range(2, 10)), max_new_tokens=400)
        assert not busy.req.done
        async for _ in late:
            break
        assert await late.cancel() and await busy.cancel()
        for st in (busy, late):
            toks = [t async for t in st]
            assert st.outcome == "cancelled" and len(toks) < 399
        report = await gw.drain(timeout=30.0)
        assert all(v == 0 for v in report["leaked_pages"].values())
        assert report["summary"]["cancelled"] == 2
    asyncio.run(run())


def test_greedy_stream_matches_jax_gateway(built, quiet_sleep):
    """One greedy request streamed through each package's Gateway."""
    _, _, _, _, (jc, jm, jp) = built

    async def stream_one(gw_cls, rt, R_kind):
        gw = gw_cls(rt)
        await gw.start()
        stream = await gw.submit(list(range(3, 17)), kind=R_kind, max_new_tokens=6)
        toks = [t async for t in stream]
        report = await gw.drain(timeout=60.0)
        return toks, stream.outcome, report["leaked_pages"]

    jrt = JaxRuntime(jc, clock=JaxWallClock(), backend="ref", num_pages=256, page_size=8,
                     slo_ttft=SLO_TTFT, slo_tpot=SLO_TPOT, model=jm, params=jp)
    jtoks, jout, jleak = asyncio.run(stream_one(JaxGateway, jrt, JKind.ONLINE))
    ttoks, tout, tleak = asyncio.run(stream_one(Gateway, _wall_rt(built), Kind.ONLINE))
    assert tout == jout == "finished" and len(ttoks) == 6
    assert ttoks == jtoks
    assert set(tleak.values()) == set(jleak.values()) == {0}


# ---------------------------------------------------------------------------
# the HTTP entry point
# ---------------------------------------------------------------------------

def test_api_selftest_on_cpu_exits_clean():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.api", "--device", "cpu",
                          "--selftest"], env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "selftest: generate/disconnect/healthz OK" in out.stdout
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["leaked_pages"] == {"strict0": 0, "relaxed0": 0}


def test_api_requires_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.main(["--selftest"])
