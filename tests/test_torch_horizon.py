"""The port's decode horizons and fused mixed horizons against the JAX
package's, on the reduced qwen2.5-7b in f32 with the JAX weights carried
across; the horizon contracts inside the port (K steps token-identical to K
serial steps, greedy and seeded sampling, one host sync per horizon, pools
written in place); and a virtual-clock replay of the default configuration
(chunked prefill ``auto``, decode horizons ``auto``, prefix cache on) whose
``summary()`` and ``finished_signature()`` equal the reference's.

Greedy streams must be equal across the packages (the reduced model's top-2
margins are far above their f32 differences; see tests/test_torch_engine.py
for the margin rule). Sampled streams are compared inside the port only:
the port draws from torch generators, the reference from threefry keys.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cluster.runtime import PoolRuntime as JaxRuntime
from repro.cluster.runtime import VirtualClock as JaxClock
from repro.cluster.runtime import replay_hw as jax_replay_hw
from repro.configs import get_config as jax_get_config
from repro.core.request import Kind as JKind, Request as JRequest
from repro.data import traces as jax_traces
from repro.engine.engine import ServingEngine as JaxEngine
from repro.models.model import build_model as jax_build_model
from repro_torch.cluster.runtime import PoolRuntime, VirtualClock, replay_hw
from repro_torch.configs import get_config
from repro_torch.core import scheduling as sch
from repro_torch.core.request import Kind, Phase, Request
from repro_torch.data import traces as tr
from repro_torch.engine.engine import SamplingParams, ServingEngine
from repro_torch.interop import params_from_jax
from repro_torch.models.model import build_model

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    jc = dataclasses.replace(jax_get_config("qwen2.5-7b").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype="float32")
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jm, jp, tc, build_model(tc), tp


def _prompts(vocab, seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def _engine(built, prompts, output_len, sampling=None, jax_side=False, **kw):
    """An engine (the port's, or the JAX package's on its ref backend) with
    ``prompts`` prefilled whole."""
    jc, jm, jp, tc, tm, tp = built
    kw = {"num_pages": 64, "page_size": 8, **kw}
    if jax_side:
        eng, R, K = JaxEngine(jm, jp, backend="ref", **kw), JRequest, JKind
    else:
        eng, R, K = ServingEngine(tm, tp, sampling=sampling, device="cpu", **kw), Request, Kind
    reqs = []
    for p in prompts:
        r = R(K.OFFLINE, 0.0, len(p), output_len)
        eng.add_request(r, p)
        eng.prefill(r.rid)
        reqs.append(r)
    return eng, reqs


def _streams(eng, reqs):
    return [eng.token_buf[r.rid].tolist() for r in reqs]


def _pool_ptrs(eng):
    return eng.cache.k_pool.data_ptr(), eng.cache.v_pool.data_ptr()


# ---------------------------------------------------------------------------
# decode horizons (tests/test_decode_horizon.py::TestHorizonParity)
# ---------------------------------------------------------------------------

SAMPLED = SamplingParams(temperature=0.8, top_k=16, seed=3)


@pytest.mark.parametrize("sampling", [None, SAMPLED], ids=["greedy", "sampled"])
def test_k_step_horizon_matches_k_serial_steps(built, sampling):
    tc = built[3]
    prompts = _prompts(tc.vocab_size, 0, (13, 21, 7))
    K = 5
    serial, s_reqs = _engine(built, prompts, 20, sampling)
    for _ in range(K):
        serial.decode_step([r.rid for r in s_reqs])
    eng, reqs = _engine(built, prompts, 20, sampling)
    ptrs, syncs0 = _pool_ptrs(eng), eng.stats.host_syncs
    out = eng.decode_horizon([r.rid for r in reqs], K)
    assert eng.stats.host_syncs == syncs0 + 1          # ONE sync for the horizon
    assert eng.stats.horizon_steps == K
    assert eng.stats.dispatches_by_kind["horizon"] == 1
    assert _pool_ptrs(eng) == ptrs
    assert _streams(eng, reqs) == _streams(serial, s_reqs)
    assert all(len(out[r.rid]) == K for r in reqs)
    assert eng._sample_step == serial._sample_step
    if sampling is None:
        jeng, j_reqs = _engine(built, prompts, 20, jax_side=True)
        jeng.decode_horizon([r.rid for r in j_reqs], K)
        assert _streams(eng, reqs) == _streams(jeng, j_reqs)


def test_finish_mid_horizon_emits_no_extra_tokens(built):
    prompts = _prompts(built[3].vocab_size, 1, (11, 16))
    serial, s_reqs = _engine(built, prompts, 3)
    while any(not r.done for r in s_reqs):
        serial.decode_step([r.rid for r in s_reqs if not r.done])
    eng, reqs = _engine(built, prompts, 3)
    jeng, j_reqs = _engine(built, prompts, 3, jax_side=True)
    out = eng.decode_horizon([r.rid for r in reqs], 8)
    jeng.decode_horizon([r.rid for r in j_reqs], 8)
    for r in reqs:
        assert r.generated == r.output_len == 3 and r.phase == Phase.FINISHED
        assert len(out[r.rid]) == 2                    # masked past max_new_tokens
        assert r.rid not in eng.cache.tables           # pages freed
    assert _streams(eng, reqs) == _streams(serial, s_reqs) == _streams(jeng, j_reqs)
    assert eng.cache.allocator.live_pages == 0


def test_mixed_remaining_lengths_stay_exact(built):
    """A short-output row going inactive mid-horizon writes into the trash
    page, not into live state: the rows still decoding stay exact."""
    prompts = _prompts(built[3].vocab_size, 2, (9, 14))
    serial, s_reqs = _engine(built, prompts, 12)
    eng, reqs = _engine(built, prompts, 12)
    jeng, j_reqs = _engine(built, prompts, 12, jax_side=True)
    for rs in (s_reqs, reqs, j_reqs):
        rs[0].output_len = 2                           # finishes after 1 decode
    while any(not r.done for r in s_reqs):
        serial.decode_step([r.rid for r in s_reqs if not r.done])
    for e, rs in ((eng, reqs), (jeng, j_reqs)):
        while any(not r.done for r in rs):
            e.decode_horizon([r.rid for r in rs if not r.done], 6)
    assert _streams(eng, reqs) == _streams(serial, s_reqs) == _streams(jeng, j_reqs)


def test_page_claim_ahead_across_boundaries(built):
    """A horizon whose writes cross page boundaries claims the pages before
    it runs and stays token-exact."""
    prompts = _prompts(built[3].vocab_size, 3, (8,))      # exactly one full page
    serial, s_reqs = _engine(built, prompts, 20)
    for _ in range(18):
        serial.decode_step([s_reqs[0].rid])
    eng, reqs = _engine(built, prompts, 20)
    jeng, j_reqs = _engine(built, prompts, 20, jax_side=True)
    pages_before = len(eng.cache.tables[reqs[0].rid])
    assert eng.max_horizon_for([reqs[0].rid], 18) == 18
    eng.decode_horizon([reqs[0].rid], 18)              # crosses 2+ page boundaries
    jeng.decode_horizon([j_reqs[0].rid], 18)
    # positions 8..25 written: 26 tokens, three pages more than the prompt's
    assert len(eng.cache.tables[reqs[0].rid]) == pages_before + 3
    assert _streams(eng, reqs) == _streams(serial, s_reqs) == _streams(jeng, j_reqs)


def test_max_horizon_shrinks_to_the_free_pool(built):
    prompts = _prompts(built[3].vocab_size, 4, (8, 8))
    eng, reqs = _engine(built, prompts, 40, num_pages=6)   # 5 usable pages, 2 held
    rids = [r.rid for r in reqs]
    # K=9 would take two more pages per row; K=8 keeps each in one new page
    assert eng.max_horizon_for(rids, 16) == 8
    assert eng.max_horizon_for(rids, 4) == 4


# ---------------------------------------------------------------------------
# mixed horizons (tests/test_mixed_horizon.py::TestMixedHorizonParity)
# ---------------------------------------------------------------------------

DEC = ((13, 24), (21, 2))   # the second row finishes mid-horizon (early exit)


def _setup(built, *, dec_specs, pf_len, pf_out=6, sampling=None, seed=3,
           overrides=(), prefix_cache=False, jax_side=False):
    """An engine with resident decode requests plus one un-prefilled request
    for the chunked path; ``overrides`` are (slot, temperature, top_k), slot
    -1 being the prefill request."""
    jc, jm, jp, tc, tm, tp = built
    if jax_side:
        eng = JaxEngine(jm, jp, num_pages=256, page_size=8, backend="ref",
                        prefix_cache=prefix_cache)
        R, K = JRequest, JKind
    else:
        eng = ServingEngine(tm, tp, num_pages=256, page_size=8, sampling=sampling,
                            prefix_cache=prefix_cache, device="cpu")
        R, K = Request, Kind
    rng = np.random.RandomState(seed)
    reqs = []
    for n, out in dec_specs:
        r = R(K.OFFLINE, 0.0, n, out)
        eng.add_request(r, rng.randint(0, tc.vocab_size, n).tolist())
        eng.prefill(r.rid)
        reqs.append(r)
    pf = R(K.OFFLINE, 0.0, pf_len, pf_out)
    eng.add_request(pf, rng.randint(0, tc.vocab_size, pf_len).tolist())
    for slot, temp, top_k in overrides:
        eng.set_sampling((pf if slot == -1 else reqs[slot]).rid, temp, top_k)
    return eng, reqs, pf


def _drain(eng, reqs):
    live = [r for r in reqs if not r.done]
    while live:
        eng.decode_step([r.rid for r in live])
        live = [r for r in live if not r.done]


def _drive_fused(eng, reqs, pf, chunk, K):
    """Land the prefill through fused horizons, then drain decode. Returns
    the host syncs of each horizon dispatch."""
    per_dispatch = []
    while pf.prefill_tokens_done < pf.prompt_len:
        s0 = eng.stats.host_syncs
        eng.mixed_horizon([r.rid for r in reqs if not r.done], pf.rid, chunk, K)
        per_dispatch.append(eng.stats.host_syncs - s0)
    _drain(eng, reqs + [pf])
    return per_dispatch


def _drive_serial(eng, reqs, pf, chunk, K):
    """The same slices as the fused horizons, one ``mixed_step`` each."""
    while pf.prefill_tokens_done < pf.prompt_len:
        c = min(chunk, pf.prompt_len - pf.prefill_tokens_done)
        for s in sch.split_chunk(c, min(K, c)):
            eng.mixed_step([r.rid for r in reqs if not r.done], pf.rid, s)
    _drain(eng, reqs + [pf])


def test_mixed_horizon_greedy_parity_early_exit_one_sync(built):
    fused, f_reqs, f_pf = _setup(built, dec_specs=DEC, pf_len=29)
    serial, s_reqs, s_pf = _setup(built, dec_specs=DEC, pf_len=29)
    jfused, j_reqs, j_pf = _setup(built, dec_specs=DEC, pf_len=29, jax_side=True)
    ptrs = _pool_ptrs(fused)
    per_dispatch = _drive_fused(fused, f_reqs, f_pf, 13, 4)
    _drive_serial(serial, s_reqs, s_pf, 13, 4)
    _drive_fused(jfused, j_reqs, j_pf, 13, 4)
    assert _streams(fused, f_reqs + [f_pf]) == _streams(serial, s_reqs + [s_pf]) \
        == _streams(jfused, j_reqs + [j_pf])
    assert per_dispatch == [1] * len(per_dispatch)  # ONE sync per horizon
    assert fused.stats.dispatches_by_kind["mixed_horizon"] == len(per_dispatch)
    assert serial.stats.dispatches_by_kind["mixed_horizon"] == 0
    assert fused.stats.host_syncs < serial.stats.host_syncs
    assert fused.stats.prefill_chunks == serial.stats.prefill_chunks
    assert _pool_ptrs(fused) == ptrs


def test_mixed_horizon_sampled_parity(built):
    sp = SamplingParams(temperature=0.9, top_k=7, seed=11)
    ov = ((0, 0.6, 3), (-1, 1.1, 9))   # per-request, the prefill request's too
    fused, f_reqs, f_pf = _setup(built, dec_specs=DEC, pf_len=29, sampling=sp, overrides=ov)
    serial, s_reqs, s_pf = _setup(built, dec_specs=DEC, pf_len=29, sampling=sp, overrides=ov)
    _drive_fused(fused, f_reqs, f_pf, 13, 4)
    _drive_serial(serial, s_reqs, s_pf, 13, 4)
    assert _streams(fused, f_reqs + [f_pf]) == _streams(serial, s_reqs + [s_pf])
    # the fused path reserved exactly the sample steps the serial steps used
    assert fused._sample_step == serial._sample_step


def test_chunk_only_mixed_horizon(built):
    fused, _, f_pf = _setup(built, dec_specs=(), pf_len=23)
    serial, _, s_pf = _setup(built, dec_specs=(), pf_len=23)
    jfused, _, j_pf = _setup(built, dec_specs=(), pf_len=23, jax_side=True)
    per_dispatch = _drive_fused(fused, [], f_pf, 12, 4)
    _drive_serial(serial, [], s_pf, 12, 4)
    _drive_fused(jfused, [], j_pf, 12, 4)
    assert _streams(fused, [f_pf]) == _streams(serial, [s_pf]) == _streams(jfused, [j_pf])
    assert per_dispatch == [1] * len(per_dispatch)


def test_mixed_horizon_pause_resume_zero_recompute(built):
    eng, reqs, pf = _setup(built, dec_specs=((13, 24),), pf_len=30)
    serial, s_reqs, s_pf = _setup(built, dec_specs=((13, 24),), pf_len=30)
    eng.mixed_horizon([reqs[0].rid], pf.rid, 12, 3)    # one horizon
    assert eng.prefill_progress(pf.rid) == 12           # paused mid-prompt
    assert pf.recompute_tokens == 0
    # resume with serial steps over the same slices: a horizon boundary is
    # a clean chunk boundary
    while pf.prefill_tokens_done < pf.prompt_len:
        c = min(12, pf.prompt_len - pf.prefill_tokens_done)
        for s in sch.split_chunk(c, min(3, c)):
            eng.mixed_step([reqs[0].rid], pf.rid, s)
    assert pf.recompute_tokens == 0
    _drain(eng, reqs + [pf])
    _drive_serial(serial, s_reqs, s_pf, 12, 3)
    assert _streams(eng, reqs + [pf]) == _streams(serial, s_reqs + [s_pf])


def test_mixed_horizon_prefix_cache_warm_start(built):
    tc = built[3]
    streams = []
    for jax_side in (False, True):
        eng, _, pf_a = _setup(built, dec_specs=(), pf_len=24, pf_out=4,
                              prefix_cache=True, jax_side=jax_side)
        prompt_a = eng.token_buf[pf_a.rid][: pf_a.prompt_len]
        _drive_fused(eng, [], pf_a, 8, 4)               # completion publishes pages
        prompt_b = prompt_a + np.random.RandomState(9).randint(0, tc.vocab_size, 8).tolist()
        R, K = (JRequest, JKind) if jax_side else (Request, Kind)
        pf_b = R(K.OFFLINE, 0.0, len(prompt_b), 4)
        eng.add_request(pf_b, prompt_b)
        assert eng.claim_prefix(pf_b.rid) == 24         # warm prefix resident
        _drive_fused(eng, [], pf_b, 8, 4)               # only the suffix is cold
        streams.append(eng.token_buf[pf_b.rid][:])
        if not jax_side:
            cold = ServingEngine(built[4], built[5], num_pages=256, page_size=8,
                                 device="cpu")
            pf_c = Request(Kind.OFFLINE, 0.0, len(prompt_b), 4)
            cold.add_request(pf_c, prompt_b)
            _drive_fused(cold, [], pf_c, 8, 4)
            assert cold.token_buf[pf_c.rid][:] == streams[0]   # warm == cold
    assert streams[0] == streams[1]


def test_max_mixed_horizon_sets_the_chunk_aside(built):
    eng, reqs, pf = _setup(built, dec_specs=((8, 40),), pf_len=30)
    assert eng.max_mixed_horizon_for([reqs[0].rid], pf.rid, 13, 16) == 13  # <= chunk
    assert eng.max_mixed_horizon_for([reqs[0].rid], pf.rid, 13, 4) == 4


# ---------------------------------------------------------------------------
# the default configuration, replayed on the virtual clock
# ---------------------------------------------------------------------------

RUNTIME_KW = dict(policy="ooco", n_strict=1, num_pages=256, page_size=8,
                  slo_ttft=2.0, slo_tpot=0.06, seed=0, decode_buckets=(8,),
                  chunk_tokens="auto", decode_horizon="auto", prefix_cache=True)
# (replay calibration, relaxed engines, online qps, offline ooc requests and
# qps, outputs, duration): a light mix on the CPU-scale calibration, and a
# saturating offline backlog on the datacenter one, where fused mixed
# horizons fire
REPLAYS = {"cpu": ("cpu", 1, 2.5, 8, 6.0, 8, 4.0),
           "v5e-backlog": ("v5e", 2, 4.0, 60, 150.0, 24, 1.5)}


def _traces(mod, vocab, online_qps, n_off, off_qps, duration):
    """A bursty online trace and an offline backlog of shared-prefix prompts
    plus ``ooc`` offline requests."""
    online = mod.online_trace("ooc", duration=duration, mean_qps=online_qps, seed=0)
    shared = mod.shared_prefix_requests(
        num_prefixes=2, variants=1, queries=3, prefix_tokens=24, variant_tokens=8,
        query_tokens=8, output_len=6, vocab=vocab, seed=5)
    offline = mod.with_uniform_qps(shared + mod.offline_requests(n_off, seed=1), off_qps)
    return online, offline


@pytest.mark.parametrize("replay", list(REPLAYS))
def test_default_configuration_replay_matches_jax(built, replay):
    jc, jm, jp, tc, tm, tp = built
    hw, n_relaxed, online_qps, n_off, off_qps, max_output, duration = REPLAYS[replay]
    kw = dict(RUNTIME_KW, n_relaxed=n_relaxed)
    run = dict(duration=duration, max_prompt=48, max_output=max_output)
    jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw(hw), backend="ref",
                     model=jm, params=jp, **kw)
    trt = PoolRuntime(tc, clock=VirtualClock(), hw=replay_hw(hw), device="cpu",
                      model=tm, params=tp, **kw)
    jsum = jrt.run(*_traces(jax_traces, jc.vocab_size, online_qps, n_off, off_qps,
                            duration), **run)
    tsum = trt.run(*_traces(tr, tc.vocab_size, online_qps, n_off, off_qps, duration), **run)
    assert tsum == jsum
    assert trt.finished_signature() == jrt.finished_signature()
    assert tsum["online_finished"] == tsum["online_requests"] > 0
    assert tsum["offline_finished"] == tsum["offline_requests"] > 0
    kinds = tsum["dispatches_by_kind"]
    assert kinds["prefill"] > 0 and kinds["horizon"] > 0 and tsum["prefix_hits"] > 0
    if replay == "v5e-backlog":
        assert kinds["mixed"] > 0 and kinds["mixed_horizon"] > 0
    trt.release_retained()
    assert set(trt.live_pages().values()) == {0}
