"""The port's chunked prefill, fused mixed steps and prefix cache against the
JAX package's, on the reduced qwen2.5-7b in f32 with the JAX weights carried
across; plus the contracts that hold inside the port bit for bit (fused vs
serial decode rows, warm vs cold prefix).

Tolerances: attention over a gathered paged pool agrees with the
reference's ``flash_attention_xla`` within 2e-5 in f32 and 2e-2 in bf16 (as
tests/test_torch_kernels.py). Greedy streams must be equal: the reduced
model's top-2 logit margins on these prompts are far above the two
frameworks' f32 differences (the margin rule of tests/test_torch_engine.py
never has to excuse a step here). Examples are fixed, not drawn by
hypothesis.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster.runtime import PoolRuntime as JaxRuntime
from repro.cluster.runtime import VirtualClock as JaxClock
from repro.cluster.runtime import replay_hw as jax_replay_hw
from repro.configs import get_config as jax_get_config
from repro.core.request import Kind as JKind, Phase as JPhase, Request as JRequest
from repro.data import traces as jax_traces
from repro.engine.engine import ServingEngine as JaxEngine
from repro.models.attention import flash_attention_xla
from repro.models.model import build_model as jax_build_model
from repro_torch.cluster.runtime import PoolRuntime, VirtualClock, replay_hw
from repro_torch.configs import get_config
from repro_torch.core.request import Kind, Phase, Request
from repro_torch.data import traces as tr
from repro_torch.engine.engine import ServingEngine
from repro_torch.engine.kv_cache import PagedKVCache
from repro_torch.interop import params_from_jax
from repro_torch.models import attention
from repro_torch.models.model import build_model

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def built():
    jc = dataclasses.replace(jax_get_config("qwen2.5-7b").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype="float32")
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jm, jp, tc, build_model(tc), tp


class Pair:
    """The same engine scenario on both packages: a port engine on the CPU
    and a JAX engine on its ref backend, over the same weights."""

    def __init__(self, built, **kw):
        jc, jm, jp, tc, tm, tp = built
        self.port = ServingEngine(tm, tp, device="cpu", **kw)
        self.jax = JaxEngine(jm, jp, backend="ref", **kw)

    def add(self, prompt, out_len, kind="offline"):
        p = Request(Kind(kind), 0.0, len(prompt), out_len)
        j = JRequest(JKind(kind), 0.0, len(prompt), out_len)
        self.port.add_request(p, list(prompt))
        self.jax.add_request(j, [int(t) for t in prompt])
        return p, j

    def both(self, name, *reqs_args):
        """Call method ``name`` on both engines; ``reqs_args`` mixes request
        pairs (mapped to each side's rid), lists of pairs, and plain values."""
        def side(i):
            out = []
            for a in reqs_args:
                if isinstance(a, tuple) and isinstance(a[0], Request):
                    out.append(a[i].rid)
                elif isinstance(a, list):
                    out.append([x[i].rid for x in a])
                else:
                    out.append(a)
            return out
        getattr(self.port, name)(*side(0))
        getattr(self.jax, name)(*side(1))

    def streams_equal(self, *pairs):
        for p, j in pairs:
            assert self.port.token_buf[p.rid].tolist() == self.jax.token_buf[j.rid].tolist(), p.rid

    def decode_out(self, *pairs):
        live = [x for x in pairs if not x[0].done]
        while live:
            self.both("decode_step", live)
            live = [x for x in live if not x[0].done]


def _prompt(vocab, n, seed):
    return np.random.RandomState(seed).randint(0, vocab, n).tolist()


# ---------------------------------------------------------------------------
# chunk attention over a gathered paged pool
# ---------------------------------------------------------------------------

CHUNK_CASES = [
    # C (bucket), q_offset, kv_lens per row, pages per row (cp), page, Hq, Hkv, hd, softcap
    (8, 21, [26, 29], 4, 8, 2, 1, 128, 0.0),     # reduced qwen2.5-7b heads
    (16, 40, [56, 47], 8, 8, 4, 2, 64, 0.0),     # GQA, ragged rows
    (8, 3, [11, 4], 2, 8, 4, 2, 64, 30.0),       # softcap, a row with one real query
    (32, 96, [128, 100], 8, 16, 28, 4, 128, 0.0),  # qwen2.5-7b full-width heads
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CHUNK_CASES, ids=lambda c: f"C{c[0]}-off{c[1]}-cp{c[3]}")
def test_chunk_attention_over_gathered_pages_matches_flash_attention_xla(case, dtype):
    C, off, kv, cp, page, Hq, Hkv, hd, cap = case
    B, npages = len(kv), 2 * cp + 3
    cfg = dataclasses.replace(get_config("qwen2.5-7b").reduced(), num_heads=Hq,
                              num_kv_heads=Hkv, head_dim=hd, dtype=dtype,
                              attn_logit_softcap=cap)
    rng = np.random.default_rng(C + off)
    cache = PagedKVCache(cfg, npages, page, device="cpu")
    kp = rng.standard_normal(cache.k_pool.shape).astype(np.float32)
    vp = rng.standard_normal(cache.v_pool.shape).astype(np.float32)
    cache.k_pool.copy_(torch.from_numpy(kp))
    cache.v_pool.copy_(torch.from_numpy(vp))
    # each row's pages drawn without replacement, the table padded with the
    # trash page 0 past the pages its kv_lens needs
    perm = rng.permutation(np.arange(1, npages))
    tables = np.zeros((B, cp), np.int64)
    for b, n in enumerate(kv):
        used = -(-n // page)
        tables[b, :used] = perm[b * cp: b * cp + used]
    li = 1
    gathered = [cache.gather_pages(li, torch.from_numpy(t)) for t in tables]
    k = torch.cat([g[0] for g in gathered])
    v = torch.cat([g[1] for g in gathered])
    assert k.shape == (B, cp * page, Hkv, hd) and k.is_contiguous()
    q = rng.standard_normal((B, C, Hq, hd)).astype(np.float32)
    lens = np.asarray(kv, np.int32)
    tdt = getattr(torch, dtype)
    got = attention._attend(torch.from_numpy(q).to(tdt), k.to(tdt), v.to(tdt), cfg,
                            backend="ref", q_offset=off, kv_lens=torch.from_numpy(lens))
    jk = kp[li][tables].reshape(B, cp * page, Hkv, hd)
    jv = vp[li][tables].reshape(B, cp * page, Hkv, hd)
    want = flash_attention_xla(
        *(jnp.asarray(x).astype(dtype) for x in (q, jk, jv)), causal=True,
        q_offset=off, kv_lens=jnp.asarray(lens), logit_softcap=cap)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# the reference's engine cases (tests/test_engine.py, tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [5, 8, 16, 21])
def test_chunked_prefill_matches_jax(built, chunk):
    tc = built[3]
    prompt = _prompt(tc.vocab_size, 21, 5)
    pair = Pair(built, num_pages=64, page_size=8)
    r = pair.add(prompt, 6)
    while r[0].generated == 0:
        pair.both("mixed_step", [], r, chunk)
    assert r[0].prefill_tokens_done == r[1].prefill_tokens_done == len(prompt)
    assert pair.port.stats.prefill_chunks == -(-len(prompt) // chunk)
    assert pair.port.stats.dispatches_by_kind["prefill"] == -(-len(prompt) // chunk)
    assert pair.port.stats.host_syncs == -(-len(prompt) // chunk)
    pair.decode_out(r)
    pair.streams_equal(r)
    # and the whole-prompt path lands the same stream
    whole = ServingEngine(built[4], built[5], num_pages=64, page_size=8, device="cpu")
    w = Request(Kind.OFFLINE, 0.0, len(prompt), 6)
    whole.add_request(w, prompt)
    whole.prefill(w.rid)
    while not w.done:
        whole.decode_step([w.rid])
    assert whole.token_buf[w.rid] == pair.port.token_buf[r[0].rid]


def test_fused_mixed_step_matches_jax(built):
    tc = built[3]
    rng = np.random.RandomState(6)
    pa = rng.randint(0, tc.vocab_size, 17).tolist()
    pb = rng.randint(0, tc.vocab_size, 19).tolist()
    pair = Pair(built, num_pages=64, page_size=8)
    ptrs = (pair.port.cache.k_pool.data_ptr(), pair.port.cache.v_pool.data_ptr())
    ra = pair.add(pa, 8)
    pair.both("prefill", ra)
    rb = pair.add(pb, 4)
    while rb[0].generated == 0:
        pair.both("mixed_step", [ra], rb, 7)
    assert pair.port.stats.mixed_steps == 3    # ceil(19 / 7)
    assert pair.port.stats.dispatches_by_kind["mixed"] == 3
    assert pair.port.stats.host_syncs == 1 + 3
    pair.decode_out(ra, rb)
    pair.streams_equal(ra, rb)
    assert (pair.port.cache.k_pool.data_ptr(), pair.port.cache.v_pool.data_ptr()) == ptrs


def test_abort_mid_chunk_prefill_no_kv_corruption(built):
    tc = built[3]
    rng = np.random.RandomState(7)
    pa = rng.randint(0, tc.vocab_size, 13).tolist()
    pb = rng.randint(0, tc.vocab_size, 24).tolist()
    pair = Pair(built, num_pages=32, page_size=8)
    eng = pair.port
    ra = pair.add(pa, 10)
    pair.both("prefill", ra)
    free0 = eng.cache.allocator.free_pages
    rb = pair.add(pb, 3)
    pair.both("mixed_step", [ra], rb, 8)     # 8 of 24 tokens landed
    assert rb[0].prefill_tokens_done == 8
    pair.both("abort_prefill", rb)
    assert eng.cache.allocator.free_pages == free0
    assert rb[0].recompute_tokens == rb[1].recompute_tokens == 8
    assert rb[0].phase == Phase.QUEUED and rb[0].prefill_tokens_done == 0
    assert rb[1].phase == JPhase.QUEUED
    while rb[0].generated == 0:             # restarts on fresh (recycled) pages
        pair.both("mixed_step", [ra], rb, 8)
    pair.decode_out(ra, rb)
    pair.streams_equal(ra, rb)


def test_chunked_pages_allocated_incrementally(built):
    pair = Pair(built, num_pages=64, page_size=8)
    free0 = pair.port.cache.allocator.free_pages
    r = pair.add(list(range(40)), 2)
    for landed in (1, 2):
        pair.both("mixed_step", [], r, 8)
        assert pair.port.cache.allocator.free_pages == free0 - landed
        assert pair.jax.cache.allocator.free_pages == free0 - landed
    assert pair.port.prefill_progress(r[0].rid) == 16


def test_one_output_request_finishes_at_prefill(built):
    pair = Pair(built, num_pages=64, page_size=8)
    free0 = pair.port.cache.allocator.free_pages
    r = pair.add(_prompt(built[3].vocab_size, 11, 8), 1)
    pair.both("mixed_step", [], r, 16)
    assert r[0].phase == Phase.FINISHED and r[0].generated == 1
    assert pair.port.cache.allocator.free_pages == free0
    pair.streams_equal(r)


def test_claimed_prefix_tokens_bit_identical(built):
    """Warm (claimed prefix) against cold inside the port, bit for bit, and
    both against the JAX engine's streams."""
    tc = built[3]
    rng = np.random.RandomState(11)
    shared = rng.randint(0, tc.vocab_size, 16).tolist()
    pa = shared + rng.randint(0, tc.vocab_size, 8).tolist()
    pb = shared + rng.randint(0, tc.vocab_size, 8).tolist()
    pair = Pair(built, num_pages=64, page_size=8, prefix_cache=True)
    eng = pair.port
    ra = pair.add(pa, 6)
    while ra[0].generated == 0:
        pair.both("mixed_step", [], ra, 8)
    pair.decode_out(ra)
    assert eng.cache.prefix.resident_pages == 3   # 24-token prompt
    rb = pair.add(pb, 6)
    assert eng.claim_prefix(rb[0].rid) == pair.jax.claim_prefix(rb[1].rid) == 16
    assert rb[0].cached_tokens == 16 and rb[0].prefill_tokens_done == 16
    assert eng.claim_prefix(rb[0].rid) == 0       # idempotent: in flight
    while rb[0].generated == 0:
        pair.both("mixed_step", [], rb, 8)        # only the 8-token suffix
    pair.decode_out(rb)
    pair.streams_equal(ra, rb)
    assert (eng.stats.prefix_hits, eng.stats.cached_tokens, eng.stats.shared_pages) \
        == (1, 16, 2)
    # cold: the same prompt in a fresh port engine, chunk for chunk
    cold = ServingEngine(built[4], built[5], num_pages=64, page_size=8, device="cpu")
    rc = Request(Kind.OFFLINE, 0.0, len(pb), 6)
    cold.add_request(rc, pb)
    while rc.generated == 0:
        cold.mixed_step([], rc.rid, 8)
    while not rc.done:
        cold.decode_step([rc.rid])
    assert cold.token_buf[rc.rid] == eng.token_buf[rb[0].rid]


def test_fused_decode_rows_bit_equal_to_decode_step(built):
    """Inside the port, the decode rows of a mixed step compute exactly what
    ``decode_step`` computes from the same state: logits bit for bit."""
    tc, tm, tp = built[3:]
    prompts = [_prompt(tc.vocab_size, n, 20 + n) for n in (9, 17, 30)]
    chunk_prompt = _prompt(tc.vocab_size, 37, 3)
    logits = []
    for fused in (True, False):
        eng = ServingEngine(tm, tp, num_pages=64, page_size=8, decode_buckets=(4,),
                            device="cpu")
        rids = []
        for p in prompts:
            r = Request(Kind.OFFLINE, 0.0, len(p), 8)
            eng.add_request(r, p)
            eng.prefill(r.rid)
            rids.append(r.rid)
        pf = Request(Kind.OFFLINE, 0.0, len(chunk_prompt), 4)
        eng.add_request(pf, chunk_prompt)
        eng.mixed_step(rids, pf.rid, 16)          # the chunk lands in both runs
        seen = []
        orig = tm._logits
        tm._logits = lambda params, x: seen.append(orig(params, x)) or seen[-1]
        try:
            if fused:
                eng.mixed_step(rids, pf.rid, 16)
            else:
                eng.decode_step(rids)
        finally:
            del tm._logits
        logits.append(seen[0])
    assert logits[0].shape == (4, tc.vocab_size)
    assert torch.equal(logits[0], logits[1])


# ---------------------------------------------------------------------------
# the shared-prefix replay (tests/test_prefix_cache.py::TestRuntimeSharedPrefixReplay)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared_prefix_runs(built):
    jc, jm, jp, tc, tm, tp = built
    kw = dict(policy="ooco", n_strict=1, n_relaxed=1, num_pages=128, page_size=8,
              chunk_tokens="auto")
    run = dict(duration=12.0, max_prompt=48, max_output=4, drain=True)

    def offline(mod, vocab):
        reqs = mod.shared_prefix_requests(
            num_prefixes=2, variants=2, queries=3, prefix_tokens=24,
            variant_tokens=8, query_tokens=8, output_len=3, vocab=vocab, seed=5)
        return mod.with_uniform_qps(reqs, 6.0)

    out = {}
    for name, on in (("on", True), ("off", False)):
        rt = PoolRuntime(tc, clock=VirtualClock(), hw=replay_hw(), device="cpu",
                         model=tm, params=tp, prefix_cache=on, **kw)
        out[name] = (rt.run([], offline(tr, tc.vocab_size), **run), rt.finished_signature())
    jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw(), backend="ref",
                     model=jm, params=jp, prefix_cache=True, **kw)
    out["jax"] = (jrt.run([], offline(jax_traces, jc.vocab_size), **run),
                  jrt.finished_signature())
    return out


def test_shared_prefix_replay_streams_equal_with_the_cache_on_and_off(shared_prefix_runs):
    s_on, sig_on = shared_prefix_runs["on"]
    s_off, sig_off = shared_prefix_runs["off"]
    assert sig_on and sig_on == sig_off
    assert s_on["offline_finished"] == s_off["offline_finished"] > 0
    assert s_on["prefix_hits"] > 0 and s_on["cached_tokens"] > 0
    assert s_off["prefix_hits"] == s_off["cached_tokens"] == 0
    assert s_on["prefill_modeled_seconds"] < s_off["prefill_modeled_seconds"]


def test_shared_prefix_replay_matches_jax(shared_prefix_runs):
    s_on, sig_on = shared_prefix_runs["on"]
    s_jax, sig_jax = shared_prefix_runs["jax"]
    assert s_on == s_jax
    assert sig_on == sig_jax
