"""The port's ServingEngine against the JAX package's, on the reduced
qwen2.5-7b (2 layers, d_model 256, G=1, hd=128) and a GQA variant (4 query
heads over 2 KV heads, hd=64), in f32 with the JAX weights carried across;
plus the engine contracts that hold inside the port bit for bit.

Tolerance: logits agree within LOGIT_TOL = 1e-4 absolute (f32 through two
layers; XLA and torch sum in other orders and their sin/cos differ in the
last ulps). Greedy streams must be equal wherever the reference's top-2
logit margin exceeds LOGIT_TOL; each step is checked teacher-forced on the
port's own stream, so a near-tie cannot cascade.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.request import Kind as JKind, Request as JRequest
from repro.engine.engine import ServingEngine as JaxEngine
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.request import Kind, Request
from repro_torch.engine.engine import ServingEngine
from repro_torch.engine.kv_cache import TransferIntegrityError
from repro_torch.interop import params_from_jax
from repro_torch.models.model import build_model

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

LOGIT_TOL = 1e-4
VARIANTS = {"qwen2.5-7b-reduced": {},
            "gqa": {"num_heads": 4, "num_kv_heads": 2, "head_dim": 64}}
PROMPT_LENS = (5, 19, 33)
STEPS = 8
REF_LEN = 64   # teacher-forced reference sequences are padded to this


@pytest.fixture(scope="module", params=list(VARIANTS))
def built(request):
    kw = VARIANTS[request.param]
    jc = dataclasses.replace(jax_get_config("qwen2.5-7b").reduced(), dtype="float32", **kw)
    tc = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype="float32", **kw)
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jm, jp, tc, build_model(tc), tp


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _engine(built, **kw):
    _, _, _, _, tm, tp = built
    kw = {"num_pages": 64, "page_size": 8, "decode_buckets": (4,), "device": "cpu", **kw}
    return ServingEngine(tm, tp, **kw)


def _admit(eng, prompts, out_len=STEPS + 2):
    rids = []
    for p in prompts:
        req = Request(Kind.ONLINE, 0.0, len(p), out_len)
        eng.add_request(req, p)
        rids.append(req.rid)
    return rids


def test_logits_and_greedy_streams_match_jax(built):
    jc, jm, jp, tc, tm, tp = built
    prompts = _prompts(tc.vocab_size)
    # JAX engine on its ref backend
    je = JaxEngine(jm, jp, num_pages=64, page_size=8, decode_buckets=(4,), backend="ref")
    jrids = []
    for p in prompts:
        r = JRequest(JKind.ONLINE, 0.0, len(p), STEPS + 2)
        je.add_request(r, p)
        je.prefill(r.rid)
        jrids.append(r.rid)
    for _ in range(STEPS):
        je.decode_step(jrids)
    # port engine, recording every logits row it samples from
    eng = _engine(built)
    seen = []
    orig = tm._logits
    tm._logits = lambda params, x: seen.append(orig(params, x).clone()) or seen[-1]
    try:
        rids = _admit(eng, prompts)
        for r in rids:
            eng.prefill(r)
        for _ in range(STEPS):
            eng.decode_step(rids)
    finally:
        del tm._logits
    B = len(rids)
    port_logits = [[seen[i][0] for i in range(B)]]           # after each prefill
    port_logits += [[seen[B + t][i] for i in range(B)] for t in range(STEPS)]

    ref_fn = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t, "lengths": n})[0])
    for i, (r, jr, p) in enumerate(zip(rids, jrids, prompts)):
        stream = eng.token_buf[r].tolist()
        jstream = je.token_buf[jr].tolist()
        diverged = False
        for t in range(STEPS + 1):
            n = len(p) + t
            toks = np.zeros((1, REF_LEN), np.int32)
            toks[0, :n] = stream[:n]
            ref = np.asarray(ref_fn(jp, jnp.asarray(toks), jnp.asarray([n], jnp.int32))[0])
            got = port_logits[t][i].numpy()
            np.testing.assert_allclose(got, ref, atol=LOGIT_TOL, rtol=0)
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > LOGIT_TOL:
                assert stream[n] == int(ref.argmax()), (i, t)
                if not diverged:
                    assert jstream[n] == stream[n], (i, t)
            else:
                diverged = True   # past a near-tie the JAX stream may differ


def test_prefill_interrupt_resume_is_bit_equal(built):
    tc = built[3]
    prompt = _prompts(tc.vocab_size, (29,))
    a, b = _engine(built), _engine(built)
    (ra,), (rb,) = _admit(a, prompt), _admit(b, prompt)
    assert a.prefill(ra, should_preempt=lambda: True) == "preempted"
    assert a.requests[ra].prefill_layers_done == 1 and ra in a.partial
    assert a.prefill(ra) == "done"
    assert b.prefill(rb) == "done"
    assert a.cache.tables[ra] == b.cache.tables[rb]
    assert torch.equal(a.cache.k_pool, b.cache.k_pool)
    assert torch.equal(a.cache.v_pool, b.cache.v_pool)
    for _ in range(3):
        a.decode_step([ra])
        b.decode_step([rb])
    assert a.token_buf[ra] == b.token_buf[rb]
    assert a.stats.preemptions == 1


def test_migration_keeps_the_stream_and_rejects_a_corrupt_payload(built):
    tc = built[3]
    prompts = _prompts(tc.vocab_size, (21, 9), seed=3)
    src, dst, ref = _engine(built), _engine(built), _engine(built)
    rids, ref_rids = _admit(src, prompts), _admit(ref, prompts)
    for e, rs in ((src, rids), (ref, ref_rids)):
        for r in rs:
            e.prefill(r)
        e.decode_step(rs)
        e.decode_step(rs)
    mover = rids[0]
    k, v, n, checksum = src.export_for_transfer(mover)
    bad = k.clone()
    bad.view(-1)[0] = bad.view(-1)[0].abs() + 1.0
    req = src.requests[mover]
    with pytest.raises(TransferIntegrityError):
        dst.migrate_in(mover, req, src.token_buf[mover], bad, v, n, checksum=checksum)
    assert mover not in dst.requests and dst.cache.allocator.live_pages == 0
    dst.migrate_in(mover, req, src.token_buf[mover], k, v, n, checksum=checksum)
    src.commit_transfer_out(mover)
    assert mover not in src.cache.tables
    for _ in range(4):
        dst.decode_step([mover])
        src.decode_step(rids[1:])
        ref.decode_step(ref_rids)
    assert dst.token_buf[mover] == ref.token_buf[ref_rids[0]]
    assert src.token_buf[rids[1]] == ref.token_buf[ref_rids[1]]


def test_pools_are_written_in_place(built):
    tc = built[3]
    eng = _engine(built)
    ptrs = (eng.cache.k_pool.data_ptr(), eng.cache.v_pool.data_ptr())
    rids = _admit(eng, _prompts(tc.vocab_size, (7, 12, 3, 30, 16), seed=5))
    for r in rids:
        eng.prefill(r)
    for _ in range(4):   # five rows in a bucket of four: two dispatches a step
        eng.decode_step(rids)
    k, v, n, _ = eng.export_for_transfer(rids[0])
    eng.commit_transfer_out(rids[0])
    eng.migrate_in(rids[0], Request(Kind.ONLINE, 0.0, 7, 9), range(7 + 5), k, v, n)
    assert (eng.cache.k_pool.data_ptr(), eng.cache.v_pool.data_ptr()) == ptrs
    assert eng.cache.k_pool[:, 0].abs().sum() > 0     # padded rows hit trash page 0
    assert eng.stats.host_syncs == len(rids) + 4 * 2


def test_sampling_is_seeded_and_the_unported_paths_raise(built):
    """Seeded sampling repeats itself. The chunked and horizon entry points,
    stubs that raised until the port's third slice, now run on the CPU (their
    parity with the reference is in tests/test_torch_{chunked,horizon}.py)."""
    tc = built[3]
    prompt = _prompts(tc.vocab_size, (11,), seed=9)
    streams = []
    for _ in range(2):
        eng = _engine(built)
        (r,) = _admit(eng, prompt)
        eng.set_sampling(r, temperature=0.9, top_k=8)
        eng.prefill(r)
        for _ in range(4):
            eng.decode_step([r])
        streams.append(eng.token_buf[r].tolist())
    assert streams[0] == streams[1]
    assert all(0 <= t < tc.vocab_size for t in streams[0])
    d, pf = _admit(eng, _prompts(tc.vocab_size, (9, 20), seed=10), out_len=20)
    eng.prefill(d)
    assert eng.max_horizon_for([d], 3) == 3
    assert len(eng.decode_horizon([d], 3)[d]) == 3
    assert eng.max_mixed_horizon_for([d], pf, 8, 4) == 4
    assert list(eng.mixed_step([d], pf, 8)) == [d]
    assert len(eng.mixed_horizon([d], pf, 8, 4)[d]) == 4
    assert eng.prefill_progress(pf) == 16
    assert eng.stats.dispatches_by_kind == {"prefill": 2, "decode": 4, "mixed": 1,
                                            "horizon": 1, "mixed_horizon": 1}
