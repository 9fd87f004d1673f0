"""The port's MoE family against the JAX package's, on the reduced
granite-moe-3b-a800m (E 4, top-2, hd 64) with the JAX weights carried across:

* ``moe_mlp`` at groups 1 and 2, capacity factors 2.0 (the config's: no
  drops at this size) and 0.5 (forced drops), in f32 (tolerance 2e-5) and
  bf16 (2e-2), and with tied router logits (an all-zero token, and two
  experts with equal router columns): ties go to the lower expert index on
  both sides;
* ``moe_mlp`` against the dense plain version ``moe_ref`` where nothing
  drops; ``init_block``'s MoE leaves and their carry across;
* the engine: greedy streams equal to the JAX ``ServingEngine``'s (ref
  backend) through whole-prompt prefill, decode steps over a padded bucket,
  mixed steps with a chunk, and a K=4 decode horizon in which the first row
  runs out of budget (its hidden state then decides later rows' expert
  slots), at both capacity factors; the decode and chunk rows that share a
  slot of the trash page write one row's K/V (a dense engine's rows do not
  meet, and its writes carry no sources);
* a virtual-clock ``PoolRuntime`` replay of the default configuration whose
  ``summary()`` and ``finished_signature()`` equal the reference's.

Every input is fixed (numpy seeds); nothing is drawn by hypothesis.
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
from repro.core.request import Kind as JKind, Request as JRequest
from repro.data import traces as jax_traces
from repro.engine.engine import ServingEngine as JaxEngine
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build_model
from repro_torch.cluster.runtime import PoolRuntime, VirtualClock, replay_hw
from repro_torch.configs import get_config
from repro_torch.core.request import Kind, Request
from repro_torch.data import traces as tr
from repro_torch.engine.engine import ServingEngine
from repro_torch.engine.kv_cache import trash_sources
from repro_torch.interop import params_from_jax
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.models.transformer import init_block

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"


def _cfgs(dtype="float32", factor=None):
    jc, tc = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    kw = {"dtype": dtype}
    if factor is not None:
        kw["moe_capacity_factor"] = factor
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _moe_inputs(jc, tc, B, S, seed, tie=False):
    """One layer's MoE weights from the JAX initialiser and x (B, S, d) from
    numpy, on both sides. ``tie`` zeroes token 0 (all router logits equal)
    and copies expert 1's router column into expert 2's."""
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jc)
    if tie:
        jp["router"] = jp["router"].at[:, 2].set(jp["router"][:, 1])
    x = np.random.RandomState(seed).standard_normal((B, S, jc.d_model)).astype(np.float32)
    if tie:
        x[0, 0] = 0.0
    jx = jnp.asarray(x).astype(jc.jnp_dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tc.torch_dtype)
    return jp, jx, tp, tx


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("factor", [2.0, 0.5], ids=["factor2", "drops"])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_mlp_matches_jax(dtype, tol, factor, groups):
    jc, tc = _cfgs(dtype, factor)
    jp, jx, tp, tx = _moe_inputs(jc, tc, 2, 12, seed=groups)
    jout, jaux = jax_moe.moe_mlp(jp, jx, jc, groups=groups)
    tout, taux = moe.moe_mlp(tp, tx, tc, groups=groups)
    assert tout.dtype == tc.torch_dtype and tout.shape == tx.shape
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if factor == 0.5 and dtype == "float32":
        # drops happened: the dense plain version differs
        dense = moe.moe_ref(tp, tx, tc)
        assert (tout - dense).abs().max() > 1e-3


@pytest.mark.parametrize("factor", [2.0, 0.5], ids=["factor2", "drops"])
def test_tied_router_logits_pick_the_lower_expert(factor):
    """An all-zero token ties every expert; experts 1 and 2 tie everywhere.
    Both packages keep the lower index first, so routing, drops and outputs
    agree."""
    jc, tc = _cfgs("float32", factor)
    jp, jx, tp, tx = _moe_inputs(jc, tc, 1, 16, seed=3, tie=True)
    _, _, eidx = moe._route(tp, tx, tc.experts_per_token)
    assert eidx[0, 0].tolist() == [0, 1]
    assert not ((eidx == 2).any(-1) & ~(eidx == 1).any(-1)).any()  # 2 only with 1
    jout, _ = jax_moe.moe_mlp(jp, jx, jc, groups=1)
    tout, _ = moe.moe_mlp(tp, tx, tc, groups=1)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_mlp_matches_dense_plain_version_without_drops(groups):
    jc, tc = _cfgs("float32", 8.0)
    _, _, tp, tx = _moe_inputs(jc, tc, 2, 8, seed=4)
    out, aux = moe.moe_mlp(tp, tx, tc, groups=groups)
    np.testing.assert_allclose(out.numpy(), moe.moe_ref(tp, tx, tc).numpy(),
                               atol=2e-5, rtol=2e-5)
    assert torch.isfinite(aux)


def test_capacity_and_groups_follow_the_reference():
    jc, tc = _cfgs()
    assert moe._pick_groups(12, 16) == 12 and moe._pick_groups(12, 5) == 4
    assert moe._pick_groups(7, 2) == 1
    for Tg in (1, 3, 8, 64, 512):
        for f in (0.5, 2.0):
            c = dataclasses.replace(tc, moe_capacity_factor=f)
            want = min(max(1, int(np.ceil(Tg * c.experts_per_token / c.num_experts * f))), Tg)
            assert moe.capacity(Tg, c) == want
    full = get_config(ARCH)
    assert moe.capacity(8, full) == 4      # a decode bucket of 8 at full width


def test_init_block_shapes_and_carry_across():
    jc, tc = _cfgs("bfloat16")
    jp = jax_build_model(jc, remat=False).init(jax.random.PRNGKey(0))
    tp = build_model(tc).init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        jax.tree.map(lambda t: tuple(t.shape), tp)
    L, d, E, ff = tc.num_layers, tc.d_model, tc.num_experts, tc.d_ff
    assert {k: tuple(v.shape) for k, v in tp["layers"]["moe"].items()} == {
        "router": (L, d, E), "gate": (L, E, d, ff), "up": (L, E, d, ff),
        "down": (L, E, ff, d)}
    assert "mlp" not in tp["layers"]
    one = init_block(torch.Generator().manual_seed(1), tc)
    assert tuple(one["moe"]["gate"].shape) == (E, d, ff)
    assert abs(tp["layers"]["moe"]["gate"].float().std().item() - 0.02) < 2e-3
    carried = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    for name in ("router", "gate", "up", "down"):
        np.testing.assert_array_equal(
            carried["layers"]["moe"][name].float().numpy(),
            np.asarray(jp["layers"]["moe"][name], np.float32))


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    jp = jax_build_model(jc, remat=False).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tc)


def _script(eng, R, K):
    """The same dispatches on either package's engine: three prompts
    prefilled whole, two decode steps over bucket 4 (one padded row), a
    fourth prompt landed in chunks of 8 by mixed steps beside the three,
    then a K=4 decode horizon in which row 0 has one step left."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 512, n).tolist() for n in (13, 21, 7, 19)]
    outs = (7, 14, 14, 14)
    reqs = []
    for p, o in zip(prompts, outs):
        r = R(K.OFFLINE, 0.0, len(p), o)
        eng.add_request(r, p)
        reqs.append(r)
    rids = [r.rid for r in reqs]
    for rid in rids[:3]:
        eng.prefill(rid)
    for _ in range(2):
        eng.decode_step(rids[:3])
    while reqs[3].generated == 0:
        eng.mixed_step(rids[:3], rids[3], 8)
    assert reqs[0].remaining == 1
    eng.decode_horizon(rids, 4)
    assert reqs[0].done and not reqs[1].done
    eng.decode_step(rids[1:])
    return [list(eng.token_buf[r.rid]) if r.rid in eng.token_buf else None
            for r in reqs], reqs


@pytest.mark.parametrize("factor", [2.0, 0.5], ids=["factor2", "drops"])
def test_engine_streams_match_jax(weights, factor):
    jp, tp = weights
    jc, tc = _cfgs("float32", factor)
    kw = dict(num_pages=64, page_size=8)
    jeng = JaxEngine(jax_build_model(jc, remat=False), jp, backend="ref", **kw)
    teng = ServingEngine(build_model(tc), tp, device="cpu", **kw)
    jstreams, jreqs = _script(jeng, JRequest, JKind)
    tstreams, treqs = _script(teng, Request, Kind)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs] == [7, 11, 11, 6]
    assert tstreams == jstreams
    assert teng.stats.dispatches_by_kind == {
        "prefill": 3, "decode": 3, "mixed": 3, "horizon": 1, "mixed_horizon": 0}


def test_masked_row_attends_as_the_reference(weights):
    """A horizon row past its budget attends over ``positions + 1`` keys read
    through its table, capped at the table's slots, and writes to page 0."""
    jc, tc = _cfgs()
    eng = ServingEngine(build_model(tc), weights[1], num_pages=8, page_size=8, device="cpu")
    tables = torch.tensor([[3, 0], [4, 5]], dtype=torch.int32)
    positions = torch.tensor([8, 15])
    active = torch.tensor([False, True])
    d = eng._decode_rows(torch.zeros(2, dtype=torch.long), positions, tables, None, active)
    assert d.lengths.tolist() == [9, 16] and d.page_ids.tolist() == [0, 5]
    d = eng._decode_rows(torch.zeros(2, dtype=torch.long), torch.tensor([16, 3]),
                         tables, None, torch.tensor([False, True]))
    assert d.lengths.tolist() == [16, 4] and d.page_ids.tolist() == [0, 4]


def _trash_rule(page_ids, offs) -> list[int]:
    """``trash_sources``' rule, row by row: a trash-page row writes the last
    trash-page row's K/V at its slot, every other row its own."""
    p, o = page_ids.tolist(), offs.tolist()
    return [max(j for j in range(len(p)) if p[j] == 0 and o[j] == o[i]) if p[i] == 0 else i
            for i in range(len(p))]


def test_trash_sources_fix_the_slot_whatever_the_write_order():
    """Rows that land on one slot of the trash page in one indexed write all
    write the last such row's K/V, so the slot holds the same values in
    whichever order a device applies the colliding writes; other rows write
    their own."""
    page_ids = torch.tensor([0, 5, 0, 0, 3, 0])
    offs = torch.tensor([0, 1, 0, 2, 1, 0])
    src = trash_sources(page_ids, offs, 8)
    assert src.tolist() == _trash_rule(page_ids, offs) == [5, 1, 5, 3, 4, 5]
    k = torch.randn(6, 2, 4)
    pools = []
    for order in (range(6), reversed(range(6)), [2, 5, 0, 3, 1, 4]):
        pool = torch.zeros(8, 8, 2, 4)
        for i in order:
            pool[page_ids[i], offs[i]] = k[src[i]]
        pools.append(pool)
    assert all(torch.equal(pools[0], p) for p in pools[1:])
    assert torch.equal(pools[0][0, 0], k[5]) and torch.equal(pools[0][0, 2], k[3])
    assert torch.equal(pools[0][5, 1], k[1]) and torch.equal(pools[0][3, 1], k[4])


def _engine_rows(eng, side):
    """One write's rows of ``eng``: ``decode``, a K=4 horizon step with row 0
    masked at position 8 (trash slot 0) beside two padding rows (slot 0 as
    well); ``chunk``, a 17-token chunk in a 32-row bucket, whose 15 padding
    rows share 8 trash slots."""
    if side == "decode":
        tables = torch.tensor([[3, 0], [4, 5], [0, 0], [0, 0]], dtype=torch.int32)
        return eng._decode_rows(torch.zeros(4, dtype=torch.long), torch.tensor([8, 12, 0, 0]),
                                tables, None, torch.tensor([False, True, False, False]))
    r = Request(Kind.OFFLINE, 0.0, 40, 4)
    eng.add_request(r, list(range(1, 41)))
    state, c = eng._chunk_start(r.rid, 17)
    eng.cache.ensure(r.rid, state.done + c)
    (chunk,) = eng._chunk_rows(state, [c])
    return chunk


@pytest.mark.parametrize("side", ["decode", "chunk"])
def test_moe_rows_sharing_a_trash_slot_write_one_rows_kv(weights, side):
    """Under MoE capacity a row's hidden state decides later rows' expert
    slots, and masked rows read the trash page back, so the MoE engine's
    decode rows and chunk rows carry ``trash_sources``, and ``write_layer``
    leaves each shared slot holding the last sharing row's K/V."""
    tc = _cfgs()[1]
    eng = ServingEngine(build_model(tc), weights[1], num_pages=8, page_size=8, device="cpu")
    rows = _engine_rows(eng, side)
    assert rows.src.tolist() == _trash_rule(rows.page_ids, rows.offs)
    if side == "decode":
        assert rows.page_ids.tolist() == [0, 5, 0, 0] and rows.src.tolist() == [3, 1, 3, 3]
    else:
        assert rows.src[:17].tolist() == list(range(17))
        assert rows.src[17:].tolist() == list(range(25, 32)) + list(range(24, 32))
    n = rows.page_ids.shape[0]
    k = torch.randn(n, tc.num_kv_heads, tc.head_dim)
    eng.cache.write_layer(0, rows.page_ids, rows.offs, k, -k, rows.src)
    for i in range(n):
        got = eng.cache.k_pool[0, rows.page_ids[i], rows.offs[i]]
        assert torch.equal(got, k[rows.src[i]])
        assert torch.equal(eng.cache.v_pool[0, rows.page_ids[i], rows.offs[i]], -got)


@pytest.mark.parametrize("side", ["decode", "chunk"])
def test_dense_rows_carry_no_trash_sources(side):
    """A dense model's rows never meet, so its engine's writes stay as they
    were: no sources, no extra gathers on the decode or the chunk side."""
    cfg = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype="float32")
    model = build_model(cfg)
    eng = ServingEngine(model, model.init(torch.Generator().manual_seed(0)), num_pages=8,
                        page_size=8, device="cpu")
    assert _engine_rows(eng, side).src is None


def test_masked_row_past_its_table_matches_jax(weights):
    """One row with 3 steps left in a K=4 horizon: at the masked step its
    position (16) is one page past its 2-page table. The page index is
    clamped (it was read past the table before), and the stream equals the
    JAX engine's."""
    jp, tp = weights
    jc, tc = _cfgs()
    kw = dict(num_pages=16, page_size=8)
    streams = []
    for eng, R, K in ((JaxEngine(jax_build_model(jc, remat=False), jp, backend="ref", **kw),
                       JRequest, JKind),
                      (ServingEngine(build_model(tc), tp, device="cpu", **kw), Request, Kind)):
        r = R(K.OFFLINE, 0.0, 13, 4)
        eng.add_request(r, list(range(1, 14)))
        eng.prefill(r.rid)
        out = eng.decode_horizon([r.rid], 4)
        assert len(out[r.rid]) == 3 and r.done
        streams.append(out[r.rid])
    assert streams[0] == streams[1]


def test_default_configuration_replay_matches_jax(weights):
    """Virtual-clock replay of the default configuration (chunked prefill and
    horizons ``auto``, prefix cache on) on the reduced MoE model."""
    jp, tp = weights
    jc, tc = _cfgs()
    kw = dict(policy="ooco", n_strict=1, n_relaxed=1, num_pages=256, page_size=8,
              slo_ttft=2.0, slo_tpot=0.06, seed=0, decode_buckets=(8,),
              chunk_tokens="auto", decode_horizon="auto", prefix_cache=True)
    run = dict(duration=3.0, max_prompt=48, max_output=8)

    def traces(mod, vocab):
        online = mod.online_trace("ooc", duration=3.0, mean_qps=2.5, seed=0)
        shared = mod.shared_prefix_requests(
            num_prefixes=2, variants=1, queries=2, prefix_tokens=24, variant_tokens=8,
            query_tokens=8, output_len=6, vocab=vocab, seed=5)
        return online, mod.with_uniform_qps(shared + mod.offline_requests(6, seed=1), 6.0)

    jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw("cpu"), backend="ref",
                     model=jax_build_model(jc, remat=False), params=jp, **kw)
    trt = PoolRuntime(tc, clock=VirtualClock(), hw=replay_hw("cpu"), device="cpu",
                      model=build_model(tc), params=tp, **kw)
    jsum = jrt.run(*traces(jax_traces, jc.vocab_size), **run)
    tsum = trt.run(*traces(tr, tc.vocab_size), **run)
    assert tsum == jsum
    assert trt.finished_signature() == jrt.finished_signature()
    assert tsum["online_finished"] == tsum["online_requests"] > 0
    assert tsum["offline_finished"] == tsum["offline_requests"] > 0
    kinds = tsum["dispatches_by_kind"]
    assert kinds["prefill"] > 0 and kinds["decode"] + kinds["horizon"] > 0
    trt.release_retained()
    assert set(trt.live_pages().values()) == {0}
