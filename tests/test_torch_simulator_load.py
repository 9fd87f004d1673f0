"""The load tests of ``tests/test_simulator.py`` on the port's simulator
(``repro_torch.cluster.simulator``): heavy offline load breaks base P/D but
not ooco, ooco's online compliance holds as offered offline load grows, and
strict instances only hold decoding requests."""
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.configs import get_config
from repro_torch.core.hardware import TPU_V5E
from repro_torch.data import traces as tr


def _sim(policy, duration=60.0, seed=0):
    return Simulator(get_config("qwen2.5-7b"), TPU_V5E, policy,
                     SimConfig(duration=duration, tp=4, seed=seed))


def test_heavy_offline_breaks_base_pd_not_ooco():
    """The paper's core claim, directionally: under heavy offline load,
    base P/D violates online SLOs while OOCO keeps them."""
    online = tr.online_trace("ooc", duration=90.0, mean_qps=3.0, seed=0)
    offline = tr.with_uniform_qps(tr.offline_requests(4000, seed=1), 24.0)
    base = _sim("base_pd", 90.0).run(online, offline)
    ooco = _sim("ooco", 90.0).run(online, offline)
    assert base["online_violation_rate"] > 0.03
    assert ooco["online_violation_rate"] <= 0.03
    assert ooco["offline_tokens"] > 0


def test_ooco_offline_throughput_monotone_capped():
    """More offered offline load never reduces OOCO's online compliance."""
    online = tr.online_trace("ooc", duration=60.0, mean_qps=2.0, seed=0)
    pool = tr.offline_requests(3000, seed=1)
    for qps in (2.0, 16.0):
        m = _sim("ooco").run(online, tr.with_uniform_qps(pool, qps))
        assert m["online_violation_rate"] <= 0.03


def test_migration_and_eviction_accounting():
    online = tr.online_trace("ooc", duration=90.0, mean_qps=4.0, seed=2)
    offline = tr.with_uniform_qps(tr.offline_requests(2000, seed=3), 16.0)
    sim = _sim("ooco", 90.0)
    sim.run(online, offline)
    # strict instances only ever hold decode-phase requests
    for inst in sim.strict:
        for r in inst.resident.values():
            assert r.phase.value in ("decoding",)
