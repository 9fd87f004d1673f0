"""The port's cluster simulator (``repro_torch.cluster.simulator``) against
the JAX package's, on the CPU.

The simulator is host arithmetic over the scheduler, the perf model and the
traces, so the port's ``run()`` must return the reference's dict key for key
and value for value (floats equal, not close) for every policy on the same
traces. The invariants and the light-load checks of
``tests/test_simulator.py`` run on the port's dicts; its load tests are in
``tests/test_torch_simulator_load.py``.
"""
import math

import pytest

from repro.cluster.simulator import SimConfig as JaxSimConfig, Simulator as JaxSimulator
from repro.configs import get_config as jax_get_config
from repro.core.hardware import TPU_V5E as JAX_TPU_V5E
from repro.data import traces as jax_tr
from repro_torch.cluster.simulator import SimConfig, Simulator
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM, TPU_V5E
from repro_torch.data import traces as tr

POLICIES = ("base_pd", "online_priority", "ooco")


def _sim(policy, hw=TPU_V5E, duration=60.0, seed=0):
    return Simulator(get_config("qwen2.5-7b"), hw, policy,
                     SimConfig(duration=duration, tp=4, seed=seed))


def _light(mod):
    online = mod.online_trace("ooc", duration=60.0, mean_qps=1.0, seed=0)
    offline = mod.with_uniform_qps(mod.offline_requests(200, seed=1), 2.0)
    return online, offline


@pytest.fixture(scope="module")
def light_traces():
    return _light(tr)


@pytest.fixture(scope="module")
def runs():
    """Per policy, the reference's and the port's ``run()`` on the light
    traces, each run once for the module."""
    cache = {}

    def get(policy):
        if policy not in cache:
            ref = JaxSimulator(jax_get_config("qwen2.5-7b"), JAX_TPU_V5E, policy,
                               JaxSimConfig(duration=60, tp=4)).run(*_light(jax_tr))
            cache[policy] = (ref, _sim(policy).run(*_light(tr)))
        return cache[policy]
    return get


@pytest.mark.parametrize("policy", POLICIES)
def test_run_equals_reference(policy, runs):
    ref, port = runs(policy)
    assert port == ref
    assert list(port) == list(ref)


@pytest.mark.parametrize("policy", POLICIES)
def test_invariants(policy, runs, light_traces):
    m = runs(policy)[1]
    assert 0.0 <= m["online_violation_rate"] <= 1.0
    assert m["offline_tokens"] >= 0
    assert m["offline_completed"] * 1 <= m["offline_tokens"] + 1
    assert m["online_requests"] == len(light_traces[0])


def test_no_offline_means_zero_offline_tokens(light_traces):
    online, _ = light_traces
    m = _sim("ooco").run(online, [])
    assert m["offline_tokens"] == 0
    assert m["online_violation_rate"] <= 0.05  # light load: SLO easily met


def test_light_load_all_policies_meet_slo(runs):
    for policy in POLICIES:
        m = runs(policy)[1]
        assert m["online_violation_rate"] <= 0.05, (policy, m)
        assert m["offline_tokens"] > 0


def test_h100_run_is_finite(light_traces):
    """The port's card: one ooco run on the H100 hardware model."""
    m = Simulator(get_config("qwen2.5-7b"), H100_SXM, "ooco",
                  SimConfig(duration=60, tp=1)).run(*light_traces)
    assert m["online_requests"] == len(light_traces[0])
    for k, v in m.items():
        if isinstance(v, float):
            assert math.isfinite(v), (k, v)
    assert m["offline_tokens"] > 0 and m["online_violation_rate"] <= 0.05
