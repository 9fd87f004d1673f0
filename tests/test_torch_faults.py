"""Fault injection in the port's PoolRuntime, in the reference's drained
replay (``tests/test_fault_tolerance.py::_replay``: reduced qwen2.5-7b,
1 strict + 2 relaxed engines, 256 pages of 8, ``chaos_seed`` 7, every
request finished), under three plans: the reference's ``CHAOS_PLAN`` (a
relaxed engine crash, a stuck dispatch, a page leak, flaky migrations), a
strict engine crash (a relaxed engine is promoted) and planned migration
failures (recompute after the retries run out).

* In f32, against the JAX runtime on the same (carried-across) weights:
  ``summary()`` equal key for key and ``finished_signature()`` (every
  finished request with its token stream) equal.
* In bf16, the port against its own clean run: the recovered streams equal
  the fault-free ones.
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
from repro.data import traces as jax_traces
from repro.models.model import build_model as jax_build_model
from repro_torch.cluster.runtime import PoolRuntime, VirtualClock, replay_hw
from repro_torch.configs import get_config
from repro_torch.data import traces as tr
from repro_torch.interop import params_from_jax
from repro_torch.models.model import build_model

torch.set_num_threads(1)

RUNTIME_KW = dict(policy="ooco", n_strict=1, n_relaxed=2, num_pages=256, page_size=8,
                  slo_ttft=1.0, slo_tpot=0.030, chaos_seed=7)
DURATION = 6.0
CHAOS_PLAN = ("crash:relaxed1@2.0,stuck:relaxed0@1.0,"
              "page_leak:relaxed0@0.5:pages=16:duration=1.5,"
              "migration_flaky:p=0.3")
PLANS = [CHAOS_PLAN, "crash:strict0@2.0", "migration_fail:count=3"]


def _traces(mod):
    online = mod.online_trace("ooc", duration=DURATION, mean_qps=1.2, seed=0)
    offline = mod.with_uniform_qps(mod.offline_requests(40, seed=1), 20.0)
    return online, offline


def _run(rt, mod):
    return rt.run(*_traces(mod), duration=DURATION, max_prompt=48, max_output=12, drain=True)


def _port_replay(tc, tm, tp, plan, donor):
    rt = PoolRuntime(tc, clock=VirtualClock(), hw=replay_hw(), device="cpu", model=tm,
                     params=tp, fault_plan=plan, kernels_from=donor[0], **RUNTIME_KW)
    donor[0] = donor[0] or rt.kernel_donor
    return _run(rt, tr), rt


def _check_faults_fired(plan, summary):
    assert summary["online_finished"] == summary["online_requests"] > 0
    assert summary["offline_finished"] == summary["offline_requests"] > 0
    if plan == CHAOS_PLAN:
        assert summary["engine_crashes"] == 1 and summary["recompute_tokens"] > 0
        assert summary["migration_retries"] > 0
    elif plan.startswith("crash:strict0"):
        assert summary["engine_crashes"] == 1 and summary["promotions"] == 1
    else:
        assert summary["migration_retries"] > 0


@pytest.fixture(scope="module")
def f32_models():
    jc = dataclasses.replace(jax_get_config("qwen2.5-7b").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype="float32")
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jm, jp, tc, build_model(tc), tp, [None], [None]


@pytest.mark.parametrize("plan", PLANS)
def test_chaos_replay_matches_jax(f32_models, plan):
    jc, jm, jp, tc, tm, tp, jdonor, tdonor = f32_models
    jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw(), backend="ref", model=jm,
                     params=jp, fault_plan=plan, kernels_from=jdonor[0], **RUNTIME_KW)
    jdonor[0] = jdonor[0] or jrt.kernel_donor
    jsum = _run(jrt, jax_traces)
    tsum, trt = _port_replay(tc, tm, tp, plan, tdonor)
    assert tsum == jsum
    assert trt.finished_signature() == jrt.finished_signature()
    _check_faults_fired(plan, tsum)


@pytest.fixture(scope="module")
def bf16_clean():
    tc = get_config("qwen2.5-7b").reduced()
    tm = build_model(tc)
    tp = tm.init(torch.Generator().manual_seed(0))
    donor = [None]
    summary, rt = _port_replay(tc, tm, tp, None, donor)
    assert summary["online_finished"] == summary["online_requests"]
    assert summary["offline_finished"] == summary["offline_requests"]
    return tc, tm, tp, donor, rt.finished_signature()


@pytest.mark.parametrize("plan", PLANS)
def test_recovered_streams_equal_the_clean_run_in_bf16(bf16_clean, plan):
    tc, tm, tp, donor, clean = bf16_clean
    summary, rt = _port_replay(tc, tm, tp, plan, donor)
    _check_faults_fired(plan, summary)
    assert rt.finished_signature() == clean
