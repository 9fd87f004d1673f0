"""The port's PoolRuntime against the JAX package's: a deterministic
virtual-clock replay of the same trace, seed and (f32, carried-across)
weights, in CoLocatedServer's configuration (ooco, 1 strict + 1 relaxed,
whole-prompt layer-interruptible prefill, one decode step per dispatch).

The virtual clock advances by the roofline model, not by measurement, so
``summary()`` must be equal key for key, and ``finished_signature()`` (every
finished request with its full token stream) equal as well: greedy streams
on the reduced model have top-2 margins far above the two frameworks' f32
differences (see tests/test_torch_engine.py for the margin rule).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro_torch.core.request import Phase
from repro_torch.data import traces as tr
from repro_torch.engine.engine import ServingEngine
from repro_torch.interop import params_from_jax
from repro_torch.models.model import build_model

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUNTIME_KW = dict(policy="ooco", n_strict=1, n_relaxed=1, num_pages=96,
                  page_size=8, slo_ttft=1.0, slo_tpot=0.03, seed=0,
                  decode_buckets=(8,), chunk_tokens=0, decode_horizon=1)
RUN_KW = dict(duration=4.0, max_prompt=48, max_output=8)


@pytest.fixture(scope="module")
def built():
    jc = dataclasses.replace(jax_get_config("qwen2.5-7b").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype="float32")
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jm, jp, tc, build_model(tc), tp


def _traces(mod):
    """A bursty online trace and a uniform offline backlog, led by an offline
    prompt that an online arrival interrupts mid-prefill (§3.4.1)."""
    online = mod.online_trace("ooc", duration=4.0, mean_qps=2.5, seed=0)
    offline = mod.with_uniform_qps(mod.offline_requests(12, seed=1), 6.0)
    return ([mod.TraceRequest(0.005, 16, 4)] + online,
            [mod.TraceRequest(0.0, 48, 8)] + offline)


@pytest.fixture(scope="module")
def replays(built):
    jc, jm, jp, tc, tm, tp = built
    out = {}
    for plan in (None, "migration_corrupt:count=2"):
        jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw("cpu"), backend="ref",
                         model=jm, params=jp, fault_plan=plan, **RUNTIME_KW)
        trt = PoolRuntime(tc, clock=VirtualClock(), hw=replay_hw("cpu"), device="cpu",
                          model=tm, params=tp, fault_plan=plan, **RUNTIME_KW)
        out[plan] = (jrt, jrt.run(*_traces(jax_traces), **RUN_KW),
                     trt, trt.run(*_traces(tr), **RUN_KW))
    return out


@pytest.mark.parametrize("plan", [None, "migration_corrupt:count=2"])
def test_replay_matches_jax(replays, plan):
    jrt, jsum, trt, tsum = replays[plan]
    assert tsum == jsum
    assert trt.finished_signature() == jrt.finished_signature()
    # the replay exercised the co-located machinery on both sides
    assert tsum["online_finished"] == tsum["online_requests"] > 0
    assert tsum["offline_finished"] == tsum["offline_requests"] > 0
    assert tsum["migrations"] > 0 and tsum["preemptions"] > 0
    assert tsum["dispatches_by_kind"]["prefill"] > 0
    assert tsum["dispatches_by_kind"]["decode"] > 0
    if plan:
        assert tsum["migration_retries"] == 2


def test_lifecycle_partition_and_no_leaked_pages(replays):
    _, _, trt, summary = replays[None]
    rids = [r.rid for r in trt.all_requests]
    assert len(rids) == len(set(rids))
    terminal = {id(r) for r in trt.finished} | {id(r) for r in trt.cancelled} \
        | {id(r) for r in trt.shed} | {id(r) for r in trt.rejected}
    assert len(terminal) == len(trt.finished) + len(trt.cancelled) \
        + len(trt.shed) + len(trt.rejected) == len(trt.all_requests)
    assert all(r.phase is Phase.FINISHED for r in trt.finished)
    trt.release_retained()
    assert trt.live_pages() == {"strict0": 0, "relaxed0": 0}


def test_entry_points_require_a_card_unless_asked_for_cpu(built, monkeypatch):
    tc, tm, tp = built[3:]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoolRuntime(tc, model=tm, params=tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm, tp)
    # the reference's defaults (chunked prefill "auto", prefix cache on)
    # and any horizon run on the CPU when asked for
    rt = PoolRuntime(tc, model=tm, params=tp, device="cpu", decode_horizon=4)
    assert rt.chunked and rt.chunk_budget is None and rt.prefix_cache
    assert rt.horizon_req == 4


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_runs_on_cpu_and_refuses_unported_knobs():
    """The CLI serves the reference's defaults (chunked prefill and horizons
    "auto") and fixed knobs on the CPU, and refuses a malformed knob."""
    for knobs in ((), ("--chunk-tokens", "8", "--decode-horizon", "4")):
        out = _serve("--device", "cpu", "--virtual-clock", "--duration", "5", *knobs)
        assert out.returncode == 0, out.stderr
        summary = json.loads(out.stdout)
        assert summary["clock"] == "virtual" and summary["online_requests"] > 0
        assert summary["online_finished"] == summary["online_requests"]
        assert summary["offline_finished"] == summary["offline_requests"] > 0
        assert summary["chunks"] > 0
    bad = _serve("--device", "cpu", "--virtual-clock", "--chunk-tokens", "-8")
    assert bad.returncode == 2 and "usage" in bad.stderr
