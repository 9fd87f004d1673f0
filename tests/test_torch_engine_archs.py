"""The port's ServingEngine and PoolRuntime against the JAX package's on the
other full-attention archs that both engines serve, beside qwen2.5-7b and
granite-moe-3b-a800m: tinyllama-1.1b kept at G = 8 query heads per KV head
(8/1 heads at hd 64, the paged kernel's largest group), qwen3-8b (qk_norm:
the reference's engine applies q_norm/k_norm by hand, the port's through
``attention._project_qkv``) and phi-3-vision-4.2b at hd 96 (MHA, 2/2 heads
from ``.reduced(d_model=192)``; text prompts, as the engine serves it). Each
is reduced to 2 layers in f32, with the JAX weights carried across.

Tolerance: prefill and decode logits within LOGIT_TOL = 1e-4 absolute of
the JAX model's on the port's own stream (teacher-forced), as
tests/test_torch_engine.py. Greedy streams of ``decode_step``, chunked mixed
steps and K=4 decode and mixed horizons must equal the JAX engine's (the
reduced models' top-2 margins are far above the two frameworks' f32
differences here), and a virtual-clock replay of the default configuration
(chunked prefill and horizons ``auto``, prefix cache on) must print the
JAX runtime's ``summary()`` and ``finished_signature()``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models.model import build_model as jax_build_model
from repro_torch.cluster.runtime import PoolRuntime, VirtualClock, replay_hw
from repro_torch.configs import get_config
from repro_torch.core.request import Kind, Request
from repro_torch.data import traces as tr
from repro_torch.engine.engine import ServingEngine
from repro_torch.interop import params_from_jax
from repro_torch.models.model import build_model

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4
#: arch -> (keywords of ``reduced``, fields replaced after it): the heads
#: that the default ``.reduced()`` would lose, kept
ARCHS = {"tinyllama-1.1b": ({}, {"num_heads": 8, "num_kv_heads": 1, "head_dim": 64}),
         "qwen3-8b": ({}, {}),
         "phi-3-vision-4.2b": ({"d_model": 192}, {})}
HEADS = {"tinyllama-1.1b": (8, 1, 64), "qwen3-8b": (2, 2, 128),
         "phi-3-vision-4.2b": (2, 2, 96)}
PROMPT_LENS = (5, 19, 33)
STEPS = 6
REF_LEN = 64   # teacher-forced reference sequences are padded to this


def _config(get, arch):
    red, kw = ARCHS[arch]
    return dataclasses.replace(get(arch).reduced(**red), dtype="float32", **kw)


@pytest.fixture(scope="module", params=list(ARCHS))
def built(request):
    jc, tc = _config(jax_get_config, request.param), _config(get_config, request.param)
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    return jc, jm, jp, tc, build_model(tc), tp


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _engines(built, **kw):
    """A port engine on the CPU and a JAX engine on its ref backend."""
    jc, jm, jp, tc, tm, tp = built
    kw = {"num_pages": 64, "page_size": 16, "decode_buckets": (4,), **kw}
    return ServingEngine(tm, tp, device="cpu", **kw), JaxEngine(jm, jp, backend="ref", **kw)


def _add(engs, prompt, out_len):
    """The same request on both engines: (port request, JAX request)."""
    p = Request(Kind.OFFLINE, 0.0, len(prompt), out_len)
    j = JRequest(JKind.OFFLINE, 0.0, len(prompt), out_len)
    engs[0].add_request(p, list(prompt))
    engs[1].add_request(j, list(prompt))
    return p, j


def _streams(engs, pairs):
    return ([engs[0].token_buf[p.rid].tolist() for p, _ in pairs],
            [engs[1].token_buf[j.rid].tolist() for _, j in pairs])


def test_config_keeps_the_heads(built):
    jc, tc = built[0], built[3]
    assert (tc.num_heads, tc.num_kv_heads, tc.head_dim) == HEADS[tc.name.removesuffix("-reduced")]
    assert (jc.num_heads, jc.num_kv_heads, jc.head_dim, jc.qk_norm) == \
        (tc.num_heads, tc.num_kv_heads, tc.head_dim, tc.qk_norm)


def test_prefill_and_decode_logits_and_greedy_streams_match_jax(built):
    """Whole-prompt prefill then ``decode_step``s: every logits row the port
    samples from within LOGIT_TOL of the JAX model's prefill over the same
    tokens, and the greedy streams equal the JAX engine's."""
    jc, jm, jp, tc, tm, tp = built
    prompts = _prompts(tc.vocab_size, PROMPT_LENS, 0)
    engs = _engines(built)
    seen = []
    orig = tm._logits
    tm._logits = lambda params, x: seen.append(orig(params, x).clone()) or seen[-1]
    try:
        pairs = [_add(engs, p, STEPS + 2) for p in prompts]
        for p, j in pairs:
            engs[0].prefill(p.rid)
            engs[1].prefill(j.rid)
        for _ in range(STEPS):
            engs[0].decode_step([p.rid for p, _ in pairs])
            engs[1].decode_step([j.rid for _, j in pairs])
    finally:
        del tm._logits
    B = len(pairs)
    port_logits = [[seen[i][0] for i in range(B)]]              # after each prefill
    port_logits += [[seen[B + t][i] for i in range(B)] for t in range(STEPS)]
    ref_fn = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t, "lengths": n})[0])
    port, ref_streams = _streams(engs, pairs)
    assert port == ref_streams
    for i, (stream, p) in enumerate(zip(port, prompts)):
        for t in range(STEPS + 1):
            n = len(p) + t
            toks = np.zeros((1, REF_LEN), np.int32)
            toks[0, :n] = stream[:n]
            ref = np.asarray(ref_fn(jp, jnp.asarray(toks), jnp.asarray([n], jnp.int32))[0])
            np.testing.assert_allclose(port_logits[t][i].numpy(), ref, atol=LOGIT_TOL, rtol=0)
            assert stream[n] == int(ref.argmax()), (i, t)


def test_mixed_steps_and_horizons_match_jax(built):
    """The fused paths on both engines, one scenario: two resident rows; a
    prompt landed in chunks through mixed steps beside them; a K=4 decode
    horizon in which one row reaches its budget after one step (its masked
    steps write the trash page); a prompt landed through K=4 mixed horizons
    beside the live rows; then decode steps to the end. Every stream equals
    the JAX engine's, and one host sync a dispatch."""
    tc = built[3]
    pa, pb, pc, pd = _prompts(tc.vocab_size, (13, 9, 21, 16), 1)
    engs = _engines(built, decode_buckets=(8,))
    port = engs[0]
    # rb decodes beside every chunk, then has one token left for the horizon
    ra, rb = _add(engs, pa, 12), _add(engs, pb, 2 + -(-len(pc) // 8))
    for r in (ra, rb):
        engs[0].prefill(r[0].rid)
        engs[1].prefill(r[1].rid)
    rc = _add(engs, pc, 8)
    while rc[0].generated == 0:
        s0 = port.stats.host_syncs
        for i, eng in enumerate(engs):
            eng.mixed_step([ra[i].rid, rb[i].rid], rc[i].rid, 8)
        assert port.stats.host_syncs == s0 + 1
    assert port.stats.mixed_steps == -(-len(pc) // 8)
    live = [ra, rb, rc]
    s0 = port.stats.host_syncs
    for i, eng in enumerate(engs):
        eng.decode_horizon([r[i].rid for r in live], 4)
    assert port.stats.host_syncs == s0 + 1 and rb[0].done and rb[1].done
    live = [r for r in live if not r[0].done]
    rd = _add(engs, pd, 4)
    while rd[0].prefill_tokens_done < len(pd):
        s0 = port.stats.host_syncs
        for i, eng in enumerate(engs):
            eng.mixed_horizon([r[i].rid for r in live if not r[i].done], rd[i].rid, 8, 4)
        assert port.stats.host_syncs == s0 + 1
    assert port.stats.dispatches_by_kind["mixed_horizon"] > 0
    live = [r for r in (ra, rc, rd) if not r[0].done]
    while live:
        for i, eng in enumerate(engs):
            eng.decode_step([r[i].rid for r in live])
        live = [r for r in live if not r[0].done]
    a, b = _streams(engs, [ra, rb, rc, rd])
    assert a == b
    assert [len(s) for s in a] == [len(pa) + 12, len(pb) + rb[0].output_len, len(pc) + 8,
                                   len(pd) + 4]


# the default configuration on the CPU-scale replay calibration, over a
# bursty online trace and an offline backlog with shared prefixes
RUNTIME_KW = dict(policy="ooco", n_strict=1, n_relaxed=1, num_pages=256, page_size=8,
                  slo_ttft=2.0, slo_tpot=0.06, seed=0, decode_buckets=(8,),
                  chunk_tokens="auto", decode_horizon="auto", prefix_cache=True)
RUN_KW = dict(duration=3.0, max_prompt=48, max_output=8)


def _traces(mod, vocab):
    online = mod.online_trace("ooc", duration=3.0, mean_qps=2.5, seed=0)
    shared = mod.shared_prefix_requests(
        num_prefixes=2, variants=1, queries=2, prefix_tokens=24, variant_tokens=8,
        query_tokens=8, output_len=6, vocab=vocab, seed=5)
    offline = mod.with_uniform_qps(shared + mod.offline_requests(6, seed=1), 6.0)
    return online, offline


def test_default_configuration_replay_matches_jax(built):
    jc, jm, jp, tc, tm, tp = built
    jrt = JaxRuntime(jc, clock=JaxClock(), hw=jax_replay_hw("cpu"), backend="ref",
                     model=jm, params=jp, **RUNTIME_KW)
    trt = PoolRuntime(tc, clock=VirtualClock(), hw=replay_hw("cpu"), device="cpu",
                      model=tm, params=tp, **RUNTIME_KW)
    jsum = jrt.run(*_traces(jax_traces, jc.vocab_size), **RUN_KW)
    tsum = trt.run(*_traces(tr, tc.vocab_size), **RUN_KW)
    assert tsum == jsum
    assert trt.finished_signature() == jrt.finished_signature()
    assert tsum["online_finished"] == tsum["online_requests"] > 0
    assert tsum["offline_finished"] == tsum["offline_requests"] > 0
    kinds = tsum["dispatches_by_kind"]
    assert kinds["prefill"] > 0 and kinds["horizon"] > 0 and tsum["prefix_hits"] > 0
    trt.release_retained()
    assert set(trt.live_pages().values()) == {0}


#: the archs' CLI runs, one after another in one child (``runpy`` runs the
#: module as ``python -m`` does, but the second and third archs reuse the
#: modules the first imported); the child prints {arch: [exit code, stdout,
#: traceback]}, an exception in one arch's run recorded under that arch
SERVE_CODE = """
import contextlib, io, json, runpy, sys, traceback
runs = {}
for arch in sys.argv[1:]:
    sys.argv = ["serve", "--arch", arch, "--device", "cpu", "--virtual-clock", "--duration", "3"]
    out, code, err = io.StringIO(), 0, ""
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module("repro_torch.launch.serve", run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else int(e.code is not None)
        except BaseException:
            code, err = 1, traceback.format_exc()
    runs[arch] = [code, out.getvalue(), err]
print(json.dumps(runs))
"""
#: the child's time limit (the child takes about 14 s in a loaded run of the suite)
SERVE_TIMEOUT = 100


@pytest.fixture(scope="module")
def serve_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", SERVE_CODE, *ARCHS], env=env,
                         capture_output=True, text=True, timeout=SERVE_TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1]), run.stderr


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_cli_on_cpu(arch, serve_runs):
    """``python -m repro_torch.launch.serve`` over the arch's reduced config
    on the CPU in the reference's defaults exits 0 with every request
    finished. The three archs run one after another in one child, bounded
    by SERVE_TIMEOUT, so the second and third start with the modules the
    first imported; each arch's exit code, output and any exception are
    its own."""
    runs, stderr = serve_runs
    code, stdout, err = runs[arch]
    assert code == 0, err or stderr[-3000:]
    summary = json.loads(stdout)
    assert summary["clock"] == "virtual" and summary["online_requests"] > 0
    assert summary["online_finished"] == summary["online_requests"]
    assert summary["offline_finished"] == summary["offline_requests"] > 0
