"""The port's training path (``repro_torch.training``, ``launch.train`` and
``Transformer(remat=...)``) against the JAX package's, in f32 on the same
numpy-made inputs and the same weights (the reference's ``init`` carried
across with ``params_from_jax``).

Tolerances: ``lr_at`` 1e-6 relative; ``global_norm`` and one
``adamw_update`` in f32 1e-6, in bf16 within one bf16 ulp (the f32 update
may round to the neighbouring bf16 value); one train step, for reduced
tinyllama, qwen, gemma2 (local/global, softcaps), granite-moe (the aux
loss), phi-3-vision (image embeddings), rwkv6, zamba2 and whisper (frame
embeddings), at 1 and 2 microbatches with remat on and off: loss and
grad-norm 1e-5 relative, and each leaf's update
(new - old) of a step from warm moments within 1e-4 of the reference's in
relative L2 where the update is well conditioned (see the test); a 10-step loss
curve 1e-4 at every step; the key-block attention's gradient against the
full-score one 1e-5. The data pipeline and the checkpoint format must be
equal bit for bit and key for key.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.training import checkpoint as jax_ckpt
from repro.training import data_pipeline as jax_data
from repro.training import optimizer as jax_opt
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import attention
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint, data_pipeline, optimizer
from repro_torch.training.optimizer import AdamWConfig, OptState, tree_leaves
from repro_torch.training.train_loop import make_train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL, STEP_TOL, UPDATE_TOL, CURVE_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-4, 1e-4, 1e-5
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np(x):
    return np.asarray(x, np.float32)


def _jax_leaves(tree):
    """{path: numpy f32} of a JAX pytree of dicts, keyed like the port's."""
    return {tuple(p.key for p in path): _np(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree):
    return {path: leaf.detach().float().numpy() for path, leaf in optimizer.tree_paths(tree)}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_lr_at_matches_jax():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = [optimizer.lr_at(cfg, s).item() for s in range(106)]
    want = [float(jax_opt.lr_at(jcfg, s)) for s in range(106)]
    np.testing.assert_allclose(got, want, rtol=OPT_TOL, atol=0)
    assert got[0] == 0.0 and got[10] == pytest.approx(1e-3)
    assert optimizer.lr_at(cfg, torch.tensor(50, dtype=torch.int32)).dtype == torch.float32


def _tree(rng, shapes, scale=1.0, positive=False):
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _tree(rng, v, scale, positive)
        else:
            a = rng.standard_normal(v).astype(np.float32) * scale
            out[k] = np.abs(a) if positive else a
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of want (2^(e - 7) for 2^e <= |want|)."""
    e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    assert np.all(np.abs(got - want) <= 2.0 ** (e - 7)), \
        float(np.max(np.abs(got - want) / 2.0 ** (e - 7)))


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"), ("bfloat16", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_global_norm_and_adamw_update_match_jax(dtype, moments):
    """One update from step 3 with nonzero moments and a clipping grad
    norm, on a tree with a nested dict and a 1-d leaf, against the
    reference's update run op by op."""
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 48), "blk": {"a": (3, 16, 8), "s": (16,)}}
    p = _tree(rng, shapes, 0.02)
    g = _tree(rng, shapes, 0.5)
    m = _tree(rng, shapes, 0.01)
    v = _tree(rng, shapes, 1e-4, positive=True)
    cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    jcfg = jax_opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jm_dt, tm_dt = jnp.dtype(moments), getattr(torch, moments)
    J = lambda t, dt: _map(lambda a: jnp.asarray(a).astype(dt), t)
    T = lambda t, dt: _map(lambda a: torch.from_numpy(a).to(dt), t)
    jstate = jax_opt.OptState(jnp.asarray(3, jnp.int32), J(m, jm_dt), J(v, jm_dt))
    tstate = OptState(torch.tensor(3, dtype=torch.int32), T(m, tm_dt), T(v, tm_dt))

    jn = float(jax_opt.global_norm(J(g, jdt)))
    tn = optimizer.global_norm(T(g, tdt)).item()
    np.testing.assert_allclose(tn, jn, rtol=OPT_TOL)
    assert tn > cfg.grad_clip   # the clip scales the update

    # eagerly: XLA's fused loops contract a * b + c into FMAs
    jp, js, jstats = jax_opt.adamw_update(jcfg, J(p, jdt), J(g, jdt), jstate)
    tp, ts, tstats = optimizer.adamw_update(cfg, T(p, tdt), T(g, tdt), tstate)
    assert ts.step.item() == int(js.step) == 4
    np.testing.assert_allclose(tstats["grad_norm"].item(), float(jstats["grad_norm"]),
                               rtol=OPT_TOL)
    np.testing.assert_allclose(tstats["lr"].item(), float(jstats["lr"]), rtol=OPT_TOL)
    for got_tree, want_tree, dt in ((tp, jp, tdt), (ts.mu, js.mu, tm_dt), (ts.nu, js.nu, tm_dt)):
        got, want = _port_leaves(got_tree), _jax_leaves(want_tree)
        assert set(got) == set(want)
        for k in want:
            assert tree_leaves(got_tree)[0].dtype == dt
            if dt == torch.float32:
                np.testing.assert_allclose(got[k], want[k], rtol=OPT_TOL,
                                           atol=OPT_TOL * np.abs(want[k]).max())
            else:
                _within_one_bf16_ulp(got[k], want[k])


# ---------------------------------------------------------------------------
# one train step, and a loss curve, against the JAX package
# ---------------------------------------------------------------------------

ARCHS = ["tinyllama-1.1b", "qwen2.5-7b", "gemma2-2b", "granite-moe-3b-a800m",
         "phi-3-vision-4.2b", "rwkv6-1.6b", "zamba2-7b", "whisper-tiny"]


@functools.lru_cache(maxsize=None)
def _models(arch):
    jc = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jm = jax_build_model(jc, remat=False)
    jp = jm.init(jax.random.PRNGKey(len(arch)))
    return jc, tc, jm, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc)


def _batch(cfg, rng, B=4, S=32):
    """tokens, next-token labels (the last one ignored), and a VLM's image
    embeddings or an encoder-decoder's frame embeddings."""
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], -np.ones((B, 1), np.int32)], axis=1)
    out = {"tokens": tokens, "labels": labels}
    if cfg.frontend in ("vision", "audio"):
        out["frontend_embeds"] = rng.standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, microbatches):
    """The reference's first step from fresh moments (batch A), then its
    second (batch B) from the state the first left: the batches, the first
    step's (loss, grad_norm), the state after it (params and OptState as
    numpy), and the second step's new params, loss and grad_norm."""
    jc, _, jm, jp, _ = _models(arch)
    rng = np.random.default_rng(11)
    first, second = _batch(jc, rng), _batch(jc, rng)
    step = jax.jit(jax_make_train_step(jm, jax_opt.AdamWConfig(**OPT),
                                       microbatches=microbatches))
    J = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    p1, s1, m1 = step(jp, jax_opt.init_opt_state(jp), J(first))
    p2, s2, m2 = step(p1, s1, J(second))
    return ((first, second), (float(m1["loss"]), float(m1["grad_norm"])),
            jax.tree.map(np.asarray, (p1, s1)),
            (_jax_leaves(p2), _jax_leaves(s2.nu), float(m2["loss"]), float(m2["grad_norm"])))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, microbatches, remat):
    """The first step from fresh moments: loss and grad-norm. The second,
    from the state the reference's first step left: loss, grad-norm and
    each leaf's update where AdamW's update is a well-conditioned function
    of the gradient. Per element the update is lr * m^ / (sqrt(v^) + eps):
    where sqrt(v^) is near eps (|g| ~ 1e-8, e.g. 10% of reduced qwen's key
    bias, whose gradient is nearly cancelled by the softmax), an f32
    difference in g moves it by up to 2 lr, in the reference against
    itself as well. Those elements (sqrt(v^) < 10 eps in the reference's
    state after the step) are left out of the update's comparison; the
    first step, whose v^ is g^2, is compared by its loss and grad-norm
    only."""
    _, tc, _, _, tp = _models(arch)
    (first, second), (jloss1, jgn1), (jp1, js1), (jnew, jnu, jloss, jgn) = \
        _jax_steps(arch, microbatches)
    T = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    model = build_model(tc, remat=remat)
    ocfg = AdamWConfig(**OPT)
    step = make_train_step(model, ocfg, microbatches=microbatches)
    state = optimizer.init_opt_state(tp)
    _, state1, metrics = step(tp, state, T(first))
    assert state1.step.item() == 1 and state.step.item() == 0
    np.testing.assert_allclose(metrics["loss"].item(), jloss1, rtol=STEP_TOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), jgn1, rtol=STEP_TOL)

    tp1 = params_from_jax(jp1, tc)
    ts1 = OptState(torch.tensor(int(js1.step), dtype=torch.int32),
                   params_from_jax(js1.mu, tc), params_from_jax(js1.nu, tc))
    new, state2, metrics = step(tp1, ts1, T(second))
    assert state2.step.item() == 2
    np.testing.assert_allclose(metrics["loss"].item(), jloss, rtol=STEP_TOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), jgn, rtol=STEP_TOL)
    old, got = _jax_leaves(jp1), _port_leaves(new)
    assert set(got) == set(jnew)
    for k in jnew:
        # v^ = 0: no gradient ever (an unused embedding row), update -lr wd p
        ok = (np.sqrt(jnu[k] / (1 - ocfg.b2 ** 2)) >= 10 * ocfg.eps) | (jnu[k] == 0)
        err = _rel_l2((got[k] - old[k])[ok], (jnew[k] - old[k])[ok])
        assert err < UPDATE_TOL, (k, err)


@pytest.mark.parametrize("arch", ["qwen2.5-7b", "gemma2-2b", "granite-moe-3b-a800m"])
def test_loss_curve_matches_jax(arch):
    """10 steps on ``packed_batches`` from the same weights: the two losses
    agree at every step, and fall."""
    jc, tc, jm, jp, tp = _models(arch)
    batches = list(jax_data.packed_batches(
        jax_data.DataConfig(vocab_size=jc.vocab_size, seq_len=32, batch_size=4), 10))
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jm, jax_opt.AdamWConfig(**ocfg)))
    tstep = make_train_step(build_model(tc), AdamWConfig(**ocfg))
    js, ts = jax_opt.init_opt_state(jp), optimizer.init_opt_state(tp)
    jl, tl = [], []
    for b in batches:
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jmet["loss"]))
        tl.append(tmet["loss"].item())
    np.testing.assert_allclose(tl, jl, rtol=CURVE_TOL, atol=CURVE_TOL)
    assert tl[-1] < tl[0]


def test_key_block_gradient_matches_full_scores(monkeypatch):
    """With NAIVE_TRAIN_MAX_SEQ lowered to 16, reduced gemma2's loss
    (window 64, softcaps) attends by key blocks of 16 (5 blocks at S 70);
    its gradient equals the full-score path's within 1e-5."""
    from repro_torch.models import transformer
    _, tc, _, _, tp = _models("gemma2-2b")
    model = build_model(tc)
    b = _batch(tc, np.random.default_rng(5), B=2, S=70)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}

    def grads():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
        loss = model.loss(optimizer.tree_unflatten(tp, leaves), batch)
        return loss.item(), torch.autograd.grad(loss, leaves)

    full_loss, full = grads()
    calls = []
    blockwise = attention.blockwise_attention
    monkeypatch.setattr(transformer, "NAIVE_TRAIN_MAX_SEQ", 16)
    monkeypatch.setattr(attention, "blockwise_attention",
                        lambda *a, **kw: calls.append(1) or blockwise(*a, kv_block=16, **kw))
    block_loss, blocks = grads()
    assert len(calls) == tc.num_layers * 2   # the forward and remat's recompute
    np.testing.assert_allclose(block_loss, full_loss, rtol=GRAD_TOL)
    for a, b in zip(blocks, full):
        assert _rel_l2(a.numpy(), b.numpy()) < GRAD_TOL


# ---------------------------------------------------------------------------
# data pipeline, checkpoints, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(vocab_size=512, seq_len=64, batch_size=4),
                                dict(vocab_size=2048, seq_len=100, batch_size=3, seed=7,
                                     zipf_a=1.1, doc_len_mean=40)])
def test_packed_batches_bit_equal(kw):
    got = list(data_pipeline.packed_batches(data_pipeline.DataConfig(**kw), 6))
    want = list(jax_data.packed_batches(jax_data.DataConfig(**kw), 6))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def _random_state(rng, jparams):
    mu = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), jparams)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32), jparams)
    return jax_opt.OptState(jnp.asarray(7, jnp.int32), mu, nu)


def test_checkpoints_pass_both_ways(tmp_path):
    """A reference ``save`` (bf16 params, f32 moments) read by the port's
    ``restore``, and the port's ``save`` read by the reference's: same keys,
    every leaf equal, the step restored."""
    jc, tc = jax_get_config("qwen2.5-7b").reduced(), get_config("qwen2.5-7b").reduced()
    jp = jax_build_model(jc, remat=False).init(jax.random.PRNGKey(2))
    jstate = _random_state(np.random.default_rng(0), jp)
    jax_path = str(tmp_path / "jax.npz")
    jax_ckpt.save(jax_path, jp, jstate, step=7)

    like = build_model(tc).init(torch.Generator().manual_seed(0))
    tp, tstate, step = checkpoint.restore(jax_path, like, optimizer.init_opt_state(like))
    assert step == 7 and tstate.step.item() == 7 and tstate.step.dtype == torch.int32
    assert tree_leaves(tp)[0].dtype == torch.bfloat16
    for got, want in ((tp, jp), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        g, w = _port_leaves(got), _jax_leaves(want)
        assert set(g) == set(w) and all(np.array_equal(g[k], w[k]) for k in w)

    port_path = str(tmp_path / "port.npz")
    checkpoint.save(port_path, tp, tstate, step=9)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert set(a.files) == set(b.files)
        assert {"p:embed", "p:layers/attn/wq/w", "o:.step", "o:.mu/embed",
                "o:.nu/layers/mlp/down/w", "meta:step"} <= set(b.files)
        for k in a.files:
            if k != "meta:step":
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    rp, rs, rstep = jax_ckpt.restore(port_path, jp, jax_opt.init_opt_state(jp))
    assert rstep == 9 and int(rs.step) == 7
    for got, want in ((rp, jp), (rs.mu, jstate.mu), (rs.nu, jstate.nu)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(_np(a), _np(b))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(port_path, {**like, "embed": like["embed"][:-1]})


def test_launch_train_on_the_cpu(tmp_path):
    ck = tmp_path / "run" / "ck.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "4",
         "--layers", "2", "--d-model", "64", "--ckpt", str(ck)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step     0  loss " in out.stdout and f"saved {ck}" in out.stdout
    cfg = get_config("tinyllama-1.1b").reduced(layers=2, d_model=64, vocab=2048)
    like = build_model(cfg).init(torch.Generator().manual_seed(0))
    _, state, step = checkpoint.restore(str(ck), like, optimizer.init_opt_state(like))
    assert step == 4 and state.step.item() == 4
