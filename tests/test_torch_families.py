"""The port's remaining model families (rwkv6, zamba2, whisper) against the
JAX package's, in f32 on the same numpy-made inputs and the same weights (the
reference's ``init`` carried across with ``params_from_jax``), and their
internals (mamba2's chunked SSD, rwkv6's chunked WKV, layernorm, sinusoidal
positions).

Tolerances: prefill logits and caches 1e-4 in f32 (the reference's
blockwise flash and ``lax.scan`` against the port's full-score plain version
and Python loops); decode logits 1e-4, greedy tokens equal over 8 steps;
loss and gradient norm 1e-5 relative, but rwkv6's gradient norm 1e-4: XLA's
CPU exp, log and tanh differ from PyTorch's by one ulp in 10-58% of the
elements, and rwkv6's decays w = exp(-exp(w_log)) lie near 0.9975, where
the chunked WKV's log(w) turns one ulp of w (6e-8) into 2.4e-5 of log(w);
the reference's own two WKV forms (scan, chunked) give gradient norms
2.9e-5 apart, and the port lies 3.7e-5 from the chunked one. Internals at
``tests/test_units.py``'s own tolerances (mamba2 in bf16: y 3e-2, states
1e-3; WKV in f32 1e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers, mamba2 as jmamba2, rwkv6 as jrwkv6
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import attention, layers, mamba2, rwkv6
from repro_torch.models.model import build_model

torch.set_num_threads(1)

MODEL_TOL, LOSS_TOL = 1e-4, 1e-5
GRAD_NORM_TOL = {"rwkv6": 1e-4, "zamba2": LOSS_TOL, "whisper": LOSS_TOL}
STEPS = 8
B = 2

#: name -> (arch, model keyword arguments, prompt length, frames): zamba2's
#: long-context prompt crosses its reduced window of 128, so its shared
#: block's cache is a ring that its decode steps wrap; whisper's rows are
#: ragged in frames and in prompt tokens
FAMILIES = {
    "rwkv6": ("rwkv6-1.6b", {}, 24, 0),
    "zamba2": ("zamba2-7b", {}, 40, 0),
    "zamba2-long": ("zamba2-7b", {"long_context": True}, 140, 0),
    "whisper": ("whisper-tiny", {}, 12, 48),
}


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _models(name):
    arch, kw, S, T = FAMILIES[name]
    jc = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jm, tm = jax_build_model(jc, remat=False, **kw), build_model(tc, **kw)
    jp = jm.init(jax.random.PRNGKey(len(name)))
    return jc, tc, jm, tm, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc), S, T


def _batch(cfg, S, T, rng, ragged=True):
    """tokens (B, S) and next-token labels; whisper's frames (B, T, d); where
    ``ragged``, per-row prompt lengths (and frame lengths)."""
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": tokens,
           "labels": np.concatenate([tokens[:, 1:], -np.ones((B, 1), np.int32)], axis=1)}
    if T:
        out["frontend_embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
        if ragged:
            out["frame_lens"] = np.array([T, T - 18], np.int32)
    if ragged:
        out["lengths"] = np.array([S, S - 5], np.int32)
    return out


def _jax(batch, keys):
    return {k: jnp.asarray(batch[k]) for k in keys if k in batch}


def _torch(batch, keys):
    return {k: torch.from_numpy(batch[k]) for k in keys if k in batch}


INPUTS = ("tokens", "frontend_embeds", "frame_lens", "lengths")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_prefill_and_greedy_decode_match_jax(name):
    """Prefill logits and every cache leaf within 1e-4, then 8 greedy decode
    steps, each fed the reference's token: logits within 1e-4 and the same
    greedy token."""
    jc, tc, jm, tm, jp, tp, S, T = _models(name)
    batch = _batch(jc, S, T, np.random.default_rng(7))
    C = S + STEPS
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, _jax(batch, INPUTS), C)
    tlog, tcache = tm.prefill(tp, _torch(batch, INPUTS), cache_len=C)
    _close(tlog, jlog, MODEL_TOL)
    assert set(tcache) == set(jcache)
    for key, leaf in jcache.items():
        assert tuple(tcache[key].shape) == leaf.shape, key
        _close(tcache[key], leaf, MODEL_TOL)
    jstep = jax.jit(jm.decode_step)
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(STEPS):
        jlog, jcache = jstep(jp, tok, jcache)
        tlog, tcache = tm.decode_step(tp, torch.from_numpy(np.asarray(tok)), tcache)
        _close(tlog, jlog, MODEL_TOL)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
        assert tlog.argmax(-1).tolist() == np.asarray(tok).tolist()
    for key, leaf in jcache.items():
        _close(tcache[key], leaf, MODEL_TOL)


@pytest.mark.parametrize("name", ["rwkv6", "zamba2", "whisper"])
def test_loss_and_gradient_norm_match_jax(name):
    """``loss`` within 1e-5 and the global gradient norm within
    GRAD_NORM_TOL (the port with remat on, under autograd)."""
    jc, tc, jm, tm, jp, tp, S, T = _models(name)
    batch = _batch(jc, S, T, np.random.default_rng(8), ragged=False)
    keys = ("tokens", "labels", "frontend_embeds")
    jloss, jgrad = jax.jit(jax.value_and_grad(jm.loss))(jp, _jax(batch, keys))
    jnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(jgrad))))
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    tloss = tm.loss(tp, _torch(batch, keys))
    grads = torch.autograd.grad(tloss, leaves)
    tnorm = torch.sqrt(sum(g.square().sum() for g in grads)).item()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(tnorm, jnorm, rtol=GRAD_NORM_TOL[name])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b", "whisper-tiny"])
def test_init_and_carried_weights_match_reference_dtypes(arch):
    """The port's own init (used on the card, where no JAX weights exist)
    makes the reference's tree of shapes and dtypes, in bf16 with its f32
    leaves, and ``params_from_jax`` carries every leaf in its dtype."""
    model = build_model(get_config(arch).reduced())
    jp = jax_build_model(jax_get_config(arch).reduced(), remat=False).init(
        jax.random.PRNGKey(0))
    tp = model.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp) == \
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), tp)
    carried = params_from_jax(jax.tree.map(np.asarray, jp), get_config(arch).reduced())
    for (path, leaf), t in zip(jax.tree_util.tree_leaves_with_path(jp), jax.tree.leaves(carried)):
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32))


# ---------------------------------------------------------------------------
# internals, at tests/test_units.py's cases and tolerances
# ---------------------------------------------------------------------------

def _mamba(S, seed):
    cfg = jax_get_config("zamba2-7b").reduced()
    jp = jmamba2.init_mamba(jax.random.PRNGKey(seed), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), get_config("zamba2-7b").reduced())
    u = np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return cfg, jp, tp, jnp.asarray(u, jnp.bfloat16), torch.from_numpy(u).bfloat16()


@pytest.mark.parametrize("S", [16, 48, 37])  # incl. a non-chunk-multiple
def test_mamba_chunked_matches_jax_sequential(S):
    """The port's chunked SSD against the reference's token-by-token oracle
    (and the port's oracle against it), in bf16."""
    cfg, jp, tp, ju, tu = _mamba(S, S)
    tcfg = get_config("zamba2-7b").reduced()
    y2, (c2, s2) = jmamba2.mamba_ref_scan(jp, ju, cfg)
    for y1, (c1, s1) in (mamba2.mamba_prefill(tp, tu, tcfg), mamba2.mamba_ref_scan(tp, tu, tcfg)):
        _close(y1, y2, 3e-2)
        _close(s1, s2, 1e-3)
        _close(c1, c2, 1e-3)


def test_mamba_padding_is_state_transparent():
    """Trailing padding (dt = 0, 19 -> 32) leaves the carried state as the
    reference's unpadded oracle leaves it."""
    cfg, jp, tp, ju, tu = _mamba(19, 2)
    _, (_, s1) = mamba2.mamba_prefill(tp, tu, get_config("zamba2-7b").reduced())
    _, (_, s2) = jmamba2.mamba_ref_scan(jp, ju, cfg)
    _close(s1, s2, 1e-3)


def test_mamba_chunk_256_is_finite_where_the_reference_overflows():
    """At zamba2's own chunk of 256 the reference's chunked SSD takes
    exp(cum_i - cum_j) above the diagonal before masking and turns NaN; the
    port masks first, and matches the reference's token-by-token oracle in
    f32."""
    jc = dataclasses.replace(jax_get_config("zamba2-7b").reduced(), ssm_chunk=256,
                             dtype="float32")
    tc = dataclasses.replace(get_config("zamba2-7b").reduced(), ssm_chunk=256,
                             dtype="float32")
    jp = jmamba2.init_mamba(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    u = np.random.default_rng(0).standard_normal((1, 256, jc.d_model)).astype(np.float32)
    jy, _ = jmamba2.mamba_prefill(jp, jnp.asarray(u), jc)
    assert bool(jnp.isnan(jy).any())
    want, (_, ws) = jmamba2.mamba_ref_scan(jp, jnp.asarray(u), jc)
    got, (_, gs) = mamba2.mamba_prefill(tp, torch.from_numpy(u), tc)
    _close(got, want, MODEL_TOL)
    _close(gs, ws, MODEL_TOL)


@pytest.mark.parametrize("S", [8, 32, 45])  # incl. a non-chunk-multiple
def test_wkv_chunked_matches_jax_scan(S):
    """The port's chunked WKV (chunk 16, as test_units) against the
    reference's per-token scan, and the port's scan against the reference's
    chunked form, in f32."""
    rng = np.random.default_rng(S)
    Bz, H, K = 2, 3, 16
    r, k, v = (rng.standard_normal((Bz, S, H, K)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((Bz, S, H, K)))) * 0.5 + 0.45).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((Bz, H, K, K)) * 0.1).astype(np.float32)
    J, T = (lambda a: jnp.asarray(a)), torch.from_numpy
    jy, js = jrwkv6._wkv_scan(J(r), J(k), J(v), J(w), J(u), J(s0))
    ty, ts = rwkv6._wkv_chunked(T(r), T(k), T(v), T(w), T(u), T(s0), chunk=16)
    _close(ty, jy, 1e-4)
    _close(ts, js, 1e-4)
    jy, js = jrwkv6._wkv_chunked(J(r), J(k), J(v), J(w), J(u), J(s0), chunk=16)
    ty, ts = rwkv6._wkv_scan(T(r), T(k), T(v), T(w), T(u), T(s0))
    _close(ty, jy, 1e-4)
    _close(ts, js, 1e-4)


def test_layernorm_and_sinusoidal_positions_match_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 96)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(96)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(96)).astype(np.float32)}
    for eps in (1e-6, 1e-5):
        _close(layers.layernorm({k: _t(a) for k, a in p.items()}, _t(x), eps),
               jlayers.layernorm({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                                 eps), 1e-5)
    np.testing.assert_array_equal(layers.sinusoidal_positions(1500, 384),
                                  jlayers.sinusoidal_positions(1500, 384))
    ln = layers.init_layernorm(96, torch.bfloat16, "cpu", (3,))
    jln = jax.vmap(lambda _: jlayers.init_layernorm(96, jnp.bfloat16))(jnp.arange(3))
    for key in ("scale", "bias"):
        np.testing.assert_array_equal(ln[key].float().numpy(), np.asarray(jln[key], np.float32))


def test_cross_attention_prefill_matches_jax():
    """``attn_prefill`` with ``cross_kv``: Sq != Skv, not causal, keys past
    ``kv_lens`` masked, no rope; counted under its own launch key."""
    jc = dataclasses.replace(jax_get_config("whisper-tiny").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("whisper-tiny").reduced(), dtype="float32")
    from repro.models import attention as jattn
    jp = jattn.init_attn(jax.random.PRNGKey(4), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    rng = np.random.default_rng(4)
    Sq, Skv, hd = 10, 37, tc.head_dim_
    x = rng.standard_normal((B, Sq, tc.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((B, Skv, tc.num_kv_heads, hd)).astype(np.float32)
            for _ in range(2))
    lens = np.array([Skv, 20], np.int32)
    pos = np.broadcast_to(np.arange(Sq), (B, Sq)).copy()
    jout, _ = jattn.attn_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                                 cross_kv=(jnp.asarray(k), jnp.asarray(v)),
                                 kv_lens=jnp.asarray(lens))
    attention.attn_prefill.flash_launches.clear()
    tout, (tk, _) = attention.attn_prefill(tp, _t(x), torch.from_numpy(pos), tc,
                                           cross_kv=(_t(k), _t(v)),
                                           kv_lens=torch.from_numpy(lens))
    _close(tout, jout, 2e-5)
    assert tk.shape[1] == Skv
    assert list(attention.attn_prefill.flash_launches) == [(Sq, 0, hd, False, Skv)]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b", "whisper-tiny"])
def test_launch_train_takes_the_family(arch, capsys):
    """``launch.train --arch`` trains each family on the CPU (whisper on
    seeded stub frames, which the reference's launcher lacks)."""
    from repro_torch.launch import train
    train.main(["--device", "cpu", "--arch", arch, "--steps", "2", "--layers", "2",
                "--d-model", "64", "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"training {arch}-reduced" in out and "loss " in out
