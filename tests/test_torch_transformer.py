"""The port's whole-model ``Transformer`` API (prefill, init_cache,
decode_step, loss) and its attention pieces against the JAX package's, in
f32 on the same numpy-made inputs and the same weights (the reference's
``init`` carried across with ``params_from_jax``).

Families: dense (qwen2.5-7b; gemma2-2b with its local/global windows,
softcaps, sandwich norms, GeGLU and embedding scale, at hd 128 and 256), MoE
(granite-moe-3b-a800m) and VLM (phi-3-vision-4.2b with image embeddings, at
hd 128 and 96), each reduced.

Tolerances, all f32: attention pieces 2e-5 (XLA and torch sum in other
orders); prefill logits and caches 1e-4 (the reference's blockwise flash
against the port's full-score plain version, through two layers); loss 1e-5,
with full scores and by key blocks.
Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_flash_ref
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.models import attention
from repro_torch.models.model import build_model
from repro_torch.models.rwkv_model import RWKVModel
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.zamba2 import Zamba2Model

torch.set_num_threads(1)

ATTN_TOL, MODEL_TOL, LOSS_TOL = 2e-5, 1e-4, 1e-5
STEPS = 8


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# attention pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,window,cap", [(96, 0, 0.0), (96, 40, 30.0), (256, 0, 50.0),
                                           (256, 48, 50.0)])
def test_flash_plain_matches_jax_ref_at_wide_heads(hd, window, cap):
    """The plain flash version at phi-3-vision's hd 96 and gemma2's hd 256,
    with a window, a softcap, a q_offset and ragged kv_lens (a row whose last
    queries see no key)."""
    rng = np.random.default_rng(hd + window)
    B, Hq, Hkv, Sq, Skv, off = 2, 4, 2, 40, 72, 32
    q = rng.standard_normal((B, Hq, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, hd)).astype(np.float32)
    lens = np.array([Skv, 20], np.int32)
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=Skv,
                         q_offset=off, window=window, logit_softcap=cap,
                         kv_lens=jnp.asarray(lens))
    got = flash_prefill_ref(_t(q), _t(k), _t(v), kv_len=Skv, q_offset=off, window=window,
                            logit_softcap=cap, kv_lens=torch.from_numpy(lens))
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (12, 50.0)])
def test_naive_and_decode_attention_match_jax(window, cap):
    rng = np.random.default_rng(3 + window)
    B, S, Hq, Hkv, hd, C = 2, 30, 4, 2, 32, 16
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    lens = np.array([S, 11], np.int32)
    want = jattn.naive_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=window, kv_lens=jnp.asarray(lens),
                                     logit_softcap=cap)
    got = attention.naive_attention(_t(q), _t(k), _t(v), window=window,
                                    kv_lens=torch.from_numpy(lens), logit_softcap=cap)
    _close(got, want, ATTN_TOL)
    # decode over a ring of C slots: one row not yet wrapped, one wrapped
    lengths = np.array([9, 40], np.int32)
    qd = q[:, 0]
    want = jattn.decode_attention_xla(jnp.asarray(qd), jnp.asarray(k[:, :C]),
                                      jnp.asarray(v[:, :C]), jnp.asarray(lengths),
                                      logit_softcap=cap)
    got = attention.decode_attention(_t(qd), _t(k[:, :C]), _t(v[:, :C]),
                                     torch.from_numpy(lengths), logit_softcap=cap)
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("window,cap,off", [(0, 0.0, 0), (12, 50.0, 0), (0, 30.0, (5, 9))])
def test_blockwise_attention_matches_jax(window, cap, off):
    """The loss's attention past 8192 tokens, by key blocks (here of 8, the
    last one partial), against the JAX ``flash_attention_xla``: with a
    window, a softcap, a per-row q_offset and ragged kv_lens."""
    rng = np.random.default_rng(7 + window)
    B, Sq, Skv, Hq, Hkv, hd = 2, 20, 30, 4, 2, 32
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    lens = np.array([Skv, 17], np.int32)
    offs = np.asarray(off, np.int32)
    want = jattn.flash_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     window=window, q_offset=jnp.asarray(offs),
                                     kv_lens=jnp.asarray(lens), logit_softcap=cap,
                                     kv_block=8)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), window=window,
                                        q_offset=torch.from_numpy(offs),
                                        kv_lens=torch.from_numpy(lens), logit_softcap=cap,
                                        kv_block=8)
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize("S,C", [(10, 16), (16, 16), (37, 16)])
def test_cache_writers_match_jax(S, C):
    """write_prefill_cache in both branches (S <= C pads, S > C keeps the
    last C tokens at ring slots pos % C), then write_decode_cache over steps
    that wrap the ring."""
    rng = np.random.default_rng(S)
    B, Hkv, hd = 2, 2, 8
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    jk, jv = jattn.write_prefill_cache(jnp.asarray(k), jnp.asarray(v), C)
    tk, tv = attention.write_prefill_cache(_t(k), _t(v), C)
    _close(tk, jk, 0.0)
    _close(tv, jv, 0.0)
    pos = np.array([S, S - 3], np.int32)
    for _ in range(C + 3):
        kn = rng.standard_normal((B, 1, Hkv, hd)).astype(np.float32)
        vn = rng.standard_normal((B, 1, Hkv, hd)).astype(np.float32)
        jk, jv = jattn.write_decode_cache(jk, jv, jnp.asarray(kn), jnp.asarray(vn),
                                          jnp.asarray(pos))
        attention.write_decode_cache(tk, tv, _t(kn), _t(vn), torch.from_numpy(pos).long())
        pos = pos + 1
    _close(tk, jk, 0.0)
    _close(tv, jv, 0.0)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

#: (arch, reduced() arguments, prompt length): gemma2's prompts cross its
#: reduced window of 64, so its local caches take the S > C branch and its
#: decode steps wrap their rings
MODELS = {
    "gemma2-hd128": ("gemma2-2b", {}, 70),
    "gemma2-hd256": ("gemma2-2b", {"d_model": 512}, 70),
    "phi3v-hd128": ("phi-3-vision-4.2b", {}, 20),
    "phi3v-hd96": ("phi-3-vision-4.2b", {"d_model": 192}, 20),
    "qwen2.5-7b": ("qwen2.5-7b", {}, 24),
    "granite-moe": ("granite-moe-3b-a800m", {}, 24),
}


def _models(name):
    arch, kw, S = MODELS[name]
    jc = dataclasses.replace(jax_get_config(arch).reduced(**kw), dtype="float32")
    tc = dataclasses.replace(get_config(arch).reduced(**kw), dtype="float32")
    jm = jax_build_model(jc, remat=False)
    tm = build_model(tc, backend="cuda")   # the kernel route: its plain version on the CPU
    jp = jm.init(jax.random.PRNGKey(len(name)))
    return jc, tc, jm, tm, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc), S


def _batch(cfg, S, rng, B=2):
    """tokens, and a VLM's image embeddings; lengths over the whole input
    (image tokens included), the second row shorter."""
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": tokens}
    T = 0
    if cfg.frontend == "vision":
        T = cfg.num_frontend_tokens
        out["frontend_embeds"] = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    out["lengths"] = np.array([T + S, T + S - 3], np.int32)
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", list(MODELS))
def test_transformer_matches_jax(name):
    """prefill (logits and every cache leaf), init_cache's shapes, STEPS
    greedy decode steps (gemma2's past its window: the local rings wrap) and
    loss, against the JAX Transformer."""
    jc, tc, jm, tm, jp, tp, S = _models(name)
    rng = np.random.default_rng(1)
    batch = _batch(jc, S, rng)
    C = int(batch["lengths"][0]) + STEPS
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, _jax_batch(batch), C)
    tlog, tcache = tm.prefill(tp, _torch_batch(batch), cache_len=C)
    _close(tlog, jlog, MODEL_TOL)
    assert set(tcache) == set(jcache)
    for key, leaf in jcache.items():
        assert tuple(tcache[key].shape) == leaf.shape, key
        _close(tcache[key], leaf, MODEL_TOL)
    zero = tm.init_cache(2, C, prefilled_len=5, device="cpu")
    assert {k: tuple(v.shape) for k, v in zero.items()} == \
        {k: v.shape for k, v in jm.init_cache(2, C, 5).items()}
    assert zero["pos"].tolist() == [5, 5]

    jstep = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
    ttok = tlog.argmax(-1)
    for _ in range(STEPS):
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jlog, jcache = jstep(jp, jtok, jcache)
        tlog, tcache = tm.decode_step(tp, ttok, tcache)
        _close(tlog, jlog, MODEL_TOL)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = tlog.argmax(-1)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()

    labels = rng.integers(0, jc.vocab_size, batch["tokens"].shape).astype(np.int32)
    labels[1, -4:] = -1
    lb = {k: v for k, v in batch.items() if k != "lengths"}
    lb["labels"] = labels
    jloss = jax.jit(jm.loss)(jp, _jax_batch(lb))
    tloss = tm.loss(tp, _torch_batch(lb))
    assert tloss.dtype == torch.float32 and tloss.shape == ()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=LOSS_TOL, rtol=LOSS_TOL)


@pytest.mark.parametrize("name", ["gemma2-hd128", "phi3v-hd96"])
def test_loss_by_key_blocks_matches_jax(name, monkeypatch):
    """``loss`` past NAIVE_TRAIN_MAX_SEQ (lowered here to 16 positions, so
    the reduced models' sequences cross it) attends by key blocks, and
    still equals the JAX loss, and its own full-score loss, within 1e-5."""
    from repro_torch.models import transformer
    jc, tc, jm, tm, jp, tp, S = _models(name)
    rng = np.random.default_rng(3)
    batch = _batch(jc, S, rng)
    del batch["lengths"]
    labels = rng.integers(0, jc.vocab_size, batch["tokens"].shape).astype(np.int32)
    labels[0, :3] = -1
    batch["labels"] = labels
    jloss = float(jax.jit(jm.loss)(jp, _jax_batch(batch)))
    naive = tm.loss(tp, _torch_batch(batch)).item()
    calls = []
    blockwise = attention.blockwise_attention
    monkeypatch.setattr(transformer, "NAIVE_TRAIN_MAX_SEQ", 16)
    monkeypatch.setattr(attention, "blockwise_attention",
                        lambda *a, **kw: calls.append(1) or blockwise(*a, **kw))
    blocks = tm.loss(tp, _torch_batch(batch)).item()
    assert len(calls) == tc.num_layers
    np.testing.assert_allclose(blocks, jloss, atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(blocks, naive, atol=LOSS_TOL, rtol=LOSS_TOL)


@pytest.mark.parametrize("name", ["gemma2-hd256", "phi3v-hd96"])
def test_prefill_then_decode_equals_longer_prefill(name):
    """The reference's cache property (tests/test_models_consistency.py)
    inside the port: a prefill of S tokens and 6 decode steps give the
    logits of one prefill of S + 6 tokens (gemma2: S past the window, so the
    decode steps run over wrapped local rings)."""
    _, tc, _, tm, _, tp, S = _models(name)
    rng = np.random.default_rng(2)
    extra = 6
    batch = _batch(tc, S + extra, rng)
    del batch["lengths"]
    T = tc.num_frontend_tokens if tc.frontend == "vision" else 0
    C = T + S + extra
    full = _torch_batch(batch)
    part = dict(full, tokens=full["tokens"][:, :S])
    ref, _ = tm.prefill(tp, full, cache_len=C)
    logits, cache = tm.prefill(tp, part, cache_len=C)
    for t in range(S, S + extra):
        logits, cache = tm.decode_step(tp, full["tokens"][:, t], cache)
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    assert rel < MODEL_TOL, rel


def test_long_context_and_cache_dtype_match_jax():
    """gemma2 with ``long_context`` (its global layers windowed too: 128 in
    the reduced config) and a bf16 decode cache under f32 weights, against
    the JAX Transformer built with the same two arguments; a prompt past
    both windows, so every cache is a wrapped ring. Prefill logits in f32
    at 1e-4; the caches, stored in bf16, at most one bf16 ulp apart (2^-7
    relative: f32 values a hair apart can round to neighbouring bf16
    values); decode logits at 2e-2 (they read the bf16 caches)."""
    kw = {"long_context": True, "cache_dtype": "bfloat16"}
    jc = dataclasses.replace(jax_get_config("gemma2-2b").reduced(), dtype="float32")
    tc = dataclasses.replace(get_config("gemma2-2b").reduced(), dtype="float32")
    jm, tm = jax_build_model(jc, remat=False, **kw), build_model(tc, **kw)
    jp = jm.init(jax.random.PRNGKey(9))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    assert tm._windows() == jm._windows() == [64, 128]
    batch = _batch(jc, 140, np.random.default_rng(5))
    C = 150
    jlog, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, _jax_batch(batch), C)
    tlog, tcache = tm.prefill(tp, _torch_batch(batch), cache_len=C)
    _close(tlog, jlog, MODEL_TOL)
    for key, leaf in jcache.items():
        assert tuple(tcache[key].shape) == leaf.shape, key
        if key != "pos":
            assert tcache[key].dtype == torch.bfloat16
            np.testing.assert_allclose(tcache[key].float().numpy(), np.asarray(leaf, np.float32),
                                       atol=1e-6, rtol=2.0 ** -7)
    tok = jnp.argmax(jlog, -1).astype(jnp.int32)
    for _ in range(4):
        jlog, jcache = jm.decode_step(jp, tok, jcache)
        tlog, tcache = tm.decode_step(tp, torch.tensor(np.asarray(tok)), tcache)
        _close(tlog, jlog, 2e-2)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)


def test_build_model_routes_every_transformer_family():
    """Dense, MoE and VLM build a Transformer (gemma2's layer stack restacked
    to (L/2, 2), as the reference's); SSM, hybrid and audio build the port's
    RWKVModel, Zamba2Model and WhisperModel. Each init tree equals the JAX
    model's in shape."""
    classes = {"rwkv6-1.6b": RWKVModel, "zamba2-7b": Zamba2Model,
               "whisper-tiny": WhisperModel}
    for arch in ("gemma2-2b", "phi-3-vision-4.2b", "qwen2.5-7b", "granite-moe-3b-a800m",
                 *classes):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        assert type(model) is classes.get(arch, Transformer)
        jp = jax_build_model(jax_get_config(arch).reduced(), remat=False).init(
            jax.random.PRNGKey(0))
        tp = model.init(torch.Generator().manual_seed(0))
        assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
            jax.tree.map(lambda t: tuple(t.shape), tp)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-7b"])
def test_params_from_jax_carries_restacked_and_tied_leaves(arch):
    """gemma2's (L/2, 2, ...) layer leaves and tied embedding (no lm_head),
    and qwen's separate lm_head, cross bit for bit."""
    jc = jax_get_config(arch).reduced()
    tc = get_config(arch).reduced()
    jp = jax_build_model(jc, remat=False).init(jax.random.PRNGKey(4))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc)
    assert ("lm_head" in tp) == (not tc.tie_embeddings) == ("lm_head" in jp)
    stack = (tc.num_layers // 2, 2) if tc.local_global else (tc.num_layers,)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == tc.torch_dtype
        if path[0].key == "layers":
            assert tuple(t.shape[:len(stack)]) == stack
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32))
