"""Attention sub-layer: projections, rope, prefill attention and decode
attention over a contiguous (ring-buffer) cache.

Supports GQA, sliding windows, qwen3 qk-norm, qwen2.5 QKV bias and the gemma2
logit softcap. Prefill attention, over a whole prompt or a chunk at
``q_offset`` over the request's gathered pages, goes to the flash-prefill
wrapper (the Hopper kernel on a CUDA tensor) or, with ``backend="ref"``, to
its plain version on any device: ``naive_attention``, the full-score
attention the reference trains with, which the whole-model loss uses up to
8192 tokens; past that the loss takes ``blockwise_attention``
(``backend="blockwise"``), the online softmax over key blocks that never
holds the (Sq, Skv) scores. Decode attention over the whole-model API's contiguous cache is plain torch,
as the reference's is XLA with no Pallas kernel; the serving engine decodes
over paged pools instead (``engine.ServingEngine``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_attn(gen, cfg: ModelConfig, stack: tuple = ()):
    d, hd = cfg.d_model, cfg.head_dim_
    dt = cfg.torch_dtype
    p = {
        "wq": layers.init_dense(gen, d, cfg.num_heads * hd, dt, bias=cfg.attn_bias, stack=stack),
        "wk": layers.init_dense(gen, d, cfg.num_kv_heads * hd, dt, bias=cfg.attn_bias, stack=stack),
        "wv": layers.init_dense(gen, d, cfg.num_kv_heads * hd, dt, bias=cfg.attn_bias, stack=stack),
        "wo": layers.init_dense(gen, cfg.num_heads * hd, d, dt,
                                scale=0.02 / np.sqrt(2 * max(cfg.num_layers, 1)),
                                stack=stack),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(hd, dt, gen.device, stack)
        p["k_norm"] = layers.init_rmsnorm(hd, dt, gen.device, stack)
    return p


def _project_q(p, x, cfg: ModelConfig, positions, rope: bool = True):
    """x (B,S,d); positions (B,S). Returns q (B,S,Hq,hd)."""
    B, S, _ = x.shape
    q = layers.dense(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim_)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_qkv(p, x, cfg: ModelConfig, positions, rope: bool = True):
    """x (B,S,d); positions (B,S). Returns q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = _project_q(p, x, cfg, positions, rope)
    k = layers.dense(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = layers.dense(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


NEG_INF = -1e30


def naive_attention(q, k, v, *, q_offset: int = 0, causal: bool = True, window: int = 0,
                    kv_lens=None, logit_softcap: float = 0.0, scale: float | None = None):
    """Full-score attention in the model layout, computed in f32: q (B, Sq,
    Hq, hd) at absolute positions ``[q_offset, q_offset + Sq)``, k/v (B,
    Skv, Hkv, hd) -> (B, Sq, Hq, hd) in q's dtype. The flash kernel's plain
    version, which materializes the scores: so it is also the reference's
    training-time ``naive_attention_xla``."""
    out = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            kv_len=k.shape[1], q_offset=q_offset, causal=causal,
                            window=window, logit_softcap=logit_softcap, scale=scale,
                            kv_lens=kv_lens)
    return out.transpose(1, 2)


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset=0,
                        kv_lens=None, logit_softcap: float = 0.0, kv_block: int = 512,
                        scale: float | None = None):
    """The same function as ``naive_attention``, computed in f32 by an
    online softmax over key blocks of ``kv_block``, so that no (Sq, Skv)
    score tensor is held: the reference's ``flash_attention_xla``. q (B, Sq,
    Hq, hd), k/v (B, Skv, Hkv, hd); ``q_offset`` a scalar or (B,) absolute
    position of q[:, 0]. Returns (B, Sq, Hq, hd) in q's dtype."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    dev = q.device
    if kv_lens is None:
        kv_lens = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    kv_lens = torch.as_tensor(kv_lens, device=dev)
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    q_pos = (torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
             + torch.arange(Sq, device=dev)).expand(B, Sq)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hd), device=dev)
    for k0 in range(0, Skv, kv_block):
        kb, vb = k[:, k0:k0 + kv_block].float(), v[:, k0:k0 + kv_block].float()
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kb) * scale
        s = layers.softcap(s, logit_softcap)
        k_pos = k0 + torch.arange(kb.shape[1], device=dev)
        mask = (k_pos[None, :] < kv_lens[:, None])[:, None, :]          # (B, 1, c)
        if causal:
            rel = q_pos[:, :, None] - k_pos[None, None, :]              # (B, Sq, c)
            mask = mask & (rel >= 0)
            if window:
                mask = mask & (rel < window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *, logit_softcap: float = 0.0,
                     scale: float | None = None):
    """Single-token decode attention over a (possibly ring-buffer) cache.

    q (B, Hq, hd); caches (B, C, Hkv, hd) in any dtype (read in f32);
    lengths (B,) tokens written so far, the current one included. The valid
    slots are the first min(lengths, C): once a ring has wrapped every slot
    is valid, and the softmax does not depend on the slots' order."""
    B, Hq, hd = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * scale
    s = layers.softcap(s, logit_softcap)
    valid = torch.arange(C, device=q.device)[None, :] < lengths.clamp(max=C)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(B, Hq, hd).to(q.dtype)


def _attend(q, k, v, cfg: ModelConfig, *, backend: str, causal: bool = True,
            window: int = 0, q_offset: int = 0, kv_lens=None):
    """Prefill attention in the model layout: q (B, Sq, Hq, hd) at absolute
    positions ``[q_offset, q_offset + Sq)`` over k/v (B, Skv, Hkv, hd), keys
    past ``kv_lens[b]`` masked. The flash kernel on ``backend="cuda"``, its
    plain version (``naive_attention``) on ``"ref"``, the same function by
    key blocks (``blockwise_attention``) on ``"blockwise"``."""
    if backend == "blockwise":
        return blockwise_attention(q, k, v, q_offset=q_offset, causal=causal, window=window,
                                   logit_softcap=cfg.attn_logit_softcap, kv_lens=kv_lens)
    if backend == "ref":
        return naive_attention(q, k, v, q_offset=q_offset, causal=causal, window=window,
                               logit_softcap=cfg.attn_logit_softcap, kv_lens=kv_lens)
    return fp_ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        logit_softcap=cfg.attn_logit_softcap, kv_lens=kv_lens)


def attn_prefill(p, x, positions, cfg: ModelConfig, *, window: int = 0,
                 causal: bool = True, kv_lens=None, backend: str = "cuda",
                 cross_kv=None):
    """Returns (out (B,S,d), (k, v) post-rope for caching). ``backend`` is a
    resolved engine backend (``repro_torch.kernels.resolve_backend``).
    ``cross_kv`` (k, v) of shape (B, Skv, Hkv, hd): cross attention over
    them instead of x's own K/V, never causal (an encoder-decoder's decoder
    over the encoder's output; ``kv_lens`` then counts encoder positions).
    Encoder-decoder models project with no rope."""
    B, S, _ = x.shape
    rope = not cfg.is_encoder_decoder
    if cross_kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions, rope)
    else:   # the reference projects x's K/V here too, and drops them
        q, (k, v) = _project_q(p, x, cfg, positions, rope), cross_kv
        causal = False
    n = fp_ops.flash_attention.launches
    out = _attend(q, k, v, cfg, backend=backend, causal=causal, window=window,
                  kv_lens=kv_lens)
    # the wrapper's own count, split off for whole prompts by (length,
    # window, head_dim, causal, key length)
    key = (S, window, q.shape[-1], causal, k.shape[1])
    launched = attn_prefill.flash_launches
    launched[key] = launched.get(key, 0) + fp_ops.flash_attention.launches - n
    out = layers.dense(p["wo"], out.reshape(B, S, -1))
    return out, (k, v)


#: flash kernel launches of whole prompts, by (length, window, head_dim,
#: causal, key length): a decoder's causal self-attention and its cross
#: attention over the encoder at the same prompt length count apart
attn_prefill.flash_launches = {}


def attn_chunk(p, q, k_ctx, v_ctx, cfg: ModelConfig, *, q_offset: int, kv_lens,
               backend: str = "cuda"):
    """Attention of a prefill chunk, out-projected: q (1, C, Hq, hd), projected
    at positions ``[q_offset, q_offset + C)``, attends causally over the
    request's gathered pages k_ctx/v_ctx (1, Skv, Hkv, hd), which already
    hold the chunk's own K/V; keys from ``kv_lens`` (1,) on are masked."""
    B, C = q.shape[:2]
    out = _attend(q, k_ctx, v_ctx, cfg, backend=backend, q_offset=q_offset,
                  kv_lens=kv_lens)
    return layers.dense(p["wo"], out.reshape(B, C, -1))


def attn_decode(p, q, cache_k, cache_v, lengths, cfg: ModelConfig):
    """q (B,1,Hq,hd), the current token's query, projected at its position
    (by the ``_project_qkv`` call that also gave its K/V); caches
    (B,C,Hkv,hd) that ALREADY hold the current token's k/v (the caller
    writes them first, so it owns the cache layout). Returns (B,1,d)."""
    B = q.shape[0]
    out = decode_attention(q[:, 0], cache_k, cache_v, lengths,
                           logit_softcap=cfg.attn_logit_softcap)
    return layers.dense(p["wo"], out.reshape(B, 1, -1))


def write_decode_cache(cache_k, cache_v, k_new, v_new, positions):
    """Write one token per row into a (ring-buffer) cache, in place: caches
    (B,C,Hkv,hd), k_new/v_new (B,1,Hkv,hd), positions (B,) absolute. Slot =
    position % C (a ring of C >= the longest sequence is a plain cache).
    Returns the caches (the same tensors; the reference returns new arrays)."""
    B, C = cache_k.shape[0], cache_k.shape[1]
    slot = positions % C
    rows = torch.arange(B, device=cache_k.device)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def write_prefill_cache(k, v, cache_size: int, dtype=None):
    """A decode cache (B, cache_size, Hkv, hd) from prefill K/V (B,S,Hkv,hd):
    the first S slots when they fit, else the last ``cache_size`` tokens,
    each at ring slot pos % cache_size. Like the reference, a ragged batch
    keeps the last slots of the padded length S for every row."""
    B, S, Hkv, hd = k.shape
    dtype = dtype or k.dtype
    if S <= cache_size:
        ck = k.new_zeros((B, cache_size, Hkv, hd), dtype=dtype)
        cv = v.new_zeros((B, cache_size, Hkv, hd), dtype=dtype)
        ck[:, :S], cv[:, :S] = k, v
        return ck, cv
    # token at absolute position p goes to slot p % C: a rotation of the tail
    shift = (S - cache_size) % cache_size
    tail_k, tail_v = k[:, -cache_size:], v[:, -cache_size:]
    return (tail_k.roll(shift, dims=1).to(dtype).contiguous(),
            tail_v.roll(shift, dims=1).to(dtype).contiguous())
