"""Attention sub-layer: projections, rope, and the prefill attention dispatch.

Supports GQA, qwen3 qk-norm, qwen2.5 QKV bias and the gemma2 logit softcap.
Prefill attention, over a whole prompt or a chunk at ``q_offset`` over the
request's gathered pages, goes to the flash-prefill wrapper (the Hopper kernel
on a CUDA tensor) or, with ``backend="ref"``, to its plain version on any
device.
"""
from __future__ import annotations

import numpy as np

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


def _project_qkv(p, x, cfg: ModelConfig, positions, rope: bool = True):
    """x (B,S,d); positions (B,S). Returns q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = layers.dense(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = layers.dense(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = layers.dense(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, cfg: ModelConfig, *, backend: str, causal: bool = True,
            window: int = 0, q_offset: int = 0, kv_lens=None):
    """Flash attention in the model layout: q (B, Sq, Hq, hd) at absolute
    positions ``[q_offset, q_offset + Sq)`` over k/v (B, Skv, Hkv, hd), keys
    past ``kv_lens[b]`` masked. The kernel on ``backend="cuda"``, its plain
    version on ``"ref"``."""
    if backend == "ref":
        out = flash_prefill_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            kv_len=k.shape[1], q_offset=q_offset, causal=causal, window=window,
            logit_softcap=cfg.attn_logit_softcap, kv_lens=kv_lens)
        return out.transpose(1, 2)
    return fp_ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        logit_softcap=cfg.attn_logit_softcap, kv_lens=kv_lens)


def attn_prefill(p, x, positions, cfg: ModelConfig, *, window: int = 0,
                 causal: bool = True, kv_lens=None, backend: str = "cuda"):
    """Returns (out (B,S,d), (k, v) post-rope for caching). ``backend`` is a
    resolved engine backend (``repro_torch.kernels.resolve_backend``)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, rope=not cfg.is_encoder_decoder)
    n = fp_ops.flash_attention.launches
    out = _attend(q, k, v, cfg, backend=backend, causal=causal, window=window,
                  kv_lens=kv_lens)
    # the wrapper's own count, split off for whole prompts by length
    launched = attn_prefill.flash_launches
    launched[S] = launched.get(S, 0) + fp_ops.flash_attention.launches - n
    out = layers.dense(p["wo"], out.reshape(B, S, -1))
    return out, (k, v)


attn_prefill.flash_launches = {}   # flash kernel launches of whole prompts, by length


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


def project_kv_for_cache(p, x, positions, cfg: ModelConfig):
    """k, v (post-rope) for the current decode token: (B, 1, Hkv, hd)."""
    _, k, v = _project_qkv(p, x, cfg, positions[:, None], rope=not cfg.is_encoder_decoder)
    return k, v
