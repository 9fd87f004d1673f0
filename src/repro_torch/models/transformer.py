"""Decoder-only transformer (dense, MoE and VLM families), the port of
``repro.models.transformer``, with the reference's API:

  init(gen) -> params
  prefill(params, batch, cache_len) -> (last-token logits (B,V), cache|None)
  init_cache(batch_size, cache_len, prefilled_len) -> zero cache
  decode_step(params, tokens (B,), cache) -> (logits (B,V), cache)
  loss(params, batch) -> scalar

The parameter pytree matches ``repro.models.transformer.Transformer.init``:
nested dicts whose ``layers`` leaves are stacked on axis 0, or on (L/2, 2)
for gemma2's local/global alternation, so weights made by the JAX package
carry across as a straight copy (``repro_torch.interop``). The reference's
``lax.scan`` over the stack is a Python loop here. The layer body
(``block_prefill``, ``block_tail``) is the one the serving engine
(``engine.ServingEngine``) composes over its paged pools.

Prefill attention runs the flash-prefill kernel on a CUDA device (its plain
version on the CPU, or with ``backend="ref"``). Decode attends over a
contiguous ring-buffer cache in plain torch, as the reference does in XLA
with no Pallas kernel, and writes the new token's K/V into that cache in
place. ``loss`` attends as the reference trains: with the full-score plain
version up to ``NAIVE_TRAIN_MAX_SEQ`` positions, and by key blocks past that
(``attention.blockwise_attention``); never with the kernel, which has no
backward.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels import BACKENDS, require_device
from repro_torch.models import attention, layers, moe as moe_lib
from repro_torch.models.config import AUDIO, VLM, ModelConfig
from repro_torch.sharding.ctx import constrain

Params = Any

#: the longest sequence ``loss`` attends over with full scores (the
#: reference's ``_train_impl``); longer ones go by key blocks
NAIVE_TRAIN_MAX_SEQ = 8192


def _norm_init(cfg: ModelConfig, d: int, device, stack: tuple = ()):
    if cfg.family == AUDIO:
        return layers.init_layernorm(d, cfg.torch_dtype, device, stack)
    return layers.init_rmsnorm(d, cfg.torch_dtype, device, stack)


def _norm(cfg: ModelConfig, p, x):
    if cfg.family == AUDIO:
        return layers.layernorm(p, x, cfg.norm_eps)
    return layers.rmsnorm(p, x, cfg.norm_eps)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, checkpointed under autograd when ``remat`` (the
    reference's ``jax.checkpoint`` around a scan body): its activations are
    recomputed in the backward instead of kept. Without autograd it is a
    plain call."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _tree_unbind(tree) -> list:
    """The entries of a params dict whose leaves are stacked on axis 0, as a
    list of dicts of views, each leaf unbound once. Under autograd the
    backward of one ``unbind`` stacks the entries' grads once; indexing each
    entry apart would add a stack-sized zero tensor per entry."""
    if isinstance(tree, dict):
        parts = {k: _tree_unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def init_block(gen: torch.Generator, cfg: ModelConfig, stack: tuple = ()):
    """Transformer block parameters (attention + MLP/MoE + norms), with
    ``stack`` leading axes on every leaf."""
    dev = layers.param_device(gen)
    p = {
        "ln1": _norm_init(cfg, cfg.d_model, dev, stack),
        "attn": attention.init_attn(gen, cfg, stack),
        "ln2": _norm_init(cfg, cfg.d_model, dev, stack),
    }
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, stack)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.torch_dtype,
                                   cfg.mlp_act, stack)
    if cfg.use_post_norm:
        p["post_ln1"] = _norm_init(cfg, cfg.d_model, dev, stack)
        p["post_ln2"] = _norm_init(cfg, cfg.d_model, dev, stack)
    return p


def block_tail(p, x, a, cfg: ModelConfig, *, moe_groups: int = 16):
    """Everything after attention's out-projection ``a``: post-norm,
    residual, norm, MLP or MoE, residual. An MoE layer routes the rows of
    ``x`` together, in ``moe_groups`` groups of tokens. Returns (x, routing):
    the MoE dispatch's (router probs, expert ids), which the load-balance
    loss reads, or None for a dense layer."""
    if cfg.use_post_norm:
        a = _norm(cfg, p["post_ln1"], a)
    x = x + a
    h = _norm(cfg, p["ln2"], x)
    routing = None
    if cfg.is_moe:
        m, probs, eidx = moe_lib.moe_dispatch(p["moe"], h, cfg, groups=moe_groups)
        routing = (probs, eidx)
    else:
        m = layers.mlp(p["mlp"], h, cfg.mlp_act)
    if cfg.use_post_norm:
        m = _norm(cfg, p["post_ln2"], m)
    return x + m, routing


def block_prefill(p, x, positions, cfg: ModelConfig, *, window: int, kv_lens=None,
                  backend: str = "cuda", moe_groups: int = 16):
    """One block over whole sequences x (B, S, d). Returns (x, (k, v)
    post-rope (B, S, Hkv, hd), routing)."""
    h = _norm(cfg, p["ln1"], x)
    a, kv = attention.attn_prefill(p["attn"], h, positions, cfg, window=window,
                                   kv_lens=kv_lens, backend=backend)
    x, routing = block_tail(p, x, a, cfg, moe_groups=moe_groups)
    return x, kv, routing


def block_decode(p, x, positions, cfg: ModelConfig, cache_k, cache_v, lengths, *,
                 moe_groups: int = 16):
    """x (B, 1, d): writes the current token's K/V into the (ring) caches
    (B, C, Hkv, hd) in place, then attends over them. Returns x."""
    h = _norm(cfg, p["ln1"], x)
    q, k_new, v_new = attention._project_qkv(p["attn"], h, cfg, positions[:, None],
                                             rope=not cfg.is_encoder_decoder)
    attention.write_decode_cache(cache_k, cache_v, k_new, v_new, positions)
    a = attention.attn_decode(p["attn"], q, cache_k, cache_v, lengths, cfg)
    return block_tail(p, x, a, cfg, moe_groups=moe_groups)[0]


class Transformer:
    """Dense / MoE / VLM decoder-only model.

    ``backend``: ``"auto"`` or ``"cuda"`` send prefill attention to the
    flash-prefill wrapper, which launches the kernel on a CUDA tensor and
    runs its plain version on a CPU tensor; ``"ref"`` asks for the plain
    version on any device by name. ``cache_dtype`` (e.g.
    ``"float8_e4m3fn"``) stores the decode cache in another dtype; attention
    reads it in f32. ``remat`` (the reference's default, on): under autograd
    each scan body's activations are recomputed in the backward instead of
    kept; without autograd it changes nothing."""

    def __init__(self, cfg: ModelConfig, *, backend: str = "auto", moe_groups: int = 16,
                 long_context: bool = False, remat: bool = True,
                 cache_dtype: str | None = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if cfg.local_global and cfg.num_layers % 2:
            raise ValueError("local/global alternation needs an even number of layers")
        self.cfg = cfg
        self.backend = "ref" if backend == "ref" else "cuda"
        self.moe_groups = moe_groups
        self.long_context = long_context
        self.remat = remat
        self.cache_dtype = getattr(torch, cache_dtype) if cache_dtype else cfg.torch_dtype

    # --- parameters -------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Parameters on ``gen``'s device, drawn at the JAX package's shapes
        and scales (its random bits differ: tests carry JAX weights across)."""
        cfg = self.cfg
        dt = cfg.torch_dtype
        stack = (cfg.num_layers // 2, 2) if cfg.local_global else (cfg.num_layers,)
        p = {
            "embed": layers._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
            "layers": init_block(gen, cfg, stack=stack),
            "final_norm": _norm_init(cfg, cfg.d_model, layers.param_device(gen)),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = layers._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02, dt)
        return p

    # --- helpers ----------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(np.sqrt(self.cfg.d_model), dtype=x.dtype)
        return constrain(x, "act_btd")

    def _logits(self, params, x):
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        logits = _norm(self.cfg, params["final_norm"], x) @ head
        return layers.softcap(logits.float(), self.cfg.final_logit_softcap)

    def _windows(self) -> list[int]:
        """Attention window of each layer class: (local, global) for gemma2,
        else one class."""
        cfg = self.cfg
        classes = 2 if cfg.local_global else 1
        return [cfg.layer_window(i, self.long_context) for i in range(classes)]

    def _cache_sizes(self, seq_len: int) -> list[int]:
        return [min(w, seq_len) if w else seq_len for w in self._windows()]

    def _bodies(self, params):
        """The reference's scan over the layer stack, unrolled: per scan
        body, a list of (layer params, window class). A body is one layer,
        or one gemma2 local/global pair (its stack is (L/2, 2))."""
        stack = _tree_unbind(params["layers"])
        if not self.cfg.local_global:
            return [[(lp, 0)] for lp in stack]
        return [list(zip(_tree_unbind(pair), (0, 1))) for pair in stack]

    # --- forward over the full sequence ------------------------------------
    def _forward(self, params, x, positions, kv_lens, cache_len: int, backend: str):
        """Runs all layers; returns (hidden, caches, routings): per window
        class the stacked decode caches (k, v) of shape (layers of the class,
        B, C, Hkv, hd) when ``cache_len`` > 0, and each MoE layer's routing.
        With ``remat`` under autograd each scan body is checkpointed; it
        returns its routings, since whatever it did besides would run again
        in the recompute."""
        windows = self._windows()
        sizes = self._cache_sizes(cache_len) if cache_len else [0] * len(windows)

        def body(group, x):
            x = constrain(x, "act_btd")
            kvs, routings = [], []
            for lp, c in group:
                x, kv, routing = block_prefill(
                    lp, x, positions, self.cfg, window=windows[c], kv_lens=kv_lens,
                    backend=backend, moe_groups=self.moe_groups)
                kvs.append(kv)
                routings.append(routing)
            return x, kvs, routings

        remat = self.remat and torch.is_grad_enabled()
        caches = [[] for _ in windows]
        routings = []
        for group in self._bodies(params):
            if remat:
                x, kvs, rs = torch.utils.checkpoint.checkpoint(body, group, x,
                                                               use_reentrant=False)
            else:
                x, kvs, rs = body(group, x)
            for (_, c), (k, v) in zip(group, kvs):
                if sizes[c]:
                    caches[c].append(attention.write_prefill_cache(k, v, sizes[c],
                                                                   dtype=self.cache_dtype))
            routings += [r for r in rs if r is not None]
        caches = [(torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))
                  for kv in caches] if cache_len else None
        return x, caches, routings

    def _inputs(self, params, batch):
        """Embedded tokens with a VLM's ``frontend_embeds`` first, and their
        positions. Returns (x (B, S, d), positions (B, S), frontend length)."""
        x = self._embed(params, batch["tokens"])
        T = 0
        if self.cfg.family == VLM and "frontend_embeds" in batch:
            fe = batch["frontend_embeds"].to(device=x.device, dtype=x.dtype)
            T = fe.shape[1]
            x = torch.cat([fe, x], dim=1)   # image tokens first
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        return x, positions, T

    # --- public API ---------------------------------------------------------
    def prefill(self, params, batch, cache_len: int = 0):
        """batch: tokens (B,S) [+ frontend_embeds (B,T,d)] [+ lengths (B,),
        counted over the frontend tokens too]. Returns (last-token logits
        (B,V) f32, cache or None)."""
        x, positions, _ = self._inputs(params, batch)
        B, S = x.shape[:2]
        kv_lens = batch.get("lengths")
        kv_lens = (torch.full((B,), S, dtype=torch.int32, device=x.device) if kv_lens is None
                   else torch.as_tensor(kv_lens, dtype=torch.int32, device=x.device))
        x, caches, _ = self._forward(params, x, positions, kv_lens, cache_len, self.backend)
        last = x[torch.arange(B, device=x.device), kv_lens.long() - 1]
        logits = self._logits(params, last)
        return logits, (self._pack_cache(caches, kv_lens) if cache_len else None)

    def _pack_cache(self, caches, lengths):
        cache = {"pos": lengths.to(torch.int32)}
        for i, (k, v) in enumerate(caches):
            cache[f"k{i}"], cache[f"v{i}"] = k, v
        return cache

    def init_cache(self, batch_size: int, cache_len: int, prefilled_len: int = 0, *,
                   device="cuda"):
        """A zero cache, as a prefill of ``prefilled_len`` tokens would leave
        its shapes, on ``device``."""
        cfg = self.cfg
        dev = require_device(device)
        cache = {"pos": torch.full((batch_size,), prefilled_len, dtype=torch.int32,
                                   device=dev)}
        L = cfg.num_layers // (2 if cfg.local_global else 1)
        for i, cs in enumerate(self._cache_sizes(cache_len)):
            shape = (L, batch_size, cs, cfg.num_kv_heads, cfg.head_dim_)
            cache[f"k{i}"] = torch.zeros(shape, dtype=self.cache_dtype, device=dev)
            cache[f"v{i}"] = torch.zeros(shape, dtype=self.cache_dtype, device=dev)
        return cache

    def decode_step(self, params, tokens, cache):
        """tokens (B,) integer. Writes each layer's new K/V into ``cache``'s
        tensors in place and returns (logits (B,V) f32, the cache with its
        positions advanced by one)."""
        positions = cache["pos"]
        lengths = positions + 1
        x = self._embed(params, tokens[:, None])
        for i, group in enumerate(self._bodies(params)):
            for lp, c in group:
                x = block_decode(lp, x, positions, self.cfg, cache[f"k{c}"][i],
                                 cache[f"v{c}"][i], lengths, moe_groups=self.moe_groups)
        logits = self._logits(params, x[:, 0])
        return logits, {**cache, "pos": positions + 1}

    def loss(self, params, batch):
        """batch: tokens (B,S), labels (B,S) with -1 ignored [+
        frontend_embeds (B,T,d), whose positions carry no label]. Mean
        cross-entropy plus 0.01 x the MoE load-balance loss."""
        cfg = self.cfg
        x, positions, T = self._inputs(params, batch)
        B, S = x.shape[:2]
        kv_lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
        backend = "ref" if S <= NAIVE_TRAIN_MAX_SEQ else "blockwise"
        x, _, routings = self._forward(params, x, positions, kv_lens, 0, backend)
        logits = self._logits(params, x[:, T:])
        ce = layers.cross_entropy_loss(logits, batch["labels"])
        aux = sum((moe_lib.aux_loss(probs, eidx, cfg.num_experts)
                   for probs, eidx in routings), torch.zeros((), device=x.device))
        return ce + 0.01 * aux
