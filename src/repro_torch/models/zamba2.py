"""Zamba2 hybrid, the port of ``repro.models.zamba2``: stacked Mamba2 layers
with one *shared* attention block applied after every ``shared_attn_every``
of them (arXiv:2411.15242).

The shared block is one parameter set (``transformer.init_block``); each of
its application points keeps its own KV cache. 81 layers are 13 groups of 6,
each followed by the shared block, and 3 trailing layers. The shared block's
prefill attention goes to the flash kernel on a CUDA device (hd 112 at full
width: 13 launches a prefill); decode attends over its contiguous caches in
plain torch, as ``Transformer.decode_step`` does.

Cache: per Mamba layer (conv, ssm) states, constant in sequence length, and
the shared block's K/V caches, windowed in long-context mode. The parameter
pytree is the reference's (``mamba_layers`` stacked on axis 0, one
``shared_attn``), so its weights carry across with ``interop``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import BACKENDS, require_device
from repro_torch.models import attention, layers, mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (NAIVE_TRAIN_MAX_SEQ, _tree_unbind, block_decode,
                                            block_prefill, init_block, remat_call)
from repro_torch.sharding.ctx import constrain


class Zamba2Model:
    """``backend``: ``"auto"``/``"cuda"`` send the shared block's prefill
    attention to the flash wrapper (the kernel on a CUDA tensor, its plain
    version on a CPU one), ``"ref"`` to the plain version by name. ``remat``:
    under autograd each Mamba layer is recomputed in the backward, as the
    reference's scan body."""

    def __init__(self, cfg: ModelConfig, *, backend: str = "auto",
                 long_context: bool = False, remat: bool = True, **_):
        if cfg.shared_attn_every <= 0:
            raise ValueError("a hybrid model needs shared_attn_every > 0")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.cfg = cfg
        self.backend = "ref" if backend == "ref" else "cuda"
        self.long_context = long_context
        self.remat = remat
        g = cfg.shared_attn_every
        self.n_full_groups = cfg.num_layers // g
        self.trailing = cfg.num_layers - self.n_full_groups * g
        self.n_attn = self.n_full_groups  # one shared-attention application per full group

    def _attn_window(self) -> int:
        # full attention normally; windowed in long-context mode
        return (self.cfg.global_window_long or 32768) if self.long_context else 0

    def _attn_cache_size(self, seq_len: int) -> int:
        w = self._attn_window()
        return min(w, seq_len) if w else seq_len

    # --- params -----------------------------------------------------------
    def init(self, gen: torch.Generator):
        """Parameters on ``gen``'s device, at the JAX package's shapes and
        scales (its random bits differ: tests carry JAX weights across)."""
        cfg = self.cfg
        dt, dev, L = cfg.torch_dtype, layers.param_device(gen), (cfg.num_layers,)
        return {
            "embed": layers._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
            "mamba_layers": {"ln": layers.init_rmsnorm(cfg.d_model, dt, dev, L),
                             "mamba": mamba2.init_mamba(gen, cfg, L)},
            "shared_attn": init_block(gen, cfg),  # one block, reused at every group's end
            "final_norm": layers.init_rmsnorm(cfg.d_model, dt, dev),
            "lm_head": layers._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02, dt),
        }

    def _groups(self):
        """(start, size, followed by the shared block) of each group."""
        g = self.cfg.shared_attn_every
        out = [(i * g, g, True) for i in range(self.n_full_groups)]
        if self.trailing:
            out.append((self.n_full_groups * g, self.trailing, False))
        return out

    # --- cache ------------------------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int = 0, prefilled_len: int = 0, *,
                   device="cuda"):
        """A zero cache, as a prefill of ``prefilled_len`` tokens would leave
        its shapes, on ``device``."""
        cfg = self.cfg
        dev, dt = require_device(device), cfg.torch_dtype
        L, B = cfg.num_layers, batch_size
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
        C = self._attn_cache_size(max(cache_len, 1))
        kv = (self.n_attn, B, C, cfg.num_kv_heads, cfg.head_dim_)
        return {
            "conv": torch.zeros((L, B, cfg.ssm_conv - 1, conv_dim), dtype=dt, device=dev),
            "ssm": torch.zeros((L, B, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
                               device=dev),
            "attn_k": torch.zeros(kv, dtype=dt, device=dev),
            "attn_v": torch.zeros(kv, dtype=dt, device=dev),
            "pos": torch.full((B,), prefilled_len, dtype=torch.int32, device=dev),
        }

    # --- forward ----------------------------------------------------------
    def _mamba_layer(self, lp, x):
        x = constrain(x, "act_btd")
        h = layers.rmsnorm(lp["ln"], x, self.cfg.norm_eps)
        out, (conv, ssm) = mamba2.mamba_prefill(lp["mamba"], h, self.cfg)
        return x + out, conv, ssm

    def _forward(self, params, x, positions, kv_lens, *, window: int, backend: str):
        """All layers over whole sequences. Returns (x, convs, ssms, kvs): each
        Mamba layer's states and each shared-block application's (k, v)."""
        mamba_layers = _tree_unbind(params["mamba_layers"])
        convs, ssms, kvs = [], [], []
        for start, size, with_attn in self._groups():
            for lp in mamba_layers[start:start + size]:
                x, conv, ssm = remat_call(self.remat, self._mamba_layer, lp, x)
                convs.append(conv)
                ssms.append(ssm)
            if with_attn:
                x, kv, _ = block_prefill(params["shared_attn"], x, positions, self.cfg,
                                         window=window, kv_lens=kv_lens, backend=backend)
                kvs.append(kv)
        return x, convs, ssms, kvs

    def _logits(self, params, x):
        x = layers.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return (x @ params["lm_head"]).float()

    def prefill(self, params, batch, cache_len: int = 0):
        """batch: tokens (B,S) [+ lengths (B,)]. Returns (last-token logits
        (B,V) f32, cache). As in the reference, the Mamba layers run over the
        padded length of every row: a row's states also see its padding."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache_len = cache_len or S
        x = constrain(params["embed"][tokens], "act_btd")
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        lens = batch.get("lengths")
        lens = (torch.full((B,), S, dtype=torch.int32, device=x.device) if lens is None
                else torch.as_tensor(lens, dtype=torch.int32, device=x.device))
        x, convs, ssms, kvs = self._forward(params, x, positions, lens,
                                            window=self._attn_window(), backend=self.backend)
        last = x[torch.arange(B, device=x.device), lens.long() - 1]
        C = self._attn_cache_size(cache_len)
        caches = [attention.write_prefill_cache(k, v, C) for k, v in kvs]
        cache = {
            "conv": torch.stack(convs).to(self.cfg.torch_dtype),
            "ssm": torch.stack(ssms),
            "attn_k": torch.stack([k for k, _ in caches]),
            "attn_v": torch.stack([v for _, v in caches]),
            "pos": lens,
        }
        return self._logits(params, last), cache

    def decode_step(self, params, tokens, cache):
        """tokens (B,) integer. Writes every Mamba layer's new states and each
        application's new K/V into ``cache``'s tensors in place; returns
        (logits (B,V) f32, the cache with its positions advanced by one)."""
        cfg = self.cfg
        x = params["embed"][tokens[:, None]]
        pos = cache["pos"]
        lengths = pos + 1
        mamba_layers = _tree_unbind(params["mamba_layers"])
        ai = 0
        for start, size, with_attn in self._groups():
            for i in range(start, start + size):
                lp = mamba_layers[i]
                h = layers.rmsnorm(lp["ln"], x, cfg.norm_eps)
                out, (conv, ssm) = mamba2.mamba_decode(lp["mamba"], h, cfg, cache["conv"][i],
                                                       cache["ssm"][i])
                cache["conv"][i].copy_(conv)
                cache["ssm"][i].copy_(ssm)
                x = x + out
            if with_attn:
                x = block_decode(params["shared_attn"], x, pos, cfg, cache["attn_k"][ai],
                                 cache["attn_v"][ai], lengths)
                ai += 1
        return self._logits(params, x[:, 0]), {**cache, "pos": pos + 1}

    def loss(self, params, batch):
        """batch: tokens (B,S), labels (B,S) with -1 ignored. The shared
        block attends as the reference trains: full scores up to
        NAIVE_TRAIN_MAX_SEQ positions, by key blocks past that."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = constrain(params["embed"][tokens], "act_btd")
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
        backend = "ref" if S <= NAIVE_TRAIN_MAX_SEQ else "blockwise"
        x, _, _, _ = self._forward(params, x, positions, lens, window=0, backend=backend)
        return layers.cross_entropy_loss(self._logits(params, x), batch["labels"])
