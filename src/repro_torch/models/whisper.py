"""Whisper-style encoder-decoder, the port of ``repro.models.whisper``
(arXiv:2212.04356).

The mel-spectrogram and conv feature extractor are a stub, as in the
reference: ``frontend_embeds`` (B, T, d) are precomputed frame embeddings
(cast to the model's dtype here), and this module is the transformer
behind them: a bidirectional encoder and a causal decoder with cross
attention, layernorms, sinusoidal positions and a tied embedding.

Prefill attention goes to the flash kernel on a CUDA device, three ways a
layer: the encoder's self-attention (not causal, keys past ``frame_lens``
masked), the decoder's causal self-attention, and its cross attention over
the encoder's output (not causal, Sq = prompt length, Skv = T). Decode
attends over the contiguous self-attention caches and the cached cross K/V
in plain torch, as the reference does in XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import BACKENDS, require_device
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import NAIVE_TRAIN_MAX_SEQ, _tree_unbind, remat_call


class WhisperModel:
    """``backend``: ``"auto"``/``"cuda"`` send prefill attention to the flash
    wrapper (the kernel on a CUDA tensor, its plain version on a CPU one),
    ``"ref"`` to the plain version by name. ``remat``: under autograd each
    layer is recomputed in the backward, as the reference's scan bodies."""

    def __init__(self, cfg: ModelConfig, *, backend: str = "auto", remat: bool = True, **_):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.cfg = cfg
        self.backend = "ref" if backend == "ref" else "cuda"
        self.remat = remat

    def init(self, gen: torch.Generator):
        """Parameters on ``gen``'s device, at the JAX package's shapes and
        scales (its random bits differ: tests carry JAX weights across)."""
        cfg = self.cfg
        d, dt, dev = cfg.d_model, cfg.torch_dtype, gen.device

        def ln(stack=()):
            return layers.init_layernorm(d, dt, dev, stack)

        def mlp(stack):
            return layers.init_mlp(gen, d, cfg.d_ff, dt, "gelu_mlp", stack)

        E, L = (cfg.encoder_layers,), (cfg.num_layers,)
        return {
            "embed": layers._normal(gen, (cfg.vocab_size, d), 0.02, dt),
            "enc_layers": {"ln1": ln(E), "attn": attention.init_attn(gen, cfg, E),
                           "ln2": ln(E), "mlp": mlp(E)},
            "dec_layers": {"ln1": ln(L), "self_attn": attention.init_attn(gen, cfg, L),
                           "ln2": ln(L), "cross_attn": attention.init_attn(gen, cfg, L),
                           "ln3": ln(L), "mlp": mlp(L)},
            "enc_norm": ln(),
            "dec_norm": ln(),
        }

    # --- encoder ------------------------------------------------------------
    def encode(self, params, frames, frame_lens=None, backend: str | None = None):
        """frames (B, T, d) precomputed embeddings -> (B, T, d); frames past
        ``frame_lens`` (B,) are masked as keys."""
        cfg = self.cfg
        backend = backend or self.backend
        B, T, _ = frames.shape
        frames = frames.to(cfg.torch_dtype)
        x = frames + layers.sinusoidal_positions_on(T, cfg.d_model, frames.dtype,
                                                    frames.device)[None]
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
        if frame_lens is None:
            frame_lens = torch.full((B,), T, dtype=torch.int32, device=x.device)

        def layer(lp, x):
            h = layers.layernorm(lp["ln1"], x, cfg.norm_eps)
            a, _ = attention.attn_prefill(lp["attn"], h, positions, cfg, causal=False,
                                          kv_lens=frame_lens, backend=backend)
            x = x + a
            h = layers.layernorm(lp["ln2"], x, cfg.norm_eps)
            return x + layers.mlp(lp["mlp"], h, "gelu_mlp")

        for lp in _tree_unbind(params["enc_layers"]):
            x = remat_call(self.remat, layer, lp, x)
        return layers.layernorm(params["enc_norm"], x, cfg.norm_eps)

    # --- decoder ------------------------------------------------------------
    def _cross_kv(self, lp, enc_out):
        """A layer's cross K/V (B, T, Hkv, hd) of the encoder output."""
        B, T, _ = enc_out.shape
        cfg = self.cfg
        shape = (B, T, cfg.num_kv_heads, cfg.head_dim_)
        k = layers.dense(lp["cross_attn"]["wk"], enc_out).reshape(shape)
        v = layers.dense(lp["cross_attn"]["wv"], enc_out).reshape(shape)
        return k, v

    def _dec_forward(self, params, x, positions, tok_lens, enc_out, enc_lens,
                     cache_len: int, backend: str | None = None):
        """All decoder layers. Returns (x, per layer (self k, self v, cross k,
        cross v) with the self K/V written into caches of ``cache_len``, or
        None when ``cache_len`` is 0)."""
        cfg = self.cfg
        backend = backend or self.backend

        def layer(lp, x):
            h = layers.layernorm(lp["ln1"], x, cfg.norm_eps)
            a, (k, v) = attention.attn_prefill(lp["self_attn"], h, positions, cfg,
                                               kv_lens=tok_lens, backend=backend)
            x = x + a
            h = layers.layernorm(lp["ln2"], x, cfg.norm_eps)
            ck, cv = self._cross_kv(lp, enc_out)
            a, _ = attention.attn_prefill(lp["cross_attn"], h, positions, cfg,
                                          cross_kv=(ck, cv), kv_lens=enc_lens, backend=backend)
            x = x + a
            h = layers.layernorm(lp["ln3"], x, cfg.norm_eps)
            return x + layers.mlp(lp["mlp"], h, "gelu_mlp"), (k, v, ck, cv)

        caches = []
        for lp in _tree_unbind(params["dec_layers"]):
            x, (k, v, ck, cv) = remat_call(self.remat, layer, lp, x)
            if cache_len:
                caches.append((*attention.write_prefill_cache(k, v, cache_len), ck, cv))
        return x, (caches or None)

    def _embed_tokens(self, params, tokens):
        S = tokens.shape[1]
        x = params["embed"][tokens]
        return x + layers.sinusoidal_positions_on(S, self.cfg.d_model, x.dtype, x.device)[None]

    def prefill(self, params, batch, cache_len: int = 0):
        """batch: frontend_embeds (B,T,d) audio frames [+ frame_lens (B,)],
        tokens (B,S) decoder prompt [+ lengths (B,)]. Returns (last-token
        logits (B,V) f32, cache)."""
        frames, tokens = batch["frontend_embeds"], batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        enc_lens = batch.get("frame_lens")
        enc_lens = (torch.full((B,), frames.shape[1], dtype=torch.int32, device=dev)
                    if enc_lens is None else torch.as_tensor(enc_lens, dtype=torch.int32,
                                                             device=dev))
        enc_out = self.encode(params, frames, enc_lens)
        tok_lens = batch.get("lengths")
        tok_lens = (torch.full((B,), S, dtype=torch.int32, device=dev) if tok_lens is None
                    else torch.as_tensor(tok_lens, dtype=torch.int32, device=dev))
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        x, caches = self._dec_forward(params, x, positions, tok_lens, enc_out, enc_lens,
                                      cache_len or S)
        last = x[torch.arange(B, device=dev), tok_lens.long() - 1]
        sk, sv, ck, cv = (torch.stack(t) for t in zip(*caches))
        cache = {"self_k": sk, "self_v": sv, "cross_k": ck, "cross_v": cv,
                 "enc_lens": enc_lens, "pos": tok_lens}
        return self._logits(params, last), cache

    def init_cache(self, batch_size: int, cache_len: int, prefilled_len: int = 0,
                   enc_len: int = 1500, *, device="cuda"):
        """A zero cache, as a prefill of ``prefilled_len`` tokens over
        ``enc_len`` frames would leave its shapes, on ``device``."""
        cfg = self.cfg
        dev = require_device(device)

        def z(T):
            return torch.zeros((cfg.num_layers, batch_size, T, cfg.num_kv_heads,
                                cfg.head_dim_), dtype=cfg.torch_dtype, device=dev)

        return {"self_k": z(cache_len), "self_v": z(cache_len),
                "cross_k": z(enc_len), "cross_v": z(enc_len),
                "enc_lens": torch.full((batch_size,), enc_len, dtype=torch.int32, device=dev),
                "pos": torch.full((batch_size,), prefilled_len, dtype=torch.int32,
                                  device=dev)}

    def decode_step(self, params, tokens, cache):
        """tokens (B,) integer. Writes each layer's new self-attention K/V
        into ``cache``'s tensors in place (projected once with the query);
        cross attention reads the cached cross K/V. Returns (logits (B,V)
        f32, the cache with its positions advanced by one)."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = cache["pos"]
        lengths = pos + 1
        # the current token's sinusoidal position, per row (the cache is not
        # windowed: pos <= its length)
        max_pos = cache["self_k"].shape[2] + 1
        table = layers.sinusoidal_positions_on(max_pos, cfg.d_model, cfg.torch_dtype,
                                               tokens.device)
        x = params["embed"][tokens[:, None]] + table[pos.clamp(max=max_pos - 1)][:, None]
        for i, lp in enumerate(_tree_unbind(params["dec_layers"])):
            sk, sv = cache["self_k"][i], cache["self_v"][i]
            h = layers.layernorm(lp["ln1"], x, cfg.norm_eps)
            q, k_new, v_new = attention._project_qkv(lp["self_attn"], h, cfg, pos[:, None],
                                                     rope=False)
            attention.write_decode_cache(sk, sv, k_new, v_new, pos)
            x = x + attention.attn_decode(lp["self_attn"], q, sk, sv, lengths, cfg)
            h = layers.layernorm(lp["ln2"], x, cfg.norm_eps)
            q = layers.dense(lp["cross_attn"]["wq"], h).reshape(B, cfg.num_heads, cfg.head_dim_)
            a = attention.decode_attention(q, cache["cross_k"][i], cache["cross_v"][i],
                                           cache["enc_lens"])
            x = x + layers.dense(lp["cross_attn"]["wo"], a.reshape(B, 1, -1))
            h = layers.layernorm(lp["ln3"], x, cfg.norm_eps)
            x = x + layers.mlp(lp["mlp"], h, "gelu_mlp")
        return self._logits(params, x[:, 0]), {**cache, "pos": pos + 1}

    def _logits(self, params, x):
        x = layers.layernorm(params["dec_norm"], x, self.cfg.norm_eps)
        return (x @ params["embed"].T).float()  # tied head

    def loss(self, params, batch):
        """batch: frontend_embeds (B,T,d), tokens (B,S), labels (B,S) with -1
        ignored. Attention as the reference trains: full scores while T is
        at most NAIVE_TRAIN_MAX_SEQ, by key blocks past that."""
        frames, tokens = batch["frontend_embeds"], batch["tokens"]
        backend = "ref" if frames.shape[1] <= NAIVE_TRAIN_MAX_SEQ else "blockwise"
        enc_out = self.encode(params, frames, backend=backend)
        B, S = tokens.shape
        dev = tokens.device
        enc_lens = torch.full((B,), enc_out.shape[1], dtype=torch.int32, device=dev)
        tok_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        x, _ = self._dec_forward(params, x, positions, tok_lens, enc_out, enc_lens, 0,
                                 backend=backend)
        return layers.cross_entropy_loss(self._logits(params, x), batch["labels"])
