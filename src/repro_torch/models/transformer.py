"""Decoder-only transformer (dense family): parameters and the pieces the
serving engine composes per layer.

The parameter pytree matches ``repro.models.transformer.Transformer.init``:
a nested dict whose ``layers`` leaves are stacked on axis 0, so weights made
by the JAX package carry across as a straight copy (``repro_torch.interop``).
The engine runs the layer stack itself (``engine.ServingEngine``), so this
module has no whole-model forward.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models import attention, layers
from repro_torch.models.config import AUDIO, ModelConfig

Params = Any


def _norm_init(cfg: ModelConfig, d: int, device, stack: tuple = ()):
    if cfg.family == AUDIO:
        raise NotImplementedError("layernorm models (whisper) are not ported "
                                  "yet: ROADMAP queue 1, off the serving path")
    return layers.init_rmsnorm(d, cfg.torch_dtype, device, stack)


def _norm(cfg: ModelConfig, p, x):
    return layers.rmsnorm(p, x, cfg.norm_eps)


def init_block(gen: torch.Generator, cfg: ModelConfig, stack: tuple = ()):
    """Transformer block parameters (attention + MLP + norms), with ``stack``
    leading axes on every leaf."""
    if cfg.is_moe:
        raise NotImplementedError("MoE blocks are not ported yet: ROADMAP queue 1")
    dev = gen.device
    p = {
        "ln1": _norm_init(cfg, cfg.d_model, dev, stack),
        "attn": attention.init_attn(gen, cfg, stack),
        "ln2": _norm_init(cfg, cfg.d_model, dev, stack),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.torch_dtype,
                               cfg.mlp_act, stack),
    }
    if cfg.use_post_norm:
        p["post_ln1"] = _norm_init(cfg, cfg.d_model, dev, stack)
        p["post_ln2"] = _norm_init(cfg, cfg.d_model, dev, stack)
    return p


class Transformer:
    """Dense decoder-only model."""

    def __init__(self, cfg: ModelConfig):
        if cfg.local_global:
            raise NotImplementedError("local/global alternation (gemma2) is "
                                      "not ported yet: ROADMAP queue 1")
        self.cfg = cfg

    # --- parameters -------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Parameters on ``gen``'s device, drawn at the JAX package's shapes
        and scales (its random bits differ: tests carry JAX weights across)."""
        cfg = self.cfg
        dt = cfg.torch_dtype
        p = {
            "embed": layers._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
            "layers": init_block(gen, cfg, stack=(cfg.num_layers,)),
            "final_norm": _norm_init(cfg, cfg.d_model, gen.device),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = layers._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02, dt)
        return p

    # --- helpers ----------------------------------------------------------
    def _embed(self, params, tokens):
        x = params["embed"][tokens]
        if self.cfg.embed_scale:
            x = x * torch.tensor(np.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _logits(self, params, x):
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        logits = _norm(self.cfg, params["final_norm"], x) @ head
        return layers.softcap(logits.float(), self.cfg.final_logit_softcap)
