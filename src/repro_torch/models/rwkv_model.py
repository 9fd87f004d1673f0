"""RWKV6 model, the port of ``repro.models.rwkv_model``: embed, then [time
mix + channel mix] x L, then the head.

The decode state is constant in size (token-shift vectors and per-head WKV
matrices), so prefill and decode share one forward path (decode is a prefill
of one token). This family runs no kernel: neither package has one for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import require_device
from repro_torch.models import layers, rwkv6
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _tree_unbind, remat_call


class RWKVModel:
    """``remat``: under autograd each layer is recomputed in the backward, as
    the reference's scan body."""

    def __init__(self, cfg: ModelConfig, *, remat: bool = True, **_):
        self.cfg = cfg
        self.remat = remat

    def init(self, gen: torch.Generator):
        """Parameters on ``gen``'s device, at the JAX package's shapes and
        scales (its random bits differ: tests carry JAX weights across)."""
        cfg = self.cfg
        dt, dev, L = cfg.torch_dtype, gen.device, (cfg.num_layers,)
        return {
            "embed": layers._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
            "layers": {"ln1": layers.init_rmsnorm(cfg.d_model, dt, dev, L),
                       "ln2": layers.init_rmsnorm(cfg.d_model, dt, dev, L),
                       "body": rwkv6.init_rwkv(gen, cfg, L)},
            "final_norm": layers.init_rmsnorm(cfg.d_model, dt, dev),
            "lm_head": layers._normal(gen, (cfg.d_model, cfg.vocab_size), 0.02, dt),
        }

    def init_cache(self, batch_size: int, cache_len: int = 0, prefilled_len: int = 0, *,
                   device="cuda"):
        """A zero state on ``device``; ``cache_len`` does not matter to a
        recurrent model."""
        dev = require_device(device)
        st = rwkv6.init_rwkv_state(self.cfg, batch_size, dev)
        st = {k: a.expand(self.cfg.num_layers, *a.shape).clone() for k, a in st.items()}
        st["pos"] = torch.full((batch_size,), prefilled_len, dtype=torch.int32, device=dev)
        return st

    def _layer(self, lp, x, tm_x, cm_x, wkv):
        cfg = self.cfg
        h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, tm_x, wkv = rwkv6.time_mix(lp["body"]["tm"], h, cfg, tm_x, wkv)
        x = x + out
        h = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        out, cm_x = rwkv6.channel_mix(lp["body"]["cm"], h, cfg, cm_x)
        return x + out, tm_x, cm_x, wkv

    def _forward(self, params, x, state):
        """All layers from ``state``; returns (x, the new state, stacked)."""
        new = {"tm_x": [], "cm_x": [], "wkv": []}
        for i, lp in enumerate(_tree_unbind(params["layers"])):
            x, tm_x, cm_x, wkv = remat_call(self.remat, self._layer, lp, x, state["tm_x"][i],
                                            state["cm_x"][i], state["wkv"][i])
            for k, a in zip(("tm_x", "cm_x", "wkv"), (tm_x, cm_x, wkv)):
                new[k].append(a)
        return x, {k: torch.stack(v) for k, v in new.items()}

    def _logits(self, params, x):
        x = layers.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return (x @ params["lm_head"]).float()

    def prefill(self, params, batch, cache_len: int = 0):
        """batch: tokens (B,S) [+ lengths (B,)]. Returns (last-token logits
        (B,V) f32, state). As in the reference, the state is that after the
        padded length of every row."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = params["embed"][tokens]
        x, state = self._forward(params, x, self.init_cache(B, device=x.device))
        lens = batch.get("lengths")
        lens = (torch.full((B,), S, dtype=torch.int32, device=x.device) if lens is None
                else torch.as_tensor(lens, dtype=torch.int32, device=x.device))
        last = x[torch.arange(B, device=x.device), lens.long() - 1]
        state["pos"] = lens
        return self._logits(params, last), state

    def decode_step(self, params, tokens, cache):
        """tokens (B,) integer. Returns (logits (B,V) f32, the new state)."""
        x = params["embed"][tokens[:, None]]
        x, state = self._forward(params, x, cache)
        state["pos"] = cache["pos"] + 1
        return self._logits(params, x[:, 0]), state

    def loss(self, params, batch):
        """batch: tokens (B,S), labels (B,S) with -1 ignored."""
        tokens = batch["tokens"]
        x = params["embed"][tokens]
        x, _ = self._forward(params, x, self.init_cache(tokens.shape[0], device=x.device))
        return layers.cross_entropy_loss(self._logits(params, x), batch["labels"])
