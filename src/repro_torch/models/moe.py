"""Mixture-of-Experts MLP with group-local capacity dispatch.

The port of ``repro.models.moe``: tokens are split into G groups and each
group dispatches into per-expert capacity buffers by int scatter/gather
(the GShard/Switch "dropping" formulation with local capacity). A choice
past its expert's capacity is dropped: that token keeps only the other
choices' outputs (and the residual).

Every step follows the reference, so the two agree choice for choice:

* router logits and softmax in f32, then top-k with ties broken toward the
  lower expert index, as ``jax.lax.top_k`` breaks them (``torch.topk``
  promises no order among ties, so this takes a stable descending sort);
* capacity priority in token-major, choice-rank order (a cumsum over the
  flattened Tg * k choices of a one-hot per expert), drops into the trash
  slot ``E * C``;
* the expert FFNs batched over E (dense over the experts: every expert's
  weights are read once per call, as the reference's einsums read them);
* the combine in f32 with the gate weights of dropped choices zeroed.

No step waits for the device: the one-hot is a comparison, and the
scatter, gathers and cumsum are index kernels on the device. The reference
computes all of this in XLA outside any Pallas kernel, and so this module
holds no kernel: the expert products are library batched GEMMs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_moe(gen: torch.Generator, cfg: ModelConfig, stack: tuple = ()):
    """Router and expert weights at the reference's shapes and scales, with
    ``stack`` leading axes on every leaf."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = cfg.torch_dtype
    return {
        "router": layers._normal(gen, (*stack, d, E), 0.02, dt),
        "gate": layers._normal(gen, (*stack, E, d, ff), 0.02, dt),
        "up": layers._normal(gen, (*stack, E, d, ff), 0.02, dt),
        "down": layers._normal(gen, (*stack, E, ff, d),
                               0.02 / np.sqrt(2 * cfg.num_layers), dt),
    }


def _pick_groups(T: int, preferred: int) -> int:
    g = min(preferred, T)
    while T % g:
        g -= 1
    return max(g, 1)


def capacity(Tg: int, cfg: ModelConfig) -> int:
    """Slots per expert in a group of ``Tg`` tokens (the reference's float
    arithmetic, so both packages drop the same choices)."""
    C = max(1, int(np.ceil(Tg * cfg.experts_per_token / cfg.num_experts
                           * cfg.moe_capacity_factor)))
    return min(C, Tg)


def _route(p, x, k: int):
    """f32 router logits, softmax probabilities and the renormalised top-k
    gates and expert ids, ties toward the lower id."""
    logits = torch.einsum("...d,de->...e", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = srt.values[..., :k], srt.indices[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, eidx


def moe_mlp(p, x, cfg: ModelConfig, *, groups: int = 16):
    """x: (B, S, d) -> ((B, S, d), aux): ``moe_dispatch`` plus the Switch
    load-balance loss, which training needs and serving does not."""
    out, probs, eidx = moe_dispatch(p, x, cfg, groups=groups)
    return out, aux_loss(probs, eidx, cfg.num_experts)


def moe_dispatch(p, x, cfg: ModelConfig, *, groups: int = 16):
    """x: (B, S, d) -> (out (B, S, d), router probs (G, Tg, E), expert ids
    (G, Tg, k)). ``groups`` should divide the tokens evenly; the largest
    divisor of B * S not above it is taken."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    G = _pick_groups(T, groups)
    Tg = T // G
    C = capacity(Tg, cfg)
    dev = x.device

    xt = x.reshape(G, Tg, d)
    probs, gates, eidx = _route(p, xt, k)                        # (G,Tg,k)

    # position of each (token, choice) within its expert's capacity buffer:
    # the one-hot is laid out (G, E, Tg*k) so that the cumsum scans the
    # innermost dim (a scan across an outer dim of only E columns took most
    # of a full-width prefill's device time)
    e_flat = eidx.reshape(G, Tg * k)
    onehot = (torch.arange(E, device=dev)[:, None] == e_flat[:, None, :]).int()
    pos = onehot.cumsum(dim=-1) - 1                              # (G,E,Tg*k)
    pos_in_e = pos.gather(1, e_flat[:, None, :])[:, 0]
    keep = pos_in_e < C                                          # capacity drop
    slot = torch.where(keep, e_flat * C + pos_in_e, E * C)       # E*C = trash slot

    # scatter token ids into (E*C + 1) slots, then gather token features
    tok_of_choice = (torch.arange(Tg * k, device=dev) // k).expand(G, -1)
    buf = torch.full((G, E * C + 1), Tg, dtype=torch.long, device=dev)  # Tg = dummy token
    buf.scatter_(1, slot, tok_of_choice)
    sel = buf[:, : E * C].reshape(G, E, C)                       # token id per slot
    x_pad = torch.cat([xt, xt.new_zeros(G, 1, d)], dim=1)
    gi = torch.arange(G, device=dev)[:, None, None]
    ein = x_pad[gi, sel]                                         # (G,E,C,d)

    # expert FFNs, batched over E
    h = F.silu(torch.einsum("gecd,edf->gecf", ein, p["gate"]))
    h = h * torch.einsum("gecd,edf->gecf", ein, p["up"])
    eout = torch.einsum("gecf,efd->gecd", h, p["down"])          # (G,E,C,d)

    # combine: route expert outputs back to tokens with gate weights
    eout_flat = torch.cat([eout.reshape(G, E * C, d), eout.new_zeros(G, 1, d)], dim=1)
    per_choice = eout_flat[torch.arange(G, device=dev)[:, None], slot]  # (G,Tg*k,d)
    w = (gates.reshape(G, Tg * k) * keep).float()
    out = (per_choice.float() * w[..., None]).reshape(G, Tg, k, d).sum(2)
    return out.reshape(B, S, d).to(x.dtype), probs, eidx


def aux_loss(probs, eidx, E: int):
    """Switch-style load-balance auxiliary loss (mean over groups)."""
    top1 = (eidx[..., 0, None] == torch.arange(E, device=eidx.device)).float()
    frac_tokens = top1.mean(dim=1)                               # top-1 assignment
    frac_probs = probs.mean(dim=1)
    return (E * (frac_tokens * frac_probs).sum(-1)).mean()


def moe_ref(p, x, cfg: ModelConfig):
    """Dense plain version: every expert on every token, no capacity (the
    oracle of the tests)."""
    _, gates, eidx = _route(p, x, cfg.experts_per_token)
    h = F.silu(torch.einsum("bsd,edf->bsef", x, p["gate"]))
    h = h * torch.einsum("bsd,edf->bsef", x, p["up"])
    allout = torch.einsum("bsef,efd->bsed", h, p["down"]).float()   # (B,S,E,d)
    sel = allout.gather(2, eidx[..., None].expand(-1, -1, -1, allout.shape[-1]))
    return (sel * gates[..., None]).sum(2).to(x.dtype)
