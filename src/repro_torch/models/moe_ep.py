"""Expert-parallel MoE over ``torch.distributed`` all-to-all.

The port of ``repro.models.moe_ep``. The default ``moe.moe_mlp`` keeps every
expert on every device; this module is the classic expert-parallel layout
for models whose per-expert slab fits one device (granite: 40 experts,
padded to 48, 3 per device at ~4.7 MB each on a 16-wide axis):

  tokens split over the ranks -> local top-k routing -> per-peer capacity
  buffers -> all-to-all over the expert group -> local expert FFNs ->
  all-to-all back -> local weighted combine.

``moe_mlp_ep`` is the SPMD body of the reference's ``shard_map`` function,
called once on each rank of ``group`` with that rank's tokens and experts.
Experts are padded to a multiple of the group size ("dead expert" slots with
-1e30 router logits). Every step follows the reference, so both drop the
same choices:

* router logits and softmax in f32, top-k with ties toward the lower expert
  index (a stable descending sort, as ``models.moe._route`` takes);
* capacity ``C = ceil(T_loc * k / A * cf)`` per (source, destination peer),
  filled in token-major, choice-rank order; drops go to the trash slot
  ``A * C``;
* the combine in f32 with the gates of dropped choices zeroed.

Two things differ in form, not in function. The reference exchanges expert
ids and a bool "slot filled" mask apart; here one int32 tensor carries both
(an empty slot holds the sentinel id ``E_loc``), so a call makes three
collectives: rows out, ids out, rows back. And the reference's expert FFNs
are one-hot einsums dense over all local experts and all A * C received
slots; here each local expert runs over a buffer of its own received rows,
batched over the local experts. A buffer holds ``min(A * C, A * T_loc)``
rows: no more than A * C rows arrive, and a source sends an expert each of
its T_loc tokens at most once (a token's k choices are distinct experts), so
no row is ever dropped there. At granite's full width on one rank that is
6x the rows the experts need (k = 8 of 48 slabs), where the dense form does
96x. No step waits for the device: ``C`` and the buffers depend on shapes
only.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

DEAD_LOGIT = -1e30


def pad_experts(p, cfg: ModelConfig, axis_size: int):
    """Pad expert-stacked weights (E, ...) to a multiple of ``axis_size``:
    zero ``gate``/``up``/``down`` slabs and zero router columns."""
    E = cfg.num_experts
    E_pad = -(-E // axis_size) * axis_size
    if E_pad == E:
        return p, E_pad
    pad = E_pad - E
    out = dict(p)
    for key in ("gate", "up", "down"):
        out[key] = F.pad(p[key], (0, 0, 0, 0, 0, pad))
    out["router"] = F.pad(p["router"], (0, pad))
    return out, E_pad


def route(router, x, cfg: ModelConfig):
    """x (..., d), router (d, E_pad) -> renormalised top-k gates and expert
    ids (..., k) over the padded experts; the dead ones never win."""
    E = router.shape[-1]
    logits = x.float() @ router.float()
    dead = torch.arange(E, device=x.device) >= cfg.num_experts
    logits = logits.masked_fill(dead, DEAD_LOGIT)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, eidx = srt.values[..., :k], srt.indices[..., :k]
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def _exchange(t, group):
    """Equal-split all-to-all: block i of ``t``'s rows goes to peer i, block
    j of the result came from peer j."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    moe_mlp_ep.collectives += 1
    return out


def _expert_ffn(xb, p_local):
    """SwiGLU of each local expert over its buffer: xb (E_loc, cap, d)."""
    h = F.silu(torch.bmm(xb, p_local["gate"])) * torch.bmm(xb, p_local["up"])
    return torch.bmm(h, p_local["down"])


def moe_mlp_ep(p_local, x_local, cfg: ModelConfig, group, *,
               capacity_factor: float | None = None):
    """x_local (..., d) -> (..., d) on this rank. ``p_local`` holds the
    padded router (d, E_pad), replicated, and this rank's ``E_pad / A``
    expert slabs of ``gate``/``up`` (E_loc, d, ff) and ``down`` (E_loc, ff,
    d): rank r holds experts [r E_loc, (r + 1) E_loc)."""
    if group is None or not dist.is_initialized():
        raise RuntimeError("moe_mlp_ep needs a torch.distributed process group")
    shape, d = x_local.shape, x_local.shape[-1]
    x_loc = x_local.reshape(-1, d)
    T_loc = x_loc.shape[0]
    A = dist.get_world_size(group)
    E_loc = p_local["gate"].shape[0]
    E = p_local["router"].shape[1]
    assert E == A * E_loc, f"pad_experts first: {E} experts over {A} ranks x {E_loc}"
    k = cfg.experts_per_token
    cf = capacity_factor or cfg.moe_capacity_factor
    C = max(1, int(np.ceil(T_loc * k / A * cf)))   # per (source, destination peer)
    dev = x_loc.device

    gates, eidx = route(p_local["router"], x_loc, cfg)              # (T_loc, k)
    dest = (eidx // E_loc).reshape(T_loc * k)
    # each choice's place among the choices bound for the same peer, in
    # token-major, choice-rank order (the cumsum scans the innermost dim)
    onehot = (torch.arange(A, device=dev)[:, None] == dest[None]).int()   # (A, T_loc*k)
    pos_in = (onehot.cumsum(dim=-1) - 1).gather(0, dest[None])[0]
    keep = pos_in < C
    slot = torch.where(keep, dest * C + pos_in, A * C)              # A*C = trash slot

    tok_of = torch.arange(T_loc * k, device=dev) // k
    send_tok = torch.full((A * C + 1,), T_loc, dtype=torch.long, device=dev)
    send_tok = send_tok.scatter_(0, slot, tok_of)[: A * C]
    send_el = torch.full((A * C + 1,), E_loc, dtype=torch.int32, device=dev)
    send_el = send_el.scatter_(0, slot, (eidx % E_loc).reshape(-1).int())[: A * C]
    x_pad = torch.cat([x_loc, x_loc.new_zeros(1, d)])
    recv_x = _exchange(x_pad[send_tok], group)                      # (A*C, d)
    recv_el = _exchange(send_el, group)                             # E_loc = empty slot

    # each local expert over a buffer of its own received rows, placed in
    # arrival order; empty slots go to the trash row E_loc * cap
    cap = min(A * C, A * T_loc)
    onehot = (torch.arange(E_loc, device=dev)[:, None] == recv_el[None]).int()  # (E_loc, A*C)
    pos = (onehot.cumsum(dim=-1) - 1).gather(0, recv_el.clamp(max=E_loc - 1).long()[None])[0]
    bslot = torch.where(recv_el < E_loc, recv_el * cap + pos, E_loc * cap).long()
    row_of = torch.full((E_loc * cap + 1,), A * C, dtype=torch.long, device=dev)
    row_of = row_of.scatter_(0, bslot, torch.arange(A * C, device=dev))[: E_loc * cap]
    recv_pad = torch.cat([recv_x, recv_x.new_zeros(1, d)])
    y = _expert_ffn(recv_pad[row_of].reshape(E_loc, cap, d), p_local)
    y = torch.cat([y.reshape(E_loc * cap, d), y.new_zeros(1, d)])
    out = y[bslot]                                                  # (A*C, d)

    back = _exchange(out, group)                                    # to the senders
    back = torch.cat([back, back.new_zeros(1, d)])
    per_choice = back[slot].reshape(T_loc, k, d)
    w = (gates * keep.reshape(T_loc, k)).float()
    y = (per_choice.float() * w[..., None]).sum(1)
    return y.to(x_local.dtype).reshape(shape)


moe_mlp_ep.collectives = 0


def moe_ep_ref(p_padded, x, cfg: ModelConfig):
    """Single-device oracle with the same padded-expert routing (top-k over
    padded logits, no capacity drops): every expert on every token."""
    gates, eidx = route(p_padded["router"], x, cfg)
    h = F.silu(torch.einsum("bsd,edf->bsef", x, p_padded["gate"]))
    h = h * torch.einsum("bsd,edf->bsef", x, p_padded["up"])
    allout = torch.einsum("bsef,efd->bsed", h, p_padded["down"]).float()
    sel = allout.gather(2, eidx[..., None].expand(-1, -1, -1, allout.shape[-1]))
    return (sel * gates[..., None]).sum(2).to(x.dtype)
