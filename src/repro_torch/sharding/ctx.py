"""Logical activation-sharding annotations (MaxText-style).

The port of ``repro.sharding.ctx``. Models call ``constrain(x, "act_btd")``
at a few key points (embedding output, layer carry, logits). Outside
``activate``, and on a plain tensor, this is the identity, so single-device
code paths are untouched; inside, a ``DTensor`` is redistributed to the
placements of the spec its logical name maps to.

Why needed: with a vocab-sharded embedding the lookup's output can come back
batch-replicated, which un-shards every downstream activation; one
constraint at the embedding output pins the batch axis.

The other four helpers do what GSPMD does on its own and DTensor does not,
so that the model bodies run over DTensors (``launch.dryrun``); each is the
identity on a plain tensor. ``heads_ready`` replicates a dim whose shards do
not divide its head count before it is split into heads, ``reduce_partial``
reduces a product's partial sums where it is made, ``local_contiguous``
lays out an einsum's operand as its plan assumes, and ``write_slots_``
writes each row's new cache entry on the rank that holds its slot.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.sharding.rules import PartitionSpec as P, placements

_state = threading.local()


@contextlib.contextmanager
def activate(mapping: dict[str, P]):
    prev = getattr(_state, "mapping", None)
    _state.mapping = mapping
    try:
        yield
    finally:
        _state.mapping = prev


def constrain(x, name: str):
    mapping = getattr(_state, "mapping", None)
    if not mapping or name not in mapping or not isinstance(x, DTensor):
        return x
    spec = mapping[name]
    if spec is None:
        return x
    # the named spec covers the leading dims and is padded to the rank
    pad = x.ndim - len(spec)
    if pad < 0:
        return x
    return x.redistribute(x.device_mesh, placements(P(*spec, *([None] * pad)),
                                                    x.device_mesh))


def _ready_placements(x, heads: int, dim: int) -> list:
    mesh, dim = x.device_mesh, dim % x.ndim
    out, split = list(x.placements), 1
    for i, pl in enumerate(out):
        if isinstance(pl, Shard) and pl.dim % x.ndim == dim:
            if heads % (split * mesh.size(i)):
                out[i] = Replicate()
            else:
                split *= mesh.size(i)
    return out


class _ReadyGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient ready as well: the
    backward of a flatten of (heads, ...) views the gradient back into
    heads."""

    @staticmethod
    def forward(ctx, x, heads, dim):
        ctx.heads, ctx.dim = heads, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return heads_ready(g, ctx.heads, ctx.dim), None, None


def heads_ready(x, heads: int, dim: int = -1):
    """``x`` placed so that its ``dim`` can be split into ``heads`` parts
    (a projection (..., heads * head_dim) into heads, or GQA's Hq into (Hkv,
    group)), or flattened when it holds ``heads`` (40 experts over 16
    shards cannot be), and so is its gradient, which the backward of a
    flatten splits: every mesh dim that shards ``dim`` and, with those
    before it, does not divide ``heads`` is replicated (tinyllama's 4 KV
    heads over a 16-wide "model" axis, say). The identity on a plain
    tensor."""
    if not isinstance(x, DTensor):
        return x
    out = _ready_placements(x, heads, dim)
    if out != list(x.placements):
        x = x.redistribute(x.device_mesh, out)
    return _ReadyGrad.apply(x, heads, dim) if x.requires_grad else x


def reduce_partial(x):
    """``x`` with every partial sum over a mesh dim reduced (replicated
    there), as GSPMD reduces a dot's partial sums at the dot; DTensor would
    carry them on through linear ops and choose its next op's layout by
    them. The identity on a plain tensor."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def local_contiguous(x):
    """``x`` laid out contiguously when it is a DTensor: DTensor plans a
    composite op's views (einsum's) on the global strides and runs them on
    the local shards, and from a permuted layout (an einsum's output, as the
    MoE's expert products take it) such a view fails. The identity on a
    plain tensor, which einsum copies as it needs."""
    if not isinstance(x, DTensor) or x.is_contiguous():
        return x
    return x.contiguous()


def write_slots_(dst, slots, src):
    """``dst[b, slots[b]] = src[b]`` for every row b, in place: dst (B, C,
    ...), slots (B,) integer, src (B, ...). On DTensors every rank writes
    the rows it holds, each where its slot falls in the rank's share of C
    (the partitioned scatter GSPMD makes of the reference's ``.at[].set``);
    src and slots are replicated first."""
    if not isinstance(dst, DTensor):
        dst[torch.arange(dst.shape[0], device=dst.device), slots] = src.to(dst.dtype)
        return dst
    mesh = dst.device_mesh
    whole = [Replicate()] * mesh.ndim
    src, slots = (t.redistribute(mesh, whole).to_local() if isinstance(t, DTensor) else t
                  for t in (src, slots))
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh, dst.placements)
    (n, c), (b0, c0) = shape[:2], offset[:2]
    local = dst.to_local()
    rows = torch.arange(n, device=local.device)
    s = slots[b0:b0 + n].long() - c0
    mine = (s >= 0) & (s < c)
    s = s.clamp(0, c - 1)   # a row whose slot is elsewhere writes back its own entry
    keep = mine.reshape(-1, *([1] * (local.ndim - 2)))
    local[rows, s] = torch.where(keep, src[b0:b0 + n].to(local.dtype), local[rows, s])
    return dst


def standard_mapping(batch_axes) -> dict[str, P]:
    """batch_axes: tuple of mesh axes for the global-batch dim (or None)."""
    b = batch_axes
    return {
        "act_btd": P(b, None, None),   # (batch, seq, d_model)
        "logits_btv": P(b, None, "model"),
        "act_bd": P(b, None),
    }
