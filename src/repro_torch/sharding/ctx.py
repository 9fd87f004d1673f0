"""Logical activation-sharding annotations (MaxText-style).

The port of ``repro.sharding.ctx``. Models call ``constrain(x, "act_btd")``
at a few key points (embedding output, layer carry, logits). Outside
``activate``, and on a plain tensor, this is the identity, so single-device
code paths are untouched; inside, a ``DTensor`` is redistributed to the
placements of the spec its logical name maps to.

Why needed: with a vocab-sharded embedding the lookup's output can come back
batch-replicated, which un-shards every downstream activation; one
constraint at the embedding output pins the batch axis.
"""
from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import DTensor

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


def standard_mapping(batch_axes) -> dict[str, P]:
    """batch_axes: tuple of mesh axes for the global-batch dim (or None)."""
    b = batch_axes
    return {
        "act_btd": P(b, None, None),   # (batch, seq, d_model)
        "logits_btv": P(b, None, "model"),
        "act_bd": P(b, None),
    }
