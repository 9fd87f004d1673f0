"""Sharding rules: parameter/activation/cache PartitionSpecs.

The port of ``repro.sharding.rules``. 2D layout, MaxText-style: "model" =
tensor parallel (heads / d_ff / vocab), "data" (+ "pod") = FSDP over the
d_model-ish dim of weights and the batch dim of activations. Specs are
derived from parameter *path names* (the "/"-joined keys of the nested param
dicts, which carry the reference's names leaf for leaf) via ordered regex
rules; stacked-layer leading dims ((L,) or (L/2, 2)) get None padding by
rank comparison.

Decode KV caches shard the *sequence* dim over "model" by default: the
assigned GQA configs have 4-8 kv heads, which do not divide the 16-wide
model axis, while 32k sequences always do.

``placements`` and ``distribute_params`` turn a spec into DTensor placements
over a ``DeviceMesh`` and place a params tree with them.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.models.config import ModelConfig


class PartitionSpec(tuple):
    """One entry per leading tensor dim: a mesh axis name, a tuple of them,
    or None (replicated). A tuple, so specs compare equal to the JAX
    package's as tuples; entries are canonical as there: a one-name tuple
    is that name, an empty one None."""

    def __new__(cls, *axes):
        def canon(a):
            if isinstance(a, (tuple, list)):
                return None if not a else a[0] if len(a) == 1 else tuple(a)
            return a
        return super().__new__(cls, (canon(a) for a in axes))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# ordered (regex on "/".joined path, spec for the LOGICAL tensor)
_PARAM_RULES: list[tuple[str, P]] = [
    # embed/head: vocab over model, d_model REPLICATED — putting d over
    # "data" makes GSPMD resolve the embedding-gather conflict by
    # replicating the *batch* instead, which un-shards every activation
    # downstream
    (r"embed$", P("model", None)),                # (V, d): vocab TP
    (r"lm_head$", P(None, "model")),              # (d, V)
    (r"(wq|wk|wv)/w$", P("data", "model")),
    (r"(wq|wk|wv)/b$", P("model")),
    (r"wo/w$", P("model", "data")),
    (r"wo/b$", P("data")),
    (r"(gate|up)/w$", P("data", "model")),        # dense mlp
    (r"(gate|up)/b$", P("model")),
    (r"down/w$", P("model", "data")),
    (r"down/b$", P("data")),
    (r"moe/router$", P("data", None)),
    (r"moe/(gate|up)$", P(None, "data", "model")),  # (E, d, ff)
    (r"moe/down$", P(None, "model", "data")),       # (E, ff, d)
    # mamba2
    (r"in_proj/w$", P("data", "model")),
    (r"conv_w$", P(None, "model")),
    (r"conv_b$", P("model")),
    (r"(A_log|D|dt_bias)$", P("model")),
    (r"out_proj/w$", P("model", "data")),
    (r"mamba/norm/scale$", P("model")),
    # rwkv6
    (r"tm/(wr|wk|wv|wg)$", P("data", "model")),
    (r"tm/wo$", P("model", "data")),
    (r"tm/w_lora_a$", P("data", None)),
    (r"tm/w_lora_b$", P(None, "model")),
    (r"tm/u$", P("model", None)),
    (r"tm/(mix|w_base)$", P()),
    (r"tm/ln/scale$", P()),
    (r"cm/wk$", P("data", "model")),
    (r"cm/wv$", P("model", "data")),
    (r"cm/wr$", P("data", None)),
    (r"cm/mix$", P()),
    # norms & everything 1-D defaults to replicated
    (r".*", P()),
]


DEFAULT_MESH_SHAPE = {"data": 16, "model": 16}


def param_spec(path: str, leaf, mesh_shape: dict[str, int] | None = None) -> P:
    """The spec of the leaf at ``path`` (its "/"-joined keys)."""
    mesh_shape = mesh_shape or DEFAULT_MESH_SHAPE
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            pad = leaf.ndim - len(spec)
            assert pad >= 0, f"spec {spec} longer than tensor rank for {path}"
            full = [None] * pad + list(spec)
            # axes that do not divide their dimension (e.g. granite's vocab
            # 49155 over 16-wide "model") are relocated to another dividing
            # dim, else dropped (replicated)
            shape = leaf.shape
            dropped = []
            for i, ax in enumerate(full):
                if ax is None:
                    continue
                size = mesh_shape.get(ax, 1)
                if shape[i] % size:
                    full[i] = None
                    dropped.append(ax)
            # embeddings stay replicated when vocab doesn't divide (the
            # reference's rule: sharding d_model instead trips an XLA SPMD
            # gather-partitioner bug under autodiff)
            if not path.endswith("embed"):
                for ax in dropped:
                    for i, cur in enumerate(full):
                        if cur is None and shape[i] % mesh_shape.get(ax, 1) == 0 \
                                and shape[i] >= mesh_shape.get(ax, 1):
                            full[i] = ax
                            break
            return P(*full)
    raise AssertionError("unreachable")


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, the same tree back."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, mesh_shape: dict[str, int] | None = None,
                weight_mode: str = "fsdp_tp") -> dict:
    """Nested dict of PartitionSpecs matching a params tree.

    weight_mode:
      fsdp_tp    — 2D: d_model-ish over "data" + TP over "model" (training
                   default; minimal weight memory, per-layer all-gathers).
      tp_only    — drop the "data" axis from weights (replicate across data
                   rows). Serving mode: no optimizer state to hold, and the
                   per-step FSDP all-gather traffic disappears.
      replicated — fully replicated weights (small models): batch-parallel
                   serving with zero weight collectives.
    """
    if weight_mode not in ("fsdp_tp", "tp_only", "replicated"):
        raise ValueError(f"unknown weight_mode {weight_mode!r}")

    def spec(path, leaf):
        s = param_spec(path, leaf, mesh_shape)
        if weight_mode == "fsdp_tp":
            return s
        if weight_mode == "tp_only":
            return P(*[None if ax == "data" else ax for ax in s])
        return P(*([None] * len(s)))  # replicated

    return _map_with_path(spec, params)


# ---------------------------------------------------------------------------
# activations / inputs / caches
# ---------------------------------------------------------------------------

def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


def batch_axis(batch: int, multi_pod: bool, mesh_shape: dict[str, int]):
    """Largest dp prefix that divides the batch (None if batch=1)."""
    axes = []
    prod = 1
    for a in dp_axes(multi_pod):
        if batch % (prod * mesh_shape[a]) == 0:
            axes.append(a)
            prod *= mesh_shape[a]
    return tuple(axes) if axes else None


def batch_spec(cfg: ModelConfig, shape_kind: str, batch: int, multi_pod: bool,
               mesh_shape: dict[str, int]) -> dict:
    """Input shardings for a workload batch dict."""
    b = batch_axis(batch, multi_pod, mesh_shape)
    specs = {"tokens": P(b, None)}
    if cfg.frontend == "vision":
        specs["frontend_embeds"] = P(b, None, None)
    if cfg.family == "audio":
        specs["frontend_embeds"] = P(b, None, None)
    if shape_kind == "train":
        specs["labels"] = P(b, None)
    return specs


def cache_specs(cfg: ModelConfig, cache, batch: int, multi_pod: bool,
                mesh_shape: dict[str, int], *, seq_shard: str | None = "model") -> dict:
    """PartitionSpecs for a decode cache dict (by key name + rank)."""
    b = batch_axis(batch, multi_pod, mesh_shape)
    # with batch unshardable (long_500k, B=1) extend the seq sharding to dp too
    seq_axes: tuple = (seq_shard,) if seq_shard else ()
    if b is None:
        seq_axes = tuple(dp_axes(multi_pod)) + seq_axes

    def spec_for(key: str, leaf):
        C = leaf.shape
        if key == "pos" or key == "enc_lens":
            return P(None)
        if key in ("conv",):                 # (L, B, K-1, conv_dim)
            return P(None, b, None, "model")
        if key in ("ssm",):                  # (L, B, nh, hd, ns)
            return P(None, b, "model", None, None)
        if key in ("tm_x", "cm_x"):          # (L, B, d)
            return P(None, b, None)
        if key == "wkv":                     # (L, B, H, hd, hd)
            return P(None, b, "model", None, None)
        if key.startswith(("k", "v", "self_", "cross_", "attn_")):
            # (L, B, C, Hkv, hd): shard the sequence dim
            sa = seq_axes if seq_axes else None
            divisor = int(np.prod([mesh_shape[a] for a in (seq_axes or ())]))
            if divisor and C[2] % max(divisor, 1) == 0 and C[2] >= max(divisor, 1):
                return P(None, b, sa, None, None)
            return P(None, b, None, None, None)
        return P(*([None] * leaf.ndim))

    return {k: spec_for(k, v) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec, mesh: DeviceMesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dim:
    ``Shard(i)`` where tensor dim i names that mesh dim, else
    ``Replicate()``. A tuple entry such as ("pod", "data") shards one tensor
    dim over several mesh dims, major to minor; they must come in mesh order
    (the order the rules produce), as DTensor splits a dim that several mesh
    dims shard in mesh order."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not a dim of mesh {names}")
            if not isinstance(out[names.index(ax)], Replicate):
                raise ValueError(f"spec {spec} names mesh dim {ax!r} twice")
            idx.append(names.index(ax))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} shards dim {i} over {axes}, out of the "
                             f"mesh's order {names}")
        for j in idx:
            out[j] = Shard(i)
    return out


def distribute_params(params, mesh: DeviceMesh, specs) -> dict:
    """The params tree as DTensors over ``mesh``, each leaf placed by its
    spec (``param_specs`` of the same tree)."""
    if isinstance(params, dict):
        return {k: distribute_params(v, mesh, specs[k]) for k, v in params.items()}
    assert isinstance(params, torch.Tensor), type(params)
    return distribute_tensor(params, mesh, placements(specs, mesh))
