"""Checkpoints: params and optimizer state -> ``.npz``, in the reference's
format key for key (``repro.training.checkpoint``), so that a file written
by either package restores in the other.

Keys: ``p:<path>`` for params (``p:embed``, ``p:layers/attn/wq/w``, ...),
``o:<path>`` for the optimizer state (``o:.step``, ``o:.mu/<path>``,
``o:.nu/<path>``: a NamedTuple field prints as ``.field``) and
``meta:step``. bf16 leaves are stored upcast to f32; ``restore`` casts each
array back to the dtype and device of the like-tree's leaf.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.training.optimizer import tree_paths, tree_unflatten


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for path, leaf in tree_paths(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:   # numpy has no bfloat16
            t = t.float()
        flat["/".join(path)] = t.numpy()
    return flat


def save(path: str, params, opt_state=None, step: int | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"p:{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"o:{k}": v for k, v in _flatten(opt_state).items()})
    if step is not None:
        payload["meta:step"] = np.asarray(step)
    np.savez(path, **payload)


def restore(path: str, params_like, opt_like=None):
    """Returns (params, opt_state|None, step|None) with ``*_like`` structure."""
    with np.load(path) as data:
        def fill(tree, prefix):
            leaves = []
            for p, like in tree_paths(tree):
                key = f"{prefix}:{'/'.join(p)}"
                if key not in data:
                    raise KeyError(f"checkpoint missing {key}")
                arr = data[key]
                if arr.shape != tuple(like.shape):
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{arr.shape} vs {tuple(like.shape)}")
                leaves.append(torch.from_numpy(arr).to(device=like.device, dtype=like.dtype))
            return tree_unflatten(tree, leaves)

        params = fill(params_like, "p")
        opt = fill(opt_like, "o") if opt_like is not None else None
        step = int(data["meta:step"]) if "meta:step" in data else None
    return params, opt, step
