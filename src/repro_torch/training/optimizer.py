"""AdamW and its learning-rate schedule, the port of
``repro.training.optimizer``: plain functions on nested dicts of tensors.

Moments are kept in f32 (or ``moments_dtype``) whatever the param dtype; the
update is computed in f32 and cast once to each param's dtype, as the
reference's is (``torch.optim.AdamW`` would update bf16 params in bf16 and
has no global clip or schedule). Every value is a device tensor, so a step
makes no host sync.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"  # "bfloat16" halves the optimizer's memory


class OptState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the params' device
    mu: Any
    nu: Any


def tree_paths(tree, path: tuple = ()):
    """(path, leaf) of every leaf of nested dicts and NamedTuples, in
    insertion order. A path names dict keys as they are and NamedTuple
    fields as ``.field``, as ``jax.tree_util`` prints them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from tree_paths(getattr(tree, name), path + (f".{name}",))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, n)) for n in t._fields))
        return next(it)
    return build(like)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``
    at ``total_steps``; f32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, moments_dtype: str = "float32") -> OptState:
    dt = getattr(torch, moments_dtype)
    leaves = tree_leaves(params)
    zeros = [torch.zeros(p.shape, dtype=dt, device=p.device) for p in leaves]
    return OptState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                    mu=tree_unflatten(params, zeros),
                    nu=tree_unflatten(params, [z.clone() for z in zeros]))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState):
    """Returns (new_params, new_state, stats): the global-norm clip, then
    AdamW with bias correction and decoupled weight decay on every leaf."""
    gnorm = global_norm(grads)
    # a true division (``float / tensor`` would multiply by a reciprocal)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        mdt = m.dtype
        g = g.float() * scale
        m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        mh = m / b1c
        vh = v / b2c
        delta = mh / (vh.sqrt() + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m.to(mdt), v.to(mdt)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu))]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    return (tree_unflatten(params, new_p),
            OptState(step, tree_unflatten(params, new_m), tree_unflatten(params, new_v)),
            {"grad_norm": gnorm, "lr": lr})
