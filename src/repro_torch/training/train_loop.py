"""Training step and loop, the port of ``repro.training.train_loop``.

``make_train_step(model, opt_cfg)`` builds the step: gradients by
``torch.autograd.grad`` over the flat param leaves, accumulated over
microbatches in explicit f32 buffers (never in bf16 ``.grad``), then
``adamw_update``. ``train`` runs it over numpy batches on the params'
device.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.engine.kv_cache import to_device
from repro_torch.training.optimizer import (AdamWConfig, OptState, adamw_update,
                                            init_opt_state, tree_leaves, tree_unflatten)


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The batch's tensors lie on the params' device. ``microbatches`` > 1
    splits it on axis 0 and runs forward and backward once per part, so
    activation memory scales with global_batch / microbatches; loss and
    grads add up in f32 and are divided by ``microbatches`` at the end.
    ``metrics`` holds 0-d device tensors: ``loss``, ``grad_norm``, ``lr``.
    """

    def loss_and_grads(tree, leaves, batch):
        loss = model.loss(tree, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state: OptState, batch):
        flat = tree_leaves(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        tree = tree_unflatten(params, leaves)
        if microbatches == 1:
            loss, grads = loss_and_grads(tree, leaves, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"{microbatches} microbatches")
            parts = {k: v.chunk(microbatches) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            # each accumulator placed as its param, where params are DTensors
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            for i in range(microbatches):
                l, g = loss_and_grads(tree, leaves, {k: v[i] for k, v in parts.items()})
                loss = loss + l
                for acc, x in zip(grads, g):
                    acc.add_(x)
                del g   # not alive through the next microbatch's backward
            loss /= microbatches
            for acc in grads:
                acc.div_(microbatches)
        params, opt_state, stats = adamw_update(opt_cfg, params,
                                                tree_unflatten(params, grads), opt_state)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def train(model, params, batches, opt_cfg: AdamWConfig | None = None,
          *, log_every: int = 10, checkpoint_fn=None, checkpoint_every: int = 0):
    """Run the train loop over an iterable of numpy batches, each moved to
    the params' device. The device is read only on logged steps."""
    opt_cfg = opt_cfg or AdamWConfig()
    step_fn = make_train_step(model, opt_cfg)
    opt_state = init_opt_state(params, opt_cfg.moments_dtype)
    device = tree_leaves(params)[0].device
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        batch = {k: to_device(v, device) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == 0:
            loss = float(metrics["loss"])
            history.append((i, loss))
            print(f"step {i:5d}  loss {loss:.4f}  gnorm "
                  f"{float(metrics['grad_norm']):.3f}  lr {float(metrics['lr']):.2e}  "
                  f"({time.perf_counter() - t0:.1f}s)")
        if checkpoint_fn and checkpoint_every and i and i % checkpoint_every == 0:
            checkpoint_fn(params, opt_state, i)
    return params, opt_state, history
