"""Attention-backend dispatch shared by the engine and the kernel wrappers.

Backends (threaded through ``ServingEngine`` and ``PoolRuntime``):

* ``"cuda"`` — the hand-written Hopper kernels in ``csrc/`` (flash prefill
  and paged decode), built by ``kernels.build`` on first use.
* ``"ref"``  — the plain PyTorch versions in ``*/ref.py``, on any device.
* ``"auto"`` — ``"cuda"`` on a CUDA device, ``"ref"`` on the CPU.

``auto`` never turns a CUDA request into the CPU, and ``ref`` on a CUDA
device is taken only when asked for by name.
"""
from __future__ import annotations

import torch

BACKENDS = ("auto", "cuda", "ref")


def resolve_backend(backend: str = "auto", device="cuda") -> str:
    """Collapse ``"auto"`` to a concrete backend for ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "cuda" if on_cuda else "ref"
    if backend == "cuda" and not on_cuda:
        raise ValueError(f"backend 'cuda' needs a CUDA device, got {device!r}")
    return backend


def require_device(device) -> torch.device:
    """The entry points' device check: a CUDA device must exist when asked
    for. There is no fallback to the CPU; pass ``device="cpu"`` for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device
