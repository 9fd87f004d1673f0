"""Weights carried across from the JAX package.

``params_from_jax`` takes a JAX params pytree as numpy arrays (the ``init``
of any ``repro`` model: nested dicts with the layers stacked on axis 0, or
on (L/2, 2) for gemma2's local/global pairs; zamba2's ``mamba_layers``
stacked and its one ``shared_attn``; whisper's ``enc_layers`` and
``dec_layers``; a tied embedding and no ``lm_head`` where the config ties
them) and returns the port's params: the same names and layout, leaf for
leaf, as torch tensors. This module
imports nothing of JAX: the caller converts leaves with ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def params_from_jax(np_params, cfg: ModelConfig, device="cpu"):
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``, in ``cfg.torch_dtype`` but where a leaf is float32: those
    stay float32, as the reference keeps some leaves of a bf16 model in f32
    (mamba2's A_log, D and dt_bias, rwkv6's w_base and u). bf16 leaves arrive
    as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so each
    leaf goes through float32 (exact for bf16 and f32) first."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, cfg, device) for k, v in np_params.items()}
    leaf = np.asarray(np_params)
    dtype = torch.float32 if leaf.dtype == np.float32 else cfg.torch_dtype
    return torch.from_numpy(leaf.astype(np.float32)).to(device=device, dtype=dtype)
