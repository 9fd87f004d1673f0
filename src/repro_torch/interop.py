"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX params pytree (``repro`` Transformer.init,
nested dicts with the layers stacked on axis 0, or on (L/2, 2) for gemma2's
local/global pairs; a tied embedding and no ``lm_head`` where the config
ties them) as numpy arrays and returns the port's params: the same names and
layout, leaf for leaf, as torch tensors. This module
imports nothing of JAX: the caller converts leaves with ``np.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def params_from_jax(np_params, cfg: ModelConfig, device="cpu"):
    """Nested dict of numpy arrays -> the same nested dict of tensors in
    ``cfg.torch_dtype`` on ``device``. bf16 leaves arrive as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so each leaf
    goes through float32 (exact for bf16 and f32) first."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, cfg, device) for k, v in np_params.items()}
    leaf = np.asarray(np_params).astype(np.float32)
    return torch.from_numpy(leaf).to(device=device, dtype=cfg.torch_dtype)
