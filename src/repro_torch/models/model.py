"""Model factory: config -> model object with the uniform API (``init``,
``prefill``, ``init_cache``, ``decode_step``, ``loss``)."""
from __future__ import annotations

from repro_torch.models.config import AUDIO, DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models.rwkv_model import RWKVModel
from repro_torch.models.transformer import Transformer
from repro_torch.models.whisper import WhisperModel
from repro_torch.models.zamba2 import Zamba2Model


def build_model(cfg: ModelConfig, **kw):
    """Dense, MoE and VLM build a ``Transformer``, SSM an ``RWKVModel``,
    hybrid a ``Zamba2Model`` and audio a ``WhisperModel``; keyword arguments
    go to the class (each takes ``remat``; those with attention ``backend``)."""
    if cfg.family in (DENSE, MOE, VLM):
        return Transformer(cfg, **kw)
    if cfg.family == SSM:
        return RWKVModel(cfg, **kw)
    if cfg.family == HYBRID:
        return Zamba2Model(cfg, **kw)
    if cfg.family == AUDIO:
        return WhisperModel(cfg, **kw)
    raise ValueError(f"unknown family {cfg.family}")
