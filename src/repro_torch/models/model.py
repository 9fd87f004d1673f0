"""Model factory: config -> model object."""
from __future__ import annotations

from repro_torch.models.config import DENSE, FAMILIES, MOE, ModelConfig
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig) -> Transformer:
    if cfg.family in (DENSE, MOE):
        return Transformer(cfg)
    if cfg.family in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet: ROADMAP queue 1 "
            "(the families off the serving path)")
    raise ValueError(f"unknown family {cfg.family}")
