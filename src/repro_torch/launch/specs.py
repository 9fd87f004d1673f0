"""Shape-only stand-ins for every workload input, on the ``meta`` device.

The port of ``repro.launch.specs``: ``input_specs(cfg, shape)`` returns the
abstract batch for a workload shape; ``abstract_params``,
``abstract_opt_state`` and ``abstract_cache`` build the params, optimizer
state and cache trees as ``meta`` tensors, which carry shapes and dtypes and
no storage (full-width qwen2.5-72b's params alone take ~145 GB).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import AUDIO, VLM, InputShape, ModelConfig
from repro_torch.training.optimizer import init_opt_state

TOKENS = torch.int32
META = torch.device("meta")

# long_500k skip set (pure full-attention archs + enc-dec), as the reference's
# dry run has it
LONG_SKIP = {
    "phi-3-vision-4.2b": "pure full attention (no sub-quadratic variant)",
    "tinyllama-1.1b": "pure full attention",
    "granite-moe-3b-a800m": "pure full attention",
    "qwen3-8b": "pure full attention",
    "qwen2.5-32b": "pure full attention",
    "whisper-tiny": "enc-dec with 448-position decoder; no long decode",
}


def skip_reason(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k":
        return LONG_SKIP.get(arch)
    return None


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Abstract input batch for (arch, workload shape).

    VLM: image patch tokens are part of the sequence budget, so text tokens
    = seq_len - num_frontend_tokens. Audio: seq_len maps to encoder frames
    (the stubbed conv frontend's output), decoder prompt is small.
    """
    B, S = shape.global_batch, shape.seq_len
    d = cfg.torch_dtype
    if shape.kind == "decode":
        return {"tokens": _sds((B,), TOKENS)}
    if cfg.family == VLM:
        T = cfg.num_frontend_tokens
        batch = {"tokens": _sds((B, S - T), TOKENS),
                 "frontend_embeds": _sds((B, T, cfg.d_model), d)}
    elif cfg.family == AUDIO:
        dec = 64 if shape.kind == "train" else 8
        batch = {"tokens": _sds((B, dec), TOKENS),
                 "frontend_embeds": _sds((B, S, cfg.d_model), d)}
    else:
        batch = {"tokens": _sds((B, S), TOKENS)}
    if shape.kind == "train":
        batch["labels"] = _sds(batch["tokens"].shape, TOKENS)
    return batch


def abstract_params(model):
    with layers.on_meta():
        return model.init(torch.Generator())


def abstract_opt_state(params_abs):
    return init_opt_state(params_abs)


def abstract_cache(model, shape: InputShape):
    kw = {"enc_len": 1500} if model.cfg.family == AUDIO else {}
    return model.init_cache(shape.global_batch, shape.seq_len,
                            prefilled_len=shape.seq_len - 1, device=META, **kw)
