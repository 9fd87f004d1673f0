"""Shared neural-net building blocks (functional, params as nested dicts of tensors).

The parameter layout matches ``repro.models.layers``: ``dense`` weights are
``(d_in, d_out)`` and apply as ``x @ w``, so weights carry across unchanged.
Initialisers draw from an explicit ``torch.Generator`` on its own device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 0.02, bias: bool = False, stack: tuple = ()):
    """``stack`` prepends leading axes (the transformer stacks its layers)."""
    p = {"w": _normal(gen, (*stack, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=dtype, device=gen.device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, stack: tuple = ()):
    return {"scale": torch.zeros((*stack, d), dtype=dtype, device=device)}  # gemma-style (1 + scale)


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"].float())).to(dt)


def init_layernorm(d: int, dtype, device, stack: tuple = ()):
    return {"scale": torch.ones((*stack, d), dtype=dtype, device=device),
            "bias": torch.zeros((*stack, d), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """f32 rope frequencies, uploaded once per device: an upload per call
    would make every layer wait for the device."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)
    ang = positions.float()[..., None] * freqs  # (..., seq, hd/2)
    ang = ang[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(num_pos: int, d_model: int) -> np.ndarray:
    """Whisper-style sinusoidal embeddings (num_pos, d_model), f32."""
    log_timescale = np.log(10000.0) / (d_model // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(d_model // 2))
    t = np.arange(num_pos)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def sinusoidal_positions_on(num_pos: int, d_model: int, dtype, device) -> torch.Tensor:
    """``sinusoidal_positions`` in ``dtype`` on ``device``, uploaded once: an
    upload per call would make every decode step wait for the copy."""
    return torch.as_tensor(sinusoidal_positions(num_pos, d_model)).to(device=device,
                                                                      dtype=dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             act: str = "silu", stack: tuple = ()):
    if act == "gelu_mlp":  # plain 2-matrix MLP (whisper)
        return {
            "up": init_dense(gen, d_model, d_ff, dtype, bias=True, stack=stack),
            "down": init_dense(gen, d_ff, d_model, dtype, bias=True, stack=stack),
        }
    return {  # gated (swiglu / geglu)
        "gate": init_dense(gen, d_model, d_ff, dtype, stack=stack),
        "up": init_dense(gen, d_model, d_ff, dtype, stack=stack),
        "down": init_dense(gen, d_ff, d_model, dtype, scale=0.02 / np.sqrt(2),
                           stack=stack),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp(p, x, act: str = "silu"):
    if "gate" not in p:
        return dense(p["down"], _gelu(dense(p["up"], x)))
    a = dense(p["gate"], x)
    a = F.silu(a) if act == "silu" else _gelu(a)
    return dense(p["down"], a * dense(p["up"], x))


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def cross_entropy_loss(logits, labels):
    """Mean token cross-entropy: logits (..., V) in any dtype, computed in
    f32; labels (...) integer, -1 = ignored."""
    logits = logits.float()
    valid = (labels >= 0).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp(min=0)[..., None].long())[..., 0] - logz
    return -(ll * valid).sum() / valid.sum().clamp(min=1.0)
