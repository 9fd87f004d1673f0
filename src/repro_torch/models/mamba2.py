"""Mamba2 (SSD) block, the port of ``repro.models.mamba2``: chunked prefill
and training, and an O(1) decode step.

The scalar-A-per-head SSD formulation (Dao & Gu, 2024): within a chunk of
``ssm_chunk`` tokens the output is an attention-like quadratic product over
the chunk, and the state is carried from chunk to chunk by a Python loop
(the reference's ``lax.scan``), so that only one chunk's (Q, Q, nh) scores
exist at a time. The SSM state stays in f32. Plain PyTorch: the reference
runs this as XLA code, with no Pallas kernel.

One deviation: the reference takes exp(cum_i - cum_j) over the whole (Q, Q)
square and multiplies by the causal triangle afterwards, so above the
diagonal (j > i, where cum_i - cum_j > 0) it overflows once a chunk's
log-decays span more than ~88, and inf * 0 makes its output NaN: at zamba2's
own chunk of 256 tokens, A down to -16 and dt up to 0.1 span ~400. Here the
exponent is masked to -inf above the diagonal before the exp, which gives
the reference's value wherever the reference's is finite.

Decode carries (conv_state, ssm_state), constant in sequence length.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_mamba(gen: torch.Generator, cfg: ModelConfig, stack: tuple = ()):
    """Parameters of one Mamba2 mixer, with ``stack`` leading axes."""
    d, di, ns, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    dt_, dev = cfg.torch_dtype, layers.param_device(gen)
    d_in_proj = 2 * di + 2 * ns + nh  # z, x, B, C, dt
    conv_dim = di + 2 * ns
    a_init = torch.linspace(1.0, 16.0, nh, device=dev).log()
    dt_bias = torch.linspace(1e-3, 1e-1, nh, device=dev).exp().sub(1.0).log()  # softplus^-1

    def per_head(a):
        return a.expand(*stack, nh).clone()

    return {
        "in_proj": layers.init_dense(gen, d, d_in_proj, dt_, stack=stack),
        "conv_w": layers._normal(gen, (*stack, cfg.ssm_conv, conv_dim), 0.02, dt_),
        "conv_b": torch.zeros((*stack, conv_dim), dtype=dt_, device=dev),
        "A_log": per_head(a_init),      # A = -exp(A_log), per head, f32
        "D": torch.ones((*stack, nh), device=dev),
        "dt_bias": per_head(dt_bias),
        "out_proj": layers.init_dense(gen, di, d, dt_,
                                      scale=0.02 / np.sqrt(2 * cfg.num_layers), stack=stack),
        "norm": layers.init_rmsnorm(di, dt_, dev, stack),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    """z, x|B|C (the conv's input), dt."""
    di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    return torch.split(zxbcdt, [di, di + 2 * ns, nh], dim=-1)


def _split_xbc(cfg: ModelConfig, xbc):
    di, ns = cfg.ssm_d_inner, cfg.ssm_state
    return torch.split(xbc, [di, ns, ns], dim=-1)


def _chunk_step(state, xq, dtq, dAq, Bq, Cq):
    """One SSD chunk from ``state`` (B, nh, hd, ns): the quadratic intra-chunk
    term, the incoming state's term, and the state after the chunk. Inputs
    (B, Q, ...) in f32. Returns (y (B, Q, nh, hd), new state)."""
    Q = xq.shape[1]
    cum = torch.cumsum(dAq, dim=1)                                  # (B,Q,nh)
    total = cum[:, -1, :]                                           # (B,nh)
    # intra: score[i,j] = C_i.B_j exp(cum_i - cum_j) dt_j, j <= i
    cb = torch.einsum("bis,bjs->bij", Cq, Bq)                       # (B,Q,Q)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=xq.device).tril()
    seg = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(~tri[None, :, :, None],
                                                                float("-inf"))
    scores = cb[..., None] * seg.exp() * dtq[:, None, :, :]         # (B,Q,Q,nh)
    y_intra = torch.einsum("bijh,bjhp->bihp", scores, xq)
    # inter: the contribution of the state entering this chunk
    y_inter = torch.einsum("bis,bhps->bihp", Cq, state) * cum.exp()[..., None]
    # state update
    sdecay = (total[:, None, :] - cum).exp() * dtq                  # (B,Q,nh)
    chunk_state = torch.einsum("bjhp,bjs->bhps", sdecay[..., None] * xq, Bq)
    new_state = total.exp()[:, :, None, None] * state + chunk_state
    return y_intra + y_inter, new_state


def mamba_prefill(p, u, cfg: ModelConfig, conv_state=None, ssm_state=None, mask=None):
    """u: (B, S, d) -> (y (B, S, d), (conv_state, ssm_state)).

    S is padded to a multiple of the chunk (``ssm_chunk``, or S when
    shorter). ``mask`` (B, S) marks valid tokens: invalid ones get dt = 0,
    which leaves the state unchanged (decay exp(0) = 1, contribution
    dt B x = 0), so trailing padding never reaches the carried state."""
    Bsz, S_in, _ = u.shape
    Q = min(cfg.ssm_chunk, max(S_in, 1))
    pad_len = (-S_in) % Q
    if pad_len:
        u = F.pad(u, (0, 0, 0, pad_len))
        if mask is None:
            mask = (torch.arange(S_in + pad_len, device=u.device) < S_in)[None]
        else:
            mask = F.pad(mask, (0, pad_len))
    S = u.shape[1]
    nh, hd, ns, di = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_d_inner

    z, xbc, dt_raw = _split_proj(cfg, layers.dense(p["in_proj"], u))

    # causal depthwise conv over the sequence, seeded from conv_state
    K = cfg.ssm_conv
    if conv_state is None:
        conv_state = xbc.new_zeros((Bsz, K - 1, xbc.shape[-1]))
    xbc_pad = torch.cat([conv_state, xbc], dim=1)
    # the conv state: the taps before the first unseen position (not padding)
    new_conv_state = xbc_pad[:, S_in:S_in + K - 1, :]
    xbc_conv = sum(xbc_pad[:, i:i + S, :] * p["conv_w"][i] for i in range(K))
    x, Bm, Cm = _split_xbc(cfg, F.silu(xbc_conv + p["conv_b"]))

    x = x.reshape(Bsz, S, nh, hd)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                  # (B,S,nh)
    if mask is not None:
        dt = dt * mask[:, :, None].float()                          # padding: transparent
    dA = dt * -p["A_log"].exp()                                     # log-decay
    n = S // Q
    xc = x.float().reshape(Bsz, n, Q, nh, hd)
    dtc, dAc = dt.reshape(Bsz, n, Q, nh), dA.reshape(Bsz, n, Q, nh)
    Bc, Cc = Bm.float().reshape(Bsz, n, Q, ns), Cm.float().reshape(Bsz, n, Q, ns)

    state = ssm_state if ssm_state is not None else \
        torch.zeros((Bsz, nh, hd, ns), device=u.device)
    ys = []
    for c in range(n):
        y_c, state = _chunk_step(state, xc[:, c], dtc[:, c], dAc[:, c], Bc[:, c], Cc[:, c])
        ys.append(y_c)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, nh, hd)
    y = y + p["D"][None, None, :, None] * x.float()
    y = y.reshape(Bsz, S, di).to(u.dtype)
    y = layers.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    y = layers.dense(p["out_proj"], y)
    return y[:, :S_in], (new_conv_state, state)


def mamba_decode(p, u, cfg: ModelConfig, conv_state, ssm_state):
    """u: (B, 1, d), one token. States: conv (B, K-1, conv_dim), ssm (B, nh,
    hd, ns) f32. Returns (y (B, 1, d), (conv_state, ssm_state)), new tensors."""
    Bsz = u.shape[0]
    nh, hd, di = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_d_inner

    z, xbc, dt_raw = _split_proj(cfg, layers.dense(p["in_proj"], u[:, 0]))
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)         # (B,K,conv)
    new_conv_state = window[:, 1:, :]
    xbc_conv = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"])
    x, Bm, Cm = _split_xbc(cfg, xbc_conv)

    x = x.reshape(Bsz, nh, hd).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                  # (B,nh)
    decay = (dt * -p["A_log"].exp()).exp()
    Bm, Cm = Bm.float(), Cm.float()
    new_state = (decay[:, :, None, None] * ssm_state
                 + torch.einsum("bhp,bs->bhps", dt[:, :, None] * x, Bm))
    y = torch.einsum("bs,bhps->bhp", Cm, new_state) + p["D"][None, :, None] * x
    y = y.reshape(Bsz, di).to(u.dtype)
    y = layers.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return layers.dense(p["out_proj"], y)[:, None, :], (new_conv_state, new_state)


def mamba_ref_scan(p, u, cfg: ModelConfig):
    """Token-by-token oracle (the decode step, iterated) for the chunked path."""
    Bsz, S, _ = u.shape
    conv = u.new_zeros((Bsz, cfg.ssm_conv - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state))
    ssm = torch.zeros((Bsz, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state), device=u.device)
    ys = []
    for t in range(S):
        y, (conv, ssm) = mamba_decode(p, u[:, t:t + 1], cfg, conv, ssm)
        ys.append(y)
    return torch.cat(ys, dim=1), (conv, ssm)
