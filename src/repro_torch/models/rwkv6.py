"""RWKV6 "Finch" block, the port of ``repro.models.rwkv6``: attention-free,
with a data-dependent per-channel decay (arXiv:2404.05892).

Time mix: a linear-attention-like recurrence with a (head_dim x head_dim)
state per head, its decay w_t computed per token and channel through a LoRA.
Channel mix: a squared-ReLU FFN with token shift. The decode state is
O(d * head_dim), constant in sequence length.

Prefill runs the chunked WKV (``_wkv_chunked``, chunks of 32 carried by a
Python loop, the reference's ``lax.scan``), decode the per-token scan. Plain
PyTorch: the reference runs this as XLA code, with no Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_rwkv(gen: torch.Generator, cfg: ModelConfig, stack: tuple = ()):
    """Parameters of one block's time mix and channel mix, with ``stack``
    leading axes."""
    d, H, hd, r = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.rwkv_lora_dim
    dt, dev = cfg.torch_dtype, layers.param_device(gen)
    out_scale = 0.02 / np.sqrt(2 * cfg.num_layers)

    def w(shape, scale=0.02):
        return layers._normal(gen, (*stack, *shape), scale, dt)

    return {
        "tm": {  # time mix
            "mix": w((5, d), 0.2),  # static shift-mix for r, k, v, w, g
            "wr": w((d, H * hd)),
            "wk": w((d, H * hd)),
            "wv": w((d, H * hd)),
            "wg": w((d, H * hd)),
            "wo": w((H * hd, d), out_scale),
            "w_base": torch.full((*stack, H * hd), -6.0, device=dev),  # decay bias, f32
            "w_lora_a": w((d, r)),
            "w_lora_b": w((r, H * hd), 0.1),
            "u": torch.zeros((*stack, H, hd), device=dev),  # current-token bonus, f32
            "ln": layers.init_rmsnorm(hd, dt, dev, stack),  # per-head output norm
        },
        "cm": {  # channel mix
            "mix": w((2, d), 0.2),
            "wk": w((d, cfg.d_ff)),
            "wv": w((cfg.d_ff, d), out_scale),
            "wr": w((d, d)),
        },
    }


def _shift(x, last):
    """Token shift: the previous token at each position. x (B,S,d), last (B,d)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _tm_inputs(p, x, last):
    xs = _shift(x, last)
    mix = torch.sigmoid(p["mix"].float())  # (5, d)

    def mx(i):
        m = mix[i].to(x.dtype)
        return x * m + xs * (1 - m)

    r = mx(0) @ p["wr"]
    k = mx(1) @ p["wk"]
    v = mx(2) @ p["wv"]
    xw = mx(3)
    g = F.silu(mx(4) @ p["wg"])
    lora = torch.tanh(xw.float() @ p["w_lora_a"].float())
    w_log = p["w_base"] + lora @ p["w_lora_b"].float()
    w = torch.exp(-torch.exp(w_log))  # (B,S,H*hd) in (0,1), data-dependent
    return r, k, v, w, g


def _wkv_scan(r, k, v, w, u, state):
    """r, k, v, w: (B,S,H,hd) f32; state (B,H,hd,hd). Returns y (B,S,H,hd), state."""
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,hd)
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, state + u[None, :, :, None] * kv))
        state = w_t[..., None] * state + kv
    return torch.stack(ys, dim=1), state


def _wkv_chunked(r, k, v, w, u, state, chunk: int = 32):
    """Chunked WKV6: pairwise per-channel decays inside a chunk, and the state
    carried over chunk boundaries (the mamba2 SSD structure). All pairwise
    exponents lw[t-1] - lw[j] (j <= t-1) and lw[Q] - lw[j] are <= 0, since
    lw = cumsum(log w) decreases, so every exp() is at most 1."""
    B, S, H, K = r.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:  # state-transparent padding: k = 0 and w = 1 contribute nothing
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = (S + pad) // Q
    rc, kc, vc, wc = (a.reshape(B, n, Q, H, K) for a in (r, k, v, w))
    tri_strict = torch.ones(Q, Q, device=r.device).tril(-1)

    ys = []
    for c in range(n):
        rq, kq, vq, wq = rc[:, c], kc[:, c], vc[:, c], wc[:, c]   # (B,Q,H,K)
        logw = torch.log(wq.clamp_min(1e-30))
        lw = torch.cumsum(logw, dim=1)
        lw_prev = lw - logw                                           # lw[t-1]
        # intra: scores[t,j] = sum_k r_t k_j exp(lw[t-1] - lw[j]), j <= t-1
        diff = lw_prev[:, :, None] - lw[:, None, :, :]                # (B,Q,Q,H,K)
        scores = torch.einsum("bthk,bjhk,btjhk->bhtj", rq, kq, diff.clamp(max=0.0).exp())
        scores = scores * tri_strict[None, None]
        y_intra = torch.einsum("bhtj,bjhv->bthv", scores, vq)
        # diagonal bonus: (r_t . (u * k_t)) v_t
        diag = torch.einsum("bthk,hk,bthk->bth", rq, u, kq)
        y_intra = y_intra + diag[..., None] * vq
        # inter: r_t * exp(lw[t-1]) against the incoming state
        y_inter = torch.einsum("bthk,bhkv->bthv", rq * lw_prev.exp(), state)
        # S' = diag(exp(lw_Q)) S + sum_j diag(exp(lw_Q - lw_j)) k_j^T v_j
        kdec = kq * (lw[:, -1][:, None] - lw).clamp(max=0.0).exp()
        state = (lw[:, -1].exp()[..., None] * state
                 + torch.einsum("bjhk,bjhv->bhkv", kdec, vq))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, n * Q, H, K)
    return y[:, :S], state


def time_mix(p, x, cfg: ModelConfig, last_x, wkv_state, *, wkv_impl: str = "chunked"):
    """Returns (out (B,S,d), the last token's x, the WKV state)."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    r, k, v, w, g = _tm_inputs(p, x, last_x)
    shp = (B, S, H, hd)
    r, k, v = (a.reshape(shp).float() for a in (r, k, v))
    w = w.reshape(shp)
    if wkv_impl == "chunked" and S > 1:
        y, wkv_state = _wkv_chunked(r, k, v, w, p["u"], wkv_state)
    else:
        y, wkv_state = _wkv_scan(r, k, v, w, p["u"], wkv_state)
    y = layers.rmsnorm(p["ln"], y.to(x.dtype), cfg.norm_eps).reshape(B, S, H * hd)
    return (y * g) @ p["wo"], x[:, -1, :], wkv_state


def channel_mix(p, x, cfg: ModelConfig, last_x):
    """Returns (out (B,S,d), the last token's x)."""
    xs = _shift(x, last_x)
    mix = torch.sigmoid(p["mix"].float())
    mk, mr = mix[0].to(x.dtype), mix[1].to(x.dtype)
    xk = x * mk + xs * (1 - mk)
    xr = x * mr + xs * (1 - mr)
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, device):
    """One layer's recurrent state (the model stacks it over layers)."""
    d, H, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    return {
        "tm_x": torch.zeros((batch, d), dtype=cfg.torch_dtype, device=device),
        "cm_x": torch.zeros((batch, d), dtype=cfg.torch_dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), device=device),
    }
