"""Plain reference of a dense decoder-only transformer (Qwen2, Phi-3): the
published forward pass in float32 PyTorch, with no kernel, cache or
batching, over one whole sequence at a time and layer by layer.

Per layer: x += o(attn(rope(q(n1(x))), rope(k(n1(x))), v(n1(x)))), then
x += down(silu(gate(n2(x))) * up(n2(x))); RMSNorm weights are 1 + the
stored offset; rope rotates the two halves of each head (the HF
``rotate_half`` layout) at ``rope_theta``; attention is causal grouped-query
softmax(q k^T / sqrt(head_dim)) v. Logits are final_norm(x) @ lm_head.

It takes the weights the benchmark made (the tree of ``weights.py``) and the
token ids, and nothing the program made. With ``quant="fp8"`` every matrix
product runs on float8 e4m3 values, weights scaled per output channel and
activations per token (the W8A8 recipe): the control, one precision below
the configuration's bfloat16. This file imports only torch and math.
"""
from __future__ import annotations

import math

import torch

F8_MAX = 448.0   # largest finite float8 e4m3fn


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per slice along ``dim``
    (the amax over ``dim`` maps to the format's largest value)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Linear:
    def __init__(self, w, b=None, quant=None):
        w = w.float()
        self.w = _fp8(w, 0) if quant == "fp8" else w   # per output column
        self.b = None if b is None else b.float()
        self.quant = quant

    def __call__(self, x):
        if self.quant == "fp8":
            x = _fp8(x, -1)                            # per token
        y = x @ self.w
        return y if self.b is None else y + self.b


def _rms(x, offset, eps):
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return x * (1.0 + offset.float())


def _rope(x, pos, theta):
    """x (S, H, hd) at positions pos (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float64) / hd)
    ang = (pos.double()[:, None] * inv[None]).float()[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attention(q, k, v, block: int = 512):
    """Causal grouped-query attention of one sequence: q (S, Hq, hd), k/v
    (S, Hkv, hd), by blocks of queries."""
    S, hq, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    kt = k.permute(1, 2, 0)                      # (Hkv, hd, S)
    vt = v.permute(1, 0, 2)                      # (Hkv, S, hd)
    out = torch.empty_like(q)
    for a in range(0, S, block):
        b = min(a + block, S)
        qb = q[a:b].reshape(b - a, hkv, g, hd).permute(1, 2, 0, 3)   # (Hkv, g, n, hd)
        s = torch.matmul(qb, kt[:, None, :, :b]) / math.sqrt(hd)       # (Hkv, g, n, b)
        keep = torch.arange(b, device=q.device)[None, :] <= torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), vt[:, None, :b])   # (Hkv, g, n, hd)
        out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, hq, hd)
    return out


def _mlp(x, gate, up, down, block: int = 2048):
    out = torch.empty_like(x)
    for a in range(0, x.shape[0], block):
        h = x[a:a + block]
        out[a:a + block] = down(torch.nn.functional.silu(gate(h)) * up(h))
    return out


def final_hidden(config: dict, w: dict, seqs: list[torch.Tensor], quant=None) -> list[torch.Tensor]:
    """The final-normed hidden states (S, d) float32 of each token sequence,
    computed layer by layer over all sequences."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    hq, hkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["hidden_size"] // hq
    xs = [w["embed"][s].float() for s in seqs]
    pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    lw = w["layers"]
    for li in range(config["num_hidden_layers"]):
        a = lw["attn"]

        def lin(p):
            return _Linear(p["w"][li], p["b"][li] if "b" in p else None, quant)

        wq, wk, wv, wo = lin(a["wq"]), lin(a["wk"]), lin(a["wv"]), lin(a["wo"])
        gate, up, down = (lin(lw["mlp"][k]) for k in ("gate", "up", "down"))
        for i, x in enumerate(xs):
            S = x.shape[0]
            h = _rms(x, lw["ln1"]["scale"][li], eps)
            q = _rope(wq(h).reshape(S, hq, hd), pos[i], theta)
            k = _rope(wk(h).reshape(S, hkv, hd), pos[i], theta)
            v = wv(h).reshape(S, hkv, hd)
            x = x + wo(_attention(q, k, v).reshape(S, hq * hd))
            xs[i] = x + _mlp(_rms(x, lw["ln2"]["scale"][li], eps), gate, up, down)
        del wq, wk, wv, wo, gate, up, down
    return [_rms(x, w["final_norm"]["scale"], eps) for x in xs]


def head(w: dict, quant=None) -> _Linear:
    """The output projection, to apply to rows of ``final_hidden``."""
    return _Linear(w["lm_head"], None, quant)
