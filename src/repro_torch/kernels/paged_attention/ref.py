"""Plain PyTorch version of paged decode attention: gather pages, mask, softmax."""
from __future__ import annotations

import numpy as np
import torch


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        logit_softcap: float = 0.0, scale: float | None = None):
    """Same signature/layout as the kernel: q (B, Hkv, G, hd),
    pools (num_pages, page, Hkv, hd), tables (B, P), lengths (B,)."""
    B, Hkv, G, hd = q.shape
    page = k_pages.shape[1]
    P = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    tables = block_tables.long()
    # gather this batch's pages -> contiguous (B, P*page, Hkv, hd)
    k = k_pages[tables].reshape(B, P * page, Hkv, hd)
    v = v_pages[tables].reshape(B, P * page, Hkv, hd)
    s = torch.einsum("bhgd,bchd->bhgc", q.float(), k.float()) * scale
    if logit_softcap:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    valid = torch.arange(P * page, device=q.device)[None] < lengths[:, None]
    s = torch.where(valid[:, None, None], s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgc,bchd->bhgd", p, v.float())
    return o.to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                              chunk: int, splits: int, logit_softcap: float = 0.0,
                              scale: float | None = None):
    """The kernel's algorithm in plain PyTorch, for tests: each of ``splits``
    chunks of ``chunk`` token slots yields a partial (m, l, o) in base 2
    (max score, sum of 2^(s - m), unnormalised output), an empty chunk
    (m, l, o) = (-1e30, 0, 0); the merge rescales and sums them. Same layout
    and result as ``paged_attention_ref``."""
    B, Hkv, G, hd = q.shape
    page = k_pages.shape[1]
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    log2e = 1.4426950408889634
    k = k_pages[block_tables.long()].reshape(B, -1, Hkv, hd).float()
    v = v_pages[block_tables.long()].reshape(B, -1, Hkv, hd).float()
    slots = k.shape[1]
    m_parts, l_parts, o_parts = [], [], []
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, slots)
        kc, vc = k[:, lo:hi], v[:, lo:hi]
        x = torch.einsum("bhgd,bchd->bhgc", q.float(), kc) * scale
        if logit_softcap:
            x = torch.tanh(x / logit_softcap) * logit_softcap
        pos = torch.arange(lo, hi, device=q.device)
        valid = (pos[None] < lengths[:, None])[:, None, None]
        x = torch.where(valid, x * log2e, -1e30)
        m = x.amax(-1) if hi > lo else torch.full((B, Hkv, G), -1e30, device=q.device)
        p = torch.where(valid, torch.exp2(x - m[..., None]), 0.0)
        empty = ~valid.any(-1)
        m_parts.append(torch.where(empty, -1e30, m))
        l_parts.append(p.sum(-1))
        o_parts.append(torch.einsum("bhgc,bchd->bhgd", p, vc))
    m, l, o = torch.stack(m_parts), torch.stack(l_parts), torch.stack(o_parts)
    w = torch.exp2(m - m.amax(0))
    out = (w[..., None] * o).sum(0) / (w * l).sum(0).clamp_min(1e-30)[..., None]
    return out.to(q.dtype)
