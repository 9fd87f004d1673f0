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
