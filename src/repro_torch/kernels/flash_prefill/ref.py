"""Plain PyTorch version of flash prefill attention (naive full-score attention)."""
from __future__ import annotations

import numpy as np
import torch


def flash_prefill_ref(q, k, v, *, kv_len: int, q_offset: int = 0,
                      causal: bool = True, window: int = 0,
                      logit_softcap: float = 0.0, scale: float | None = None,
                      kv_lens=None):
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd). Returns (B, Hq, Sq, hd).

    kv_lens: optional (B,) per-row valid key length — tightens the static
    ``kv_len`` bound row-wise (ragged batches)."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    dev = q.device
    qg = q.reshape(B, Hkv, G, Sq, hd).float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * scale
    if logit_softcap:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Skv, device=dev)[None, :]
    mask = k_pos < kv_len
    if causal:
        rel = q_pos - k_pos
        mask = mask & (rel >= 0)
        if window:
            mask = mask & (rel < window)
    mask = mask[None].expand(B, Sq, Skv)
    if kv_lens is not None:
        lens = torch.as_tensor(kv_lens, device=dev)
        mask = mask & (k_pos[None] < lens[:, None, None])
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)
