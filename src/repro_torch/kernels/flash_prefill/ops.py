"""Public wrapper for flash prefill attention.

Model layout in and out: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd). On a CUDA
tensor the wrapper launches the hand-written kernel
(``csrc/flash_prefill.cu``), which reads the layout through TMA tensor maps
built over the strides and takes ``q_offset`` and the per-row ``kv_lens`` at
run time, so nothing is padded or transposed here (head_dims 96 and 112
included: the kernel has an instantiation for each of ``HEAD_DIMS``, hd 112
on the hd 128 tiles with TMA's zero fill past column 112, and raises on any
other); on a CPU tensor it runs the plain version (``ref.py``). There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P,                 # q, k, v, out, kv_lens
             _I, _I, _I, _I, _I, _I,             # B, Sq, Skv, Hq, Hkv, hd
             ctypes.POINTER(ctypes.c_longlong),  # 12 strides
             _I, _I, _I,                         # q_offset, causal, window
             ctypes.c_float, ctypes.c_float, _P]  # scale, softcap, stream
HEAD_DIMS = (64, 96, 112, 128, 256)   # the kernel's instantiations


def _kernel():
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_bf16
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k, v, kv_lens):
    B, Sq, Hq, hd = q.shape
    for name, t in (("k", k), ("v", v), ("kv_lens", kv_lens)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError("flash_attention kernel takes bfloat16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd \
            or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (B,) \
            or not kv_lens.is_contiguous():
        raise ValueError("flash_attention: kv_lens must be a contiguous (B,) int32 tensor")
    # TMA: unit-stride rows, every other stride and the base 16-byte aligned
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} rows must be unit-stride "
                             "and 16-byte aligned")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0, kv_lens=None, q_offset: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).

    kv_lens: (B,) int32 valid key length per row (all ``Skv`` when None);
    q_offset: absolute position of q[:, 0] (0 for a whole prompt)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    if kv_lens is None:
        kv_lens = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        o = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              kv_len=Skv, q_offset=q_offset, causal=causal,
                              window=window, logit_softcap=logit_softcap,
                              scale=scale, kv_lens=kv_lens)
        return o.transpose(1, 2)
    _check(q, k, v, kv_lens)
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    kv_lens.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, strides,
                    int(q_offset), int(causal), int(window), float(scale),
                    float(logit_softcap), stream)
    if err:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.offset_launches += q_offset > 0
    return out


flash_attention.launches = 0
flash_attention.offset_launches = 0   # launches at q_offset > 0 (chunks past the first)
