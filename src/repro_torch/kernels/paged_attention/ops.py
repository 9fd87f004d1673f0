"""Public wrapper for paged decode attention.

Model layout in: q (B, Hq, hd) for the single new token per request and one
layer's pools (num_pages, page, Hkv, hd). On a CUDA tensor the wrapper
launches the hand-written kernel (``csrc/paged_attention.cu``), which reads
the pool directly through the block table; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from one to the other: the kernel
is built for head dims 64, 96 and 128 (``HEAD_DIMS``) and up to 8 query
heads per KV head (``MAX_GROUP``), and a CUDA call at any other shape raises.

The kernel splits each request's context into chunks of ``chunk`` token
slots, one thread block per (request, KV head, chunk) whose four warps each
take a quarter, and a second small kernel merges the warps' partial softmax
states. ``plan_splits``
picks the chunk from the shapes alone (never from the device's lengths), so
a launch is the same for every step of a (bucket, pages) shape and the
wrapper never waits for the device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, _P, _P,                       # q, k, v, tables, lengths, out
             _P, _P,                                       # o_part, ml_part scratch
             ctypes.c_int, ctypes.c_int, ctypes.c_int,     # B, Hkv, G
             ctypes.c_int, ctypes.c_int, ctypes.c_int,     # hd, P, page_size
             ctypes.c_int, ctypes.c_int,                   # chunk, splits
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # pool strides
             ctypes.c_float, ctypes.c_float, _P]           # scale, softcap, stream
MAX_GROUP = 8          # query heads per KV head the kernel holds (kMaxG)
HEAD_DIMS = (64, 96, 128)  # the kernel's instantiations, launch<HD>
TILE = 64              # a chunk is a multiple: a 16-token tile per warp (4 x kTile)
WARPS = 4              # warps per block, each with its own partial (kWarps)
MAX_CHUNK = 1024       # token slots per chunk whose page ids fit in shared memory
BLOCKS_PER_SM = 2      # blocks the planner aims for on each SM


def plan_splits(B: int, Hkv: int, P: int, page_size: int,
                num_sms: int) -> tuple[int, int]:
    """(chunk, splits) of a decode launch over a (B, P) block table: chunks
    of ``chunk`` token slots, a multiple of TILE and at most MAX_CHUNK, cut
    so that B * Hkv * splits blocks give about BLOCKS_PER_SM per SM. The
    chunks tile the table's P * page_size slots; ``splits`` is the fewest
    chunks that cover them. A function of the shapes only."""
    slots = P * page_size
    want = max(1, -(-BLOCKS_PER_SM * num_sms // (B * Hkv)))
    chunk = -(-slots // want)
    chunk = min(MAX_CHUNK, -(-chunk // TILE) * TILE)
    return chunk, -(-slots // chunk)


def _kernel():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_bf16
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, lengths, num_kv_heads):
    B, Hq, hd = q.shape
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} is on {t.device}, q on {dev}")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise TypeError("paged_attention kernel takes bfloat16 q and pools, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel takes int32 block_tables and lengths")
    if hd not in HEAD_DIMS or Hq % num_kv_heads or Hq // num_kv_heads > MAX_GROUP:
        raise ValueError(f"paged_attention kernel takes head_dim in {HEAD_DIMS} and "
                         f"<= {MAX_GROUP} query heads per KV head, got hd={hd}, "
                         f"Hq={Hq}, Hkv={num_kv_heads}")
    if k_pages.shape != v_pages.shape or k_pages.stride() != v_pages.stride() \
            or tuple(k_pages.shape[2:]) != (num_kv_heads, hd):
        raise ValueError(f"paged_attention: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match Hkv={num_kv_heads}, hd={hd}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError("paged_attention: block_tables must be (B, P) and lengths (B,)")
    if not (q.is_contiguous() and block_tables.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("paged_attention: q, block_tables and lengths must be contiguous")
    # 16-byte copies of each q and K/V row
    if q.data_ptr() % 16 or k_pages.stride(3) != 1 or any(s % 8 for s in k_pages.stride()[:3]) \
            or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: q and pool rows must be unit-stride "
                         "and 16-byte aligned")


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    num_kv_heads: int, logit_softcap: float = 0.0):
    """q: (B, Hq, hd); pools (num_pages, page, Hkv, hd); block_tables (B, P)
    int32; lengths (B,) int32. Returns (B, Hq, hd)."""
    B, Hq, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    if q.device.type == "cpu":
        o = paged_attention_ref(q.reshape(B, num_kv_heads, Hq // num_kv_heads, hd),
                                k_pages, v_pages, block_tables, lengths,
                                logit_softcap=logit_softcap, scale=scale)
        return o.reshape(B, Hq, hd)
    _check(q, k_pages, v_pages, block_tables, lengths, num_kv_heads)
    P, page_size = block_tables.shape[1], k_pages.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, splits = plan_splits(B, num_kv_heads, P, page_size, sms)
    out = torch.empty_like(q)
    # each warp's partial (o, m, l) in f32 for the merge
    o_part = torch.empty((B, Hq, splits * WARPS, hd), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((B, Hq, splits * WARPS, 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                    o_part.data_ptr(), ml_part.data_ptr(),
                    B, num_kv_heads, Hq // num_kv_heads, hd, P, page_size,
                    chunk, splits, *k_pages.stride()[:3],
                    float(scale), float(logit_softcap), stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
