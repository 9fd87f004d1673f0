"""The yardstick's arithmetic: the chip's peaks, and the operations and
bytes a call needs, from its shapes and the host's record of each row's
context. Counts are of what the inputs need (each input byte read once,
each output byte written once, the (query, key) pairs the causal mask
keeps), not what a kernel happens to do."""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: dense bfloat16 tensor rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two terms."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


def paged_decode(n: dict, keys: int, rows: int) -> tuple[float, float]:
    """(bytes, flops) of one layer's paged decode attention over ``rows``
    rows that attend ``keys`` keys in all: K and V of every key, q and the
    output of every row."""
    hq, hkv, hd = n["Hq"], n["Hkv"], n["hd"]
    nbytes = BF16 * (2 * keys * hkv * hd + 2 * rows * hq * hd)
    return nbytes, 4.0 * hd * hq * keys


def flash_chunk(n: dict, q_offset: int, s: int) -> tuple[float, float]:
    """(bytes, flops) of one layer's causal attention of ``s`` chunk queries
    at positions [q_offset, q_offset + s) over the q_offset + s keys before
    and in the chunk."""
    hq, hkv, hd = n["Hq"], n["Hkv"], n["hd"]
    kv = q_offset + s
    pairs = s * q_offset + s * (s + 1) / 2
    nbytes = BF16 * (2 * s * hq * hd + 2 * kv * hkv * hd)
    return nbytes, 4.0 * hd * hq * pairs


def layer_matmul_params(n: dict) -> int:
    """Weights one token multiplies in a layer: q, k, v, o and the gated MLP."""
    d, hq, hkv, hd, ff = n["d"], n["Hq"], n["Hkv"], n["hd"], n["ff"]
    return d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff


def decode_token_flops(n: dict, keys: int) -> float:
    """Model FLOPs of one decode token that attends ``keys`` keys: every
    layer's products and attention, and the output projection."""
    per_layer = 2.0 * layer_matmul_params(n) + 4.0 * n["Hq"] * n["hd"] * keys
    return n["L"] * per_layer + 2.0 * n["d"] * n["V"]


def chunk_flops(n: dict, q_offset: int, s: int, completes: bool) -> float:
    """Model FLOPs of a prefill chunk of ``s`` tokens at ``q_offset``; the
    output projection once, for the first token, if the chunk completes the
    prompt."""
    pairs = s * q_offset + s * (s + 1) / 2
    f = n["L"] * (2.0 * layer_matmul_params(n) * s + 4.0 * n["Hq"] * n["hd"] * pairs)
    return f + (2.0 * n["d"] * n["V"] if completes else 0.0)
