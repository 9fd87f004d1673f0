"""The flash prefill kernel's share of its roofline in the profiled slice:
the least time of every prefill chunk's causal attention
(``counts.flash_chunk``, per chunk) over the device time of the kernel, in
percent."""


def read(record):
    prof = record["profile"]
    if not prof or prof["kernel_s"]["flash"] <= 0 or prof["work"]["chunk_tokens"] <= 0:
        return None
    return 100.0 * prof["work"]["flash_least_s"] / prof["kernel_s"]["flash"]
