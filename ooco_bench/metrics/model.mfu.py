"""The whole step's share of the chip's bf16 peak in the profiled slice:
the model FLOPs of every decode token and prefill chunk the slice served
(``counts.decode_token_flops``, ``counts.chunk_flops``, from each request's
progress across each round) over the slice's seconds times 989 TFLOP/s, in
percent."""
from ooco_bench import counts


def read(record):
    prof = record["profile"]
    if not prof or prof["window_s"] <= 0 or prof["work"]["model_flops"] <= 0:
        return None
    return 100.0 * prof["work"]["model_flops"] / (prof["window_s"] * counts.PEAK_BF16_FLOPS)
