"""The paged decode kernel's share of its roofline in the profiled slice:
the least time of the keys, queries and outputs its decode rows need
(``counts.paged_decode``; bytes at 3.35 TB/s or operations at 989 TFLOP/s,
whichever is larger) over the device time of its split and merge kernels,
in percent."""
from ooco_bench import counts


def read(record):
    prof = record["profile"]
    if not prof or prof["kernel_s"]["paged"] <= 0 or prof["work"]["decode_tokens"] <= 0:
        return None
    w = prof["work"]
    least = counts.least_seconds(w["paged_bytes"], w["paged_flops"])
    return 100.0 * least / prof["kernel_s"]["paged"]
