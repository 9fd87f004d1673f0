"""Share of the profiled slice in which no operation ran on the device, in
percent (one card)."""


def read(record):
    prof = record["profile"]
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - prof["busy_s"] / prof["window_s"])
