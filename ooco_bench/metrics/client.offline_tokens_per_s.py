"""Offline output tokens the window delivered (each request's count past
its high-water mark at the window's open, so that tokens made again after
an eviction count once) over the window's seconds, read in the traced run.
A guard read beside ``online_tpot_p90_ms``, not a lever for it: more
offline rows a round raise both, so a TPOT gain holds only where this did
not fall."""


def read(record):
    return record["client"]["offline_tokens_per_s"]
