"""The online TTFT p90 at the client (``clientstats.ttfts``: every online
request due in the window, timed from when it was due, an unserved one
with its wait at the close), read in the traced run. A guard read beside
``online_tpot_p90_ms``: larger prefill chunks a round lower this and raise
TPOT."""


def read(record):
    return record["client"]["online_ttft_p90_s"]
