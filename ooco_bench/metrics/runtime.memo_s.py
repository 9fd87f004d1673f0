"""Seconds of the set-up's fill of the scheduler's bs_sat memo, for every
power-of-two context bucket the traffic reaches (the benchmark's clock
around ``PerfModel.compute_saturated_batch``)."""


def read(record):
    return record["memo_s"]
