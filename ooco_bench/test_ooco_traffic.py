"""The traffic copy reproduces its sources' statistics for every seed."""
import json

import numpy as np
import pytest

from ooco_bench import traffic
from ooco_bench.cell import HERE

MIX = json.loads((HERE / "traffic" / "conv.json").read_text())
SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("side,prompt_mean,output_mean", [
    ("online", 1512.30, 98.75),      # Azure conv (Table 5)
    ("offline", 1200.52, 671.51),    # OOC offline (Table 5)
])
def test_means_match_table5(side, prompt_mean, output_mean):
    s = MIX[side]
    assert (s["prompt_mean"], s["output_mean"]) == (prompt_mean, output_mean)
    p = traffic.lognormal_quantiles(prompt_mean, 1.0, 20000, 4, 8192)
    o = traffic.lognormal_quantiles(output_mean, 1.0, 20000, 4, 8192)
    # clipping at 8192 and flooring to whole tokens take up to ~2% off the mean
    assert 0.97 * prompt_mean < p.mean() <= prompt_mean
    assert 0.97 * output_mean < o.mean() <= output_mean
    assert p.max() <= 8192 and p.min() >= 4 and o.max() <= 8192
    # coefficient of variation ~1 before the clip
    assert 0.8 < p.std() / p.mean() < 1.05


@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_serves_the_same_load(seed):
    base = traffic.online_requests(MIX, 2.5, 40.0, SEEDS[0], 1000)
    reqs = traffic.online_requests(MIX, 2.5, 40.0, seed, 1000)
    assert len(reqs) == len(base) == 100
    assert sorted(len(r.prompt) for r in reqs) == sorted(len(r.prompt) for r in base)
    assert sorted(r.output_len for r in reqs) == sorted(r.output_len for r in base)
    due = np.array([r.due for r in reqs])
    assert due[0] == 0.0 and np.all(np.diff(due) > 0) and due[-1] < 40.0
    assert max(len(r.prompt) for r in reqs) <= MIX["online"]["prompt_max"]
    # the mean of the 100 lengths is the quantiles' mean, within 3% of the source
    assert abs(np.mean([len(r.prompt) for r in reqs]) / 1512.30 - 1) < 0.03
    off = traffic.offline_backlog(MIX, 400, seed, 1000)
    assert abs(np.mean([r.output_len for r in off]) / 671.51 - 1) < 0.03
    assert all(0 <= r.prompt.min() and r.prompt.max() < 1000 for r in off)


def test_seed_changes_the_tokens_only():
    a = traffic.online_requests(MIX, 2.5, 40.0, 1, 1000)
    b = traffic.online_requests(MIX, 2.5, 40.0, 2, 1000)
    c = traffic.online_requests(MIX, 2.5, 40.0, 1, 1000)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    assert [(r.due, len(r.prompt), r.output_len) for r in a] == \
        [(r.due, len(r.prompt), r.output_len) for r in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    # another schedule seed gives another order of the same sizes
    d = traffic.online_requests({**MIX, "schedule_seed": 5}, 2.5, 40.0, 1, 1000)
    assert [r.due for r in d] != [r.due for r in a]
    assert sorted(r.output_len for r in d) == sorted(r.output_len for r in a)


def test_poisson_gaps():
    due = traffic.poisson_arrivals(3.0, 1000.0, np.random.default_rng(0))
    gaps = np.diff(due)
    assert len(due) == 3000
    assert abs(gaps.mean() * 3.0 - 1) < 0.01
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05     # exponential: CoV 1


def test_max_context():
    assert traffic.max_context(MIX) == 8192 + 8192
