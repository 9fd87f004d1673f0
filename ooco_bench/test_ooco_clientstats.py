"""The end-to-end arithmetic at the client."""
import pytest

from ooco_bench import clientstats as cs


def req(due, times, finished=False):
    return {"due": due, "times": list(times), "finished": finished}


def test_unserved_request_counts_with_its_wait():
    online = [req(0.0, [0.1, 0.2])] * 9 + [req(1.0, [])]
    assert cs.ttfts(online, close=10.0)[-1] == pytest.approx(9.0)
    # the p90 of nine 0.1 s and one 9.0 s wait lies between them
    assert cs.p90(cs.ttfts(online, 10.0)) == pytest.approx(0.1 + 0.1 * (9.0 - 0.1) * 1.0, rel=1e-9)
    s = cs.summary(online, 10.0, 0, 2.0, 0.05)
    assert s["online_unserved"] == 1
    assert s["slo_attainment"] == pytest.approx(0.0)   # TPOT 100 ms misses everywhere


def test_a_stall_moves_the_p90():
    steady = [req(t, [t + 0.2]) for t in range(20)]
    stalled = [req(t, [t + (3.0 if 10 <= t < 13 else 0.2)]) for t in range(20)]
    assert cs.p90(cs.ttfts(steady, 30)) == pytest.approx(0.2)
    assert cs.p90(cs.ttfts(stalled, 30)) > 2.0


def test_tpot_from_client_times():
    r = req(0.0, [1.0, 1.0, 1.3, 1.6])     # two tokens at one step's return
    assert cs.tpots([r]) == [pytest.approx(0.2)]
    assert cs.tpots([req(0.0, [1.0])]) == []


def test_tokens_per_s_over_the_whole_window():
    s = cs.summary([req(0.0, [0.1])], close=40.0, offline_tokens=8000, slo_ttft=2.0, slo_tpot=0.05)
    assert s["offline_tokens_per_s"] == pytest.approx(200.0)


def test_attainment_needs_both_limits():
    ok = req(0.0, [0.5, 0.54, 0.58])
    slow_first = req(0.0, [2.5, 2.52])
    slow_tokens = req(0.0, [0.5, 0.6])
    assert cs.slo_attainment([ok, slow_first, slow_tokens], 10.0, 2.0, 0.05) == pytest.approx(1 / 3)
