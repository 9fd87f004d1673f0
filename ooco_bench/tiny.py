"""A tiny cell for the CPU tests: the qwen2.5-7b configuration's keys at a
few dozen widths, the conv mix at short lengths, and a load point, so that
a whole run (set-up, window, judge) takes seconds on the CPU."""
from __future__ import annotations

import contextlib
import copy

import torch

from ooco_bench.cell import HERE, Cell, load_json

#: the tiny cell's window, seconds
SECONDS = 5.0


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as a run has, for the duration: a pytest worker
    beside others oversubscribes the cores with torch's default."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def config(dtype: str = "float32") -> dict:
    c = copy.deepcopy(load_json(HERE / "configs" / "qwen2.5-7b.json"))
    c.update(name="tiny", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, vocab_size=256, torch_dtype=dtype)
    c["deployment"].update(num_pages=256, decode_buckets=[8, 16], relaxed_decode_cap=16)
    return c


def mix() -> dict:
    m = copy.deepcopy(load_json(HERE / "traffic" / "conv.json"))
    m["name"] = "tiny"
    for side, p, o in (("online", 24, 6), ("offline", 24, 8)):
        m[side].update(prompt_mean=p, output_mean=o, prompt_max=64, output_max=16)
    m["warm"].update(stall_rounds=8, max_seconds=20)
    return m


def load() -> dict:
    return {"cell": "tiny.tiny", "online_rate_qps": 4.0, "offline_backlog": 24,
            "limits": {"logit_gap": 1e-3, "tokens_compared_min": 10,
                       "served_tokens_target": 100, "judge_tokens_max": 2000}}


def cell(dtype: str = "float32") -> Cell:
    return Cell("tiny.tiny", 1, config(dtype), mix(), load())


def bench() -> dict:
    """BENCHMARK.json with the tiny cell in place of the real ones."""
    b = copy.deepcopy(load_json(HERE.parent / "BENCHMARK.json"))
    b["configs"] = [{"name": "tiny", "source": "tiny", "file": "ooco_bench/configs/tiny.json",
                     "reduced": [], "why": "tests"}]
    b["workloads"] = [{"name": "tiny.tiny", "config": "tiny", "traffic": "tiny", "chips": 1,
                       "why": "tests"}]
    for m in b["end_to_end"] + b["per_layer"]:
        m.pop("workloads", None)
    return b
