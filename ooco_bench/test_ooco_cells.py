"""BENCHMARK.json against the contract's shape, the weights against the
port's layout, the plain reference against the port, and a cell, a mix
and a per-layer metric added by files alone."""
import json
import math
import re
import shutil

import pytest
import torch

from ooco_bench import tiny
from ooco_bench.cell import HERE, load_cell, load_json, metric_readers, reference_module
from ooco_bench.run import run_cell
from ooco_bench.weights import make_weights

ROOT = HERE.parent
BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "ooco_bench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.load["cell"] == w["name"]


@pytest.mark.parametrize("cfg", [c["file"] for c in BENCH["configs"]])
def test_config_files(cfg):
    c = load_json(ROOT / cfg)
    entry = next(e for e in BENCH["configs"] if e["file"] == cfg)
    assert entry["reduced"] == c["reduced"] and entry["source"] == c["source"]
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    assert (HERE / "configs" / c["reference"]).exists()
    dep = c["deployment"]
    assert dep["policy"] == "ooco" and dep["decode_buckets"] == [8, 16, 32, 64, 128]


def test_weights_match_the_ports_layout():
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from ooco_bench.harness import port_config
    cfg = tiny.config("bfloat16")
    with layers.on_meta():
        want = build_model(port_config(cfg)).init(torch.Generator())
    got = make_weights(cfg, 3, "cpu")

    def shapes(t, p=""):
        if isinstance(t, dict):
            return {k: v for key, sub in t.items() for k, v in shapes(sub, p + "/" + key).items()}
        return {p: (tuple(t.shape), t.dtype)}
    assert shapes(got) == shapes(want)


def test_reference_matches_the_port_in_float32():
    """The plain reference and the port's Transformer.prefill compute the
    same function on the CPU in float32 (seeded random weights, bias and
    norm offsets included)."""
    from repro_torch.models.model import build_model
    from ooco_bench.harness import port_config
    cfg = tiny.config("float32")
    w = make_weights(cfg, 11, "cpu")
    ref = reference_module(cfg)
    toks = torch.randint(0, cfg["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(0))
    port = build_model(port_config(cfg), backend="ref")
    want, _ = port.prefill(w, {"tokens": toks})
    h = ref.final_hidden(cfg, w, [toks[0]])[0]
    got = ref.head(w)(h[-1:])
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    # the float8 control lies visibly apart from it
    hc = ref.final_hidden(cfg, w, [toks[0]], quant="fp8")[0]
    assert (ref.head(w, quant="fp8")(hc[-1:]) - want).abs().max() > 1e-3


def test_a_cell_mix_and_metric_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric, each a
    new file under a copy of the benchmark's directory, run through
    run_cell with no code changed."""
    bench_dir = tmp_path / "ooco_bench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        (bench_dir / sub).mkdir(parents=True)
    shutil.copy(HERE / "configs" / "dense_decoder.py", bench_dir / "configs")
    for m in BENCH["per_layer"]:
        shutil.copy(HERE / "metrics" / f"{m['name']}.py", bench_dir / "metrics")
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(tiny.config()))
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(tiny.mix()))
    (bench_dir / "cells" / "tiny.tiny.json").write_text(json.dumps(tiny.load()))
    (bench_dir / "metrics" / "runtime.rounds.py").write_text(
        'def read(record):\n    return record["counters"]["rounds"]\n')
    bench = tiny.bench()
    bench["per_layer"].append({"name": "runtime.rounds", "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "runtime",
                               "moves": "offline_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("tiny.tiny", root=tmp_path, bench_dir=bench_dir)
    assert metric_readers(["runtime.rounds"], bench_dir)["runtime.rounds"]({"counters": {"rounds": 3}}) == 3
    with tiny.one_thread():
        res, compared = run_cell(cell, bench, 2**33 + 3, tiny.SECONDS, True, "cpu",
                                 bench_dir=bench_dir)
    assert res["correct"], compared
    assert res["metrics"]["runtime.rounds"]["value"] > 0
    assert res["metrics"]["runtime.memo_s"]["value"] > 0
    assert math.isfinite(res["device"]["window_s"])
    assert list(res)[-1] == "compared"
