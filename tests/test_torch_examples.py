"""The port's five examples (``examples/torch_*.py``), each run with
``--device cpu`` at small arguments in a subprocess: exit code 0 and the
reference script's key lines. The reference's examples are not run; the
lines they would print are rebuilt from the JAX package's configs.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jax_get_config

ROOT = Path(__file__).resolve().parents[1]


def _run(script: str, *args: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                          *args], capture_output=True, text=True, timeout=100, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def quickstart(tmp_path):
    lines = _run("torch_quickstart.py", "--tokens", "3")
    full = jax_get_config("qwen3-8b")
    cfg = full.reduced()
    assert lines[0] == (f"arch={full.name} [{full.family}]  full: {full.num_layers}L "
                        f"d={full.d_model} (~{full.num_params()/1e9:.1f}B params) "
                        f"| running reduced: {cfg.num_layers}L d={cfg.d_model}")
    ids = re.fullmatch(r"generated token ids: \[(.*)\]", lines[1]).group(1).split(", ")
    assert len(ids) == 3 and all(0 <= int(t) < cfg.vocab_size for t in ids)
    assert re.fullmatch(r"h100\(tp=4\) predictions: prefill\(1024\)=[\d.]+ms \[\w+\]  "
                        r"decode\(B=64,ctx=1024\)=[\d.]+ms \[\w+\]  bs_sat=\d+", lines[2])


def colocation_sim(tmp_path):
    lines = _run("torch_colocation_sim.py", "--duration", "2")
    assert re.fullmatch(r"ooc: \d+ online requests over 2s \(mean 6\.0/s\)", lines[0])
    assert lines[1].split() == ["policy", "offQPS", "viol%", "off", "tok/s", "p99", "TTFT",
                                "p50", "TPOT"]
    rows = [ln.split() for ln in lines[2:]]
    assert [(r[0], r[1]) for r in rows] == [(p, q) for p in ("base_pd", "online_priority",
                                                             "ooco")
                                            for q in ("4.0", "12.0", "32.0")]


def serve_online_offline(tmp_path):
    lines = _run("torch_serve_online_offline.py", "--virtual-clock", "--duration", "2")
    assert lines[0] == ("serving reduced qwen2.5-7b under policy=ooco (1 strict + 1 relaxed, "
                        "virtual clock) ...")
    m = re.fullmatch(r"finished: online=(\d+)/(\d+) offline=(\d+)/(\d+) in [\d.]+s "
                     r"\(virtual time\)", lines[1])
    assert m and int(m.group(3)) > 0
    for head in ("offline throughput:", "layer-level preemptions:", "rounds:",
                 "fused dispatches:", "dispatches by kind:"):
        assert any(ln.startswith(head) for ln in lines), head


def serve_gateway(tmp_path):
    lines = _run("torch_serve_gateway.py", "--clients", "4", "--tokens", "4")
    assert lines[0] == "building 1 strict + 1 relaxed engines (reduced qwen2.5-7b) ..."
    roles = {re.search(r"\[(\S+)\]", ln).group(1): ln.split("-> ")[1]
             for ln in lines if ln.startswith("  client")}
    assert roles["disconnect"] == "cancelled after 2 tokens"
    assert roles["tight-deadline"].startswith("deadline")
    assert roles["plain"] == "finished after 4 tokens"
    assert lines[-1].endswith("(clean)")


def train_tiny(tmp_path):
    ckpt = tmp_path / "ck.npz"
    lines = _run("torch_train_tiny.py", "--steps", "4", "--layers", "1", "--d-model", "64",
                 "--seq", "16", "--batch", "2", "--ckpt", str(ckpt))
    cfg = jax_get_config("tinyllama-1.1b").reduced(layers=1, d_model=64, vocab=4096,
                                                    d_ff=1024)
    assert lines[0] == (f"{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
                        f"~{cfg.num_params()/1e6:.0f}M params, seq=16 batch=2")
    assert re.fullmatch(rf"loss [\d.]+ -> [\d.]+ \(-?\d+% reduction\); checkpoint: {ckpt}",
                        lines[-1])
    assert ckpt.exists()


@pytest.mark.parametrize("example", [quickstart, colocation_sim, serve_online_offline,
                                     serve_gateway, train_tiny], ids=lambda f: f.__name__)
def test_example_runs_on_the_cpu(example, tmp_path):
    example(tmp_path)
