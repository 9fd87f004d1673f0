"""The correctness check fails a broken timed path: a whole run of the tiny
cell on the CPU (the harness's look for a card skipped), once clean, once
with the control (the reference in float8) in the program's place, and
once with each fault of ``faults.py`` planted underneath; on the card, the
control and each fault at a real cell's own size and limit."""
import json
import subprocess
import sys

import pytest
import torch

from ooco_bench import faults, tiny
from ooco_bench.cell import HERE
from ooco_bench.run import run_cell

SEED = 2**33 + 17


def run(control=False):
    with tiny.one_thread():
        return run_cell(tiny.cell(), tiny.bench(), SEED, tiny.SECONDS, False, "cpu",
                        control=control)


def test_clean_run_is_correct_and_the_control_is_not():
    res, compared = run(control=True)
    g = res["detail"]["gaps"]
    assert res["correct"], compared
    limit = compared["logit_gap"]["limit"]
    assert g["program"]["widest"] <= limit < g["control"]["widest"]
    assert compared["tokens_compared"]["value"] >= compared["tokens_compared"]["limit"]


@pytest.mark.parametrize("plant", list(faults.PLANTS.values()), ids=lambda f: f"_{f.__name__}")
def test_a_planted_fault_reads_not_correct(plant, monkeypatch):
    plant(monkeypatch.setattr)
    res, compared = run()
    assert not res["correct"], compared
    assert compared["logit_gap"]["value"] > compared["logit_gap"]["limit"]


@pytest.mark.cuda
def test_control_on_the_card_at_the_cells_size():
    """On the card: one seed of control.py at qwen2.5-7b.conv's own size
    and window; the control's widest gap lies above the cell's limit, the
    program's below it."""
    last, limit = _control_on_card()
    assert last["program_widest_max"] <= limit < last["control_widest_min"]


@pytest.mark.cuda
@pytest.mark.parametrize("plant", list(faults.PLANTS))
def test_a_planted_fault_on_the_card_at_the_cells_size(plant):
    """On the card: one seed of qwen2.5-7b.conv at its own size and window
    with the fault planted; the widest gap lies above the cell's limit."""
    last, limit = _control_on_card("--plant", plant)
    assert last["program_widest_min"] > limit


def _control_on_card(*extra):
    """control.py on one seed of qwen2.5-7b.conv with a run's own window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    seconds = json.loads((HERE.parent / "BENCHMARK.json").read_text())["run_seconds"]
    out = subprocess.run([sys.executable, "ooco_bench/control.py", "--workload",
                          "qwen2.5-7b.conv", "--seeds", str(SEED), "--seconds", str(seconds),
                          *extra], capture_output=True, text=True, timeout=900,
                         cwd=str(HERE.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    limit = json.loads((HERE / "cells" / "qwen2.5-7b.conv.json").read_text())["limits"]["logit_gap"]
    return last, limit
