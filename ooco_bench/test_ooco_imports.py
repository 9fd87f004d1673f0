"""A run of the port loads no JAX and no JAX package; the plain reference
loads nothing of the port. Checked in fresh subprocesses, since other test
files of the same pytest worker import JAX."""
import json
import os
import subprocess
import sys

from ooco_bench.cell import HERE

ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

HARNESS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import ooco_bench.run, ooco_bench.harness, ooco_bench.judge, ooco_bench.profile
import ooco_bench.sweep, ooco_bench.control, ooco_bench.clientstats, ooco_bench.counts
import ooco_bench.faults
from ooco_bench.cell import HERE, load_json, metric_readers, reference_module
bench = load_json(HERE.parent / "BENCHMARK.json")
metric_readers([m["name"] for m in bench["per_layer"]])
for c in bench["configs"]:
    reference_module(load_json(HERE.parent / c["file"]))
# what a run of the port loads
import repro_torch.cluster.runtime, repro_torch.models.model, repro_torch.core.hardware
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from ooco_bench.cell import HERE, load_json, reference_module
reference_module(load_json(HERE / "configs" / "qwen2.5-7b.json"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), src=str(ROOT / "src"))],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax_and_no_jax_package():
    mods = top_level(HARNESS)
    assert "repro_torch" in mods and "ooco_bench" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = top_level(REFERENCE)
    assert "torch" in mods
    assert not mods & {"repro_torch", *FORBIDDEN}


def test_no_card_no_result():
    """Without a CUDA card run.py exits 2 and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "ooco_bench/run.py", "--workload", "qwen2.5-7b.conv",
                          "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 2
    assert out.stdout.strip() == ""
