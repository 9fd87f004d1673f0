"""The port's dry run (``repro_torch.launch.dryrun``) and its per-device
counter (``repro_torch.launch.hlo_analysis``), against the reference's gate
(``tests/test_dryrun.py``) and the reference's analytic formulas.

Every case that starts a process group runs in a subprocess, so that the
fake group of 256 ranks never meets another test. The sharding helpers that
make the layers run over DTensors are held to be the identity, bit for bit,
on plain tensors.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.hardware import TPU_V5E
from repro.core.perf_model import PerfModel as JaxPerfModel
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.sharding import ctx

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str, timeout: int = 100) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


GATE = """
import json
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.launch import specs as sp
from repro_torch.launch.dryrun import lower_case
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.model import build_model
# the single-device count of the same step, on meta tensors
cfg, shape = get_config("{arch}"), INPUT_SHAPES["{shape}"]
model = build_model(cfg, long_context="{shape}" == "long_500k", backend="ref")
with FlopCounterMode(display=False) as fc:
    model.decode_step(sp.abstract_params(model), sp.input_specs(cfg, shape)["tokens"],
                      sp.abstract_cache(model, shape))
res = lower_case("{arch}", "{shape}")
rf = res["roofline"]
assert rf["hlo_flops_per_device"] > 0
assert rf["dominant"] in ("compute", "memory", "collective")
ratio = rf["hlo_flops_cluster"] / max(rf["analytic_flops_cluster"], 1)
assert 0.2 < ratio < 5.0, ratio
import torch.distributed as dist
assert not dist.is_initialized()        # the group was torn down
print(json.dumps({{"ratio": ratio, "roofline": rf, "hlo": res["hlo"],
                  "memory": res["memory"], "chips": res["chips"],
                  "single_device": fc.get_total_flops()}}))
"""


def _reference_analytic(arch: str, shape_name: str) -> tuple[float, float, float]:
    """The reference's ``roofline_terms`` formulas
    (``src/repro/launch/dryrun.py:191-204``) with its ``PerfModel``."""
    cfg, shape = jax_get_config(arch), JAX_SHAPES[shape_name]
    pm = JaxPerfModel(cfg, TPU_V5E, tp=1)
    if shape.kind == "train":
        est = pm.prefill_estimate([shape.seq_len] * shape.global_batch)
        return (3.0 * est.flops, 3.0 * est.bytes,
                6.0 * cfg.num_active_params() * shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        est = pm.prefill_estimate([shape.seq_len] * shape.global_batch)
        return (est.flops, est.bytes,
                2.0 * cfg.num_active_params() * shape.global_batch * shape.seq_len)
    est = pm.decode_estimate([shape.seq_len] * shape.global_batch)
    return est.flops, est.bytes, 2.0 * cfg.num_active_params() * shape.global_batch


@pytest.mark.parametrize("arch,shape", [
    ("tinyllama-1.1b", "decode_32k"),
    ("rwkv6-1.6b", "long_500k"),
])
def test_dryrun_gate_and_analytic_terms(arch, shape):
    """The reference's gate on the port, on a fake group of 256 ranks; the
    analytic terms equal the reference's formulas; per-device FLOPs come
    from local shards, so the cluster figure is at least the single-device
    count of the same step, not 256x below it."""
    out = _run(GATE.format(arch=arch, shape=shape))
    rf = out["roofline"]
    flops, nbytes, model_flops = _reference_analytic(arch, shape)
    assert rf["analytic_flops_cluster"] == flops
    assert rf["analytic_bytes_cluster"] == nbytes
    assert rf["model_flops"] == model_flops
    assert out["chips"] == 256
    assert rf["hlo_flops_cluster"] >= out["single_device"] > 0
    assert set(rf["collective_breakdown"]) == set(hlo_analysis.COLLECTIVES)
    assert out["hlo"]["unparsed_whiles"] == 0
    assert out["memory"]["argument_bytes"] > 0 and out["memory"]["temp_bytes"] is None


LOCAL = """
import json, torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_mesh
out = {}
with dryrun.fake_group(256):
    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    a = torch.empty(256, 128, 4096, device="meta", dtype=torch.bfloat16)
    b = torch.empty(4096, 11008, device="meta", dtype=torch.bfloat16)
    sharded = (distribute_tensor(a, mesh, [Shard(0), Replicate()]),
               distribute_tensor(b, mesh, [Replicate(), Shard(1)]))
    whole = (distribute_tensor(a, mesh, [Replicate(), Replicate()]),
             distribute_tensor(b, mesh, [Replicate(), Replicate()]))
    out["sharded"] = hlo_analysis.analyze(torch.matmul, *sharded)
    out["whole"] = hlo_analysis.analyze(torch.matmul, *whole)
    x = distribute_tensor(torch.empty(64, 256, device="meta"), mesh, [Shard(0), Replicate()])
    out["a2a"] = hlo_analysis.analyze(x.redistribute, mesh, [Shard(1), Replicate()])
    out["gather"] = hlo_analysis.analyze(x.redistribute, mesh, [Replicate(), Replicate()])
print(json.dumps(out))
"""


def test_per_device_counts_are_local():
    """A (256, 128, 4096) @ (4096, 11008) product sharded evenly over (16,
    16) counts 2 M_loc K_loc N_loc a device; a replicated copy counts the
    whole product on every device. A Shard-to-Shard move counts as one
    all-to-all of the local shard's bytes, not as the fake CPU group's
    all-gather fallback; a gather counts its result."""
    out = _run(LOCAL)
    m_loc, k_loc, n_loc = 256 // 16 * 128, 4096, 11008 // 16
    assert out["sharded"]["dot_flops_per_device"] == 2 * m_loc * k_loc * n_loc
    assert out["sharded"]["collective_bytes_per_device"] == 0
    assert out["whole"]["dot_flops_per_device"] == 2 * 256 * 128 * 4096 * 11008
    a2a = out["a2a"]["collective_breakdown"]
    assert a2a["all-to-all"] == 64 // 16 * 256 * 4 and a2a["all-gather"] == 0
    assert out["gather"]["collective_breakdown"]["all-gather"] == 64 * 256 * 4


ONE_RANK = """
import json, torch
from torch.utils.flop_counter import FlopCounterMode
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import rules
cfg = get_config("tinyllama-1.1b").reduced()
model = build_model(cfg, backend="ref")
params = model.init(torch.Generator().manual_seed(0))
tokens = torch.arange(4, dtype=torch.int32)
def cache():
    return model.init_cache(4, 64, prefilled_len=40, device="cpu")
with FlopCounterMode(display=False) as fc:
    model.decode_step(params, tokens, cache())
plain = hlo_analysis.analyze(model.decode_step, params, tokens, cache())
with dryrun.fake_group(1):
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    specs = rules.param_specs(params, dryrun.mesh_shape_dict(mesh))
    dparams = rules.distribute_params(params, mesh, specs)
    c = cache()
    dcache = rules.distribute_params(c, mesh, rules.cache_specs(
        cfg, c, 4, False, dryrun.mesh_shape_dict(mesh)))
    dtok = distribute_tensor(tokens, mesh, rules.placements(rules.P("data"), mesh))
    with implicit_replication():
        placed = hlo_analysis.analyze(model.decode_step, dparams, dtok, dcache)
print(json.dumps({"flop_counter": fc.get_total_flops(), "plain": plain,
                  "placed": placed}))
"""


def test_one_rank_count_equals_flop_counter():
    """On a (1, 1) mesh, and on plain tensors, the counter reads what
    ``FlopCounterMode`` reads on the real tensors (chip_smoke's phase 7
    holds the same at full width on the card)."""
    out = _run(ONE_RANK)
    assert out["flop_counter"] > 0
    assert out["plain"]["dot_flops_per_device"] == out["flop_counter"]
    assert out["placed"]["dot_flops_per_device"] == out["flop_counter"]
    assert out["placed"]["collective_bytes_per_device"] == 0


def test_run_all_records_a_failing_case_and_goes_on(monkeypatch, capsys):
    calls = []

    def fake_lower_case(arch, shape_name, **kw):
        calls.append((arch, shape_name, kw))
        if arch == "qwen3-8b":
            raise RuntimeError("planted")
        return {"arch": arch, "shape": shape_name, "compile_s": 0.0,
                "memory": {"argument_bytes": 1e9},
                "roofline": {"hlo_flops_cluster": 1.0, "analytic_flops_cluster": 1.0,
                             "dominant": "compute"}}

    monkeypatch.setattr(dryrun, "lower_case", fake_lower_case)
    res = dryrun.run_all(False, None, archs=["qwen3-8b", "rwkv6-1.6b", "tinyllama-1.1b"],
                         shapes=["decode_32k", "long_500k"])
    assert len(res) == 6
    errors = [r for r in res if "error" in r]
    assert [(r["arch"], r["shape"]) for r in errors] == [("qwen3-8b", "decode_32k")]
    assert errors[0]["error"] == "RuntimeError: planted"
    skipped = {(r["arch"], r["shape"]) for r in res if "skipped" in r}
    assert skipped == {("qwen3-8b", "long_500k"), ("tinyllama-1.1b", "long_500k")}
    assert all(kw == {"multi_pod": False, "seq_attn": False} for *_, kw in calls)
    text = capsys.readouterr().out
    assert "FAIL qwen3-8b x decode_32k [16x16]: RuntimeError: planted" in text
    assert "6 cases: 1 failures" in text


def test_serving_weight_mode_matches_reference():
    from repro.configs import ASSIGNED as JAX_ASSIGNED
    from repro_torch.configs import ASSIGNED, get_config
    assert ASSIGNED == JAX_ASSIGNED
    # the reference's rule, restated from src/repro/launch/dryrun.py:227-239
    for arch in ASSIGNED:
        cfg = jax_get_config(arch)
        n = cfg.num_params()
        want = ("fsdp_tp" if cfg.is_moe else "replicated" if 2 * n < 6e9
                else "tp_only" if 2 * n / 16 < 8e9 else "fsdp_tp")
        assert dryrun.serving_weight_mode(get_config(arch)) == want, arch


def test_roofline_terms_use_the_cards_rates():
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.models.config import INPUT_SHAPES
    hlo = {"dot_flops_per_device": 1e12, "collective_bytes_per_device": 9e8,
           "collective_breakdown": {k: 0.0 for k in hlo_analysis.COLLECTIVES}}
    rf = dryrun.roofline_terms(get_config("tinyllama-1.1b"), INPUT_SHAPES["decode_32k"],
                               hlo, 256, False)
    assert rf["compute_s"] == 1e12 / H100_SXM.peak_flops
    assert rf["memory_s"] == rf["analytic_bytes_cluster"] / 256 / H100_SXM.peak_hbm_bw
    assert rf["collective_s"] == 9e8 / dryrun.NVLINK_BW == 9e8 / 450e9
    assert rf["dominant"] == max(("compute", "memory", "collective"),
                                 key=lambda k: rf[f"{k}_s"])
    assert rf["hlo_flops_cluster"] == 256e12


def test_sharding_helpers_are_the_identity_on_plain_tensors():
    """heads_ready, reduce_partial and constrain return a plain tensor as it
    is; write_slots_ writes what the indexed assignment it replaced wrote."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 8, generator=g)
    assert ctx.heads_ready(x, 3, dim=1) is x
    assert ctx.reduce_partial(x) is x
    with ctx.activate(ctx.standard_mapping(("data",))):
        assert ctx.constrain(x, "act_btd") is x
    cache = torch.randn(4, 6, 2, 5, generator=g).to(torch.bfloat16)
    want = cache.clone()
    slots = torch.tensor([0, 5, 3, 3])
    new = torch.randn(4, 2, 5, generator=g)
    want[torch.arange(4), slots] = new.to(torch.bfloat16)
    out = ctx.write_slots_(cache, slots, new)
    assert out is cache and torch.equal(cache, want)


WRITE = """
import json, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import ctx
torch.manual_seed(0)
B, C = 4, 8
full = torch.randn(B, C, 2, 3)
slots = torch.tensor([1, 6, 3, 7])
new = torch.randn(B, 2, 3)
want = full.clone()
want[torch.arange(B), slots] = new
res = {}
# each rank of a (2, 2) mesh holds rows by "data" and slots by "model"
for rank in range(4):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    i, j = divmod(rank, 2)
    local = full[2 * i:2 * i + 2, 4 * j:4 * j + 4].clone()
    dst = DTensor.from_local(local, mesh, [Shard(0), Shard(1)])
    rep = lambda t: DTensor.from_local(t, mesh, [Replicate(), Replicate()])
    ctx.write_slots_(dst, rep(slots), rep(new))
    res[rank] = torch.equal(dst.to_local(), want[2 * i:2 * i + 2, 4 * j:4 * j + 4])
    q = DTensor.from_local(torch.empty(2, 2, 8, 4), mesh, [Shard(0), Shard(2)])
    dims = lambda t: [p.dim if p.is_shard() else "R" for p in t.placements]
    res[f"heads{rank}"] = dims(ctx.heads_ready(q, 1, dim=2))
    res[f"heads_ok{rank}"] = dims(ctx.heads_ready(q, 8, dim=2))
    dist.destroy_process_group()
print(json.dumps(res))
"""


def test_write_slots_and_heads_ready_on_dtensors():
    """Each rank of a (2, 2) mesh writes exactly the entries of its own rows
    and slots; heads_ready replicates a head dim whose shards do not divide
    the head count, and keeps one whose shards do."""
    out = _run(WRITE)
    assert all(out[str(r)] for r in range(4)), out
    for r in range(4):
        assert out[f"heads{r}"] == [0, "R"]
        assert out[f"heads_ok{r}"] == [0, 2]


def test_local_bytes_reads_local_shards():
    t = torch.empty(8, 4, dtype=torch.bfloat16)
    assert dryrun.local_bytes({"a": t, "b": (t, [t])}) == 3 * 8 * 4 * 2
    assert dryrun.local_bytes() == 0
