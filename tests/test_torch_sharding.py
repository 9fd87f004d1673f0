"""The port's multi-device layer against the JAX package's, on the CPU.

``repro_torch.sharding.rules`` over the port's ``meta`` params must name the
same PartitionSpec as ``repro.sharding.rules`` over ``jax.eval_shape``'s
params, leaf for leaf (compared as tuples), for every assigned arch, weight
mode and production mesh; likewise the cache and batch specs, and the
abstract params, optimizer state, inputs and caches of
``repro_torch.launch.specs``. Then the port's own pieces: spec -> DTensor
placements, ``sharding.ctx.constrain`` on a 2-rank gloo group in subprocesses,
and the mesh's checks.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ASSIGNED, get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro.models.model import build_model as jax_build_model
from repro.sharding import rules as jax_rules
from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_lib, specs
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.model import build_model
from repro_torch.sharding import rules


def _import_jax_dryrun():
    """``repro.launch.dryrun``, for ``skip_reason``, with ``XLA_FLAGS`` put
    back as it was: the module appends the 512-device flag at import, which
    would give every JAX client later started in this process 512 host
    devices."""
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return dryrun


jax_dryrun = _import_jax_dryrun()   # restores XLA_FLAGS: no 512-device flag leaks

ROOT = Path(__file__).resolve().parents[1]
MESH = {"data": 16, "model": 16}
MESH3 = {"pod": 2, "data": 16, "model": 16}
MODES = ("fsdp_tp", "tp_only", "replicated")


def _flat(tree, path=""):
    """A nested dict (or the optimizer's NamedTuple of them) -> {"a/b": leaf}."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: tree}


def _jax_flat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(q, "key", getattr(q, "name", q))) for q in p): l
            for p, l in leaves}


def _same_abstract(jax_tree, port_tree):
    j, t = _jax_flat(jax_tree), _flat(port_tree)
    assert j.keys() == t.keys(), set(j) ^ set(t)
    for k in j:
        assert tuple(j[k].shape) == tuple(t[k].shape), (k, j[k].shape, t[k].shape)
        assert str(j[k].dtype) == str(t[k].dtype).removeprefix("torch."), (k, j[k], t[k])
        assert t[k].device.type == "meta", k


def _models(arch, **kw):
    return jax_build_model(jax_get_config(arch), **kw), build_model(get_config(arch), **kw)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_specs_match_jax(arch):
    """Every leaf, both production meshes, all three weight modes."""
    jm, tm = _models(arch)
    jp, tp = jax_specs.abstract_params(jm), specs.abstract_params(tm)
    _same_abstract(jp, tp)
    for mesh in (MESH, MESH3):
        for mode in MODES:
            want = _jax_flat(jax_rules.param_specs(jp, mesh, mode))
            got = _flat(rules.param_specs(tp, mesh, mode))
            assert want.keys() == got.keys()
            for k in want:
                assert isinstance(got[k], rules.PartitionSpec)
                assert tuple(got[k]) == tuple(want[k]), (arch, mode, k, want[k], got[k])


@pytest.mark.parametrize("arch", ASSIGNED)
def test_abstract_state_matches_jax(arch):
    """Optimizer state and every workload's inputs, shapes and dtypes."""
    jm, tm = _models(arch)
    jp, tp = jax_specs.abstract_params(jm), specs.abstract_params(tm)
    _same_abstract(jax_specs.abstract_opt_state(jp), specs.abstract_opt_state(tp))
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        _same_abstract(jax_specs.input_specs(jcfg, JAX_SHAPES[name]),
                       specs.input_specs(cfg, shape))


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_and_cache_specs_match_jax(arch, shape_name):
    """The abstract cache (keys, shapes, dtypes; whisper over 1500 frames)
    and its specs on both meshes; the skip set is the reference's."""
    assert specs.skip_reason(arch, shape_name) == jax_dryrun.skip_reason(arch, shape_name)
    if specs.skip_reason(arch, shape_name):
        return
    lc = shape_name == "long_500k"
    jm, tm = _models(arch, long_context=lc)
    jshape, shape = JAX_SHAPES[shape_name], INPUT_SHAPES[shape_name]
    jc, tc = jax_specs.abstract_cache(jm, jshape), specs.abstract_cache(tm, shape)
    _same_abstract(jc, tc)
    for multi_pod, mesh in ((False, MESH), (True, MESH3)):
        want = jax_rules.cache_specs(jax_get_config(arch), jc, jshape.global_batch,
                                     multi_pod, mesh)
        got = rules.cache_specs(get_config(arch), tc, shape.global_batch, multi_pod, mesh)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
        for key, leaf in tc.items():
            for dim, ax in zip(leaf.shape, got[key]):
                if ax is not None:
                    axes = ax if isinstance(ax, tuple) else (ax,)
                    assert dim % int(np.prod([mesh[a] for a in axes])) == 0, (key, got[key])


def test_batch_axis_and_spec_match_jax():
    cases = [(256, False, MESH), (1, False, MESH), (8, False, MESH),
             (256, True, MESH3), (32, True, MESH3), (2, True, MESH3)]
    for batch, multi_pod, mesh in cases:
        assert rules.batch_axis(batch, multi_pod, mesh) == \
            jax_rules.batch_axis(batch, multi_pod, mesh)
        for arch in ASSIGNED:
            for kind in ("train", "prefill", "decode"):
                want = jax_rules.batch_spec(jax_get_config(arch), kind, batch, multi_pod, mesh)
                got = rules.batch_spec(get_config(arch), kind, batch, multi_pod, mesh)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}
    assert rules.batch_axis(256, False, MESH) == ("data",)
    assert rules.batch_axis(2, True, MESH3) == ("pod",)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_port_specs_valid_and_big_leaves_sharded(arch):
    """The reference's two properties on the port's own specs: every named
    axis divides its dim, and no leaf over 64 MB stays replicated (but an
    embedding whose vocab does not divide, by the reference's design)."""
    params = specs.abstract_params(build_model(get_config(arch)))
    for mesh in (MESH, MESH3):
        flat = _flat(params)
        pspecs = _flat(rules.param_specs(params, mesh))
        for key, leaf in flat.items():
            spec = pspecs[key]
            assert len(spec) <= leaf.ndim, (key, spec, leaf.shape)
            for dim, ax in zip(leaf.shape, spec):
                if ax is not None:
                    axes = ax if isinstance(ax, tuple) else (ax,)
                    assert dim % int(np.prod([mesh[a] for a in axes])) == 0, (key, spec)
            if key.endswith("embed") and leaf.shape[0] % mesh["model"]:
                continue
            if leaf.numel() * leaf.element_size() > 64e6:
                assert any(ax is not None for ax in spec), (key, leaf.shape)


def test_partition_spec_is_canonical_like_jax():
    P, JP = rules.PartitionSpec, jax.sharding.PartitionSpec
    for axes in [(("data",), None), ((), "model"), (("pod", "data"), None, "model"), ()]:
        assert tuple(P(*axes)) == tuple(JP(*axes))


class _Mesh:
    """What ``placements`` reads of a mesh: its dim names."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements():
    P = rules.PartitionSpec
    m2, m3 = _Mesh("data", "model"), _Mesh("pod", "data", "model")
    assert rules.placements(P("data", "model"), m2) == [Shard(0), Shard(1)]
    assert rules.placements(P(None, "model", "data"), m2) == [Shard(2), Shard(1)]
    assert rules.placements(P(None, None), m2) == [Replicate(), Replicate()]
    assert rules.placements(P(("pod", "data"), None, "model"), m3) == \
        [Shard(0), Shard(0), Shard(2)]
    assert rules.placements(P(None, ("data",)), m3) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        rules.placements(P(("data", "pod"), None), m3)
    with pytest.raises(ValueError, match="not a dim"):
        rules.placements(P("pod"), m2)
    with pytest.raises(ValueError, match="twice"):
        rules.placements(P("data", "data"), m2)


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh((1, 1), ("data", "model"), device_type="cpu")


CTX_CODE = """
import sys
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh, make_production_mesh, mesh_shape_dict
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import activate, constrain, standard_mapping

rank, store = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
try:
    make_production_mesh(device_type="cpu")
    raise SystemExit("a 16 x 16 mesh over 2 ranks was built")
except ValueError as e:
    assert "256 ranks" in str(e), e
mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
assert mesh_shape_dict(mesh) == {"data": 2, "model": 1}
full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
plain = full.clone()
x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
assert constrain(x, "act_btd") is x                       # outside activate
with activate(standard_mapping(("data",))):
    assert constrain(plain, "act_btd") is plain           # a plain tensor
    assert constrain(x, "no_such_name") is x
    y = constrain(x, "act_btd")
    assert isinstance(y, DTensor) and y.placements == (Shard(0), Replicate()), y.placements
    assert tuple(y.to_local().shape) == (2, 6, 8), y.to_local().shape
    assert torch.equal(y.to_local(), full[2 * rank:2 * rank + 2])
    assert torch.equal(y.full_tensor(), full)
    z = constrain(x, "logits_btv")
    assert z.placements == (Shard(0), Shard(2)), z.placements
    assert torch.equal(z.full_tensor(), full)
    v = constrain(distribute_tensor(full[0, 0], mesh, [Replicate(), Replicate()]), "act_btd")
    assert v.placements == (Replicate(), Replicate())     # spec longer than the rank
params = {"layers": {"attn": {"wq": {"w": torch.randn(2, 4, 6, generator=torch.Generator().manual_seed(0))}}}}
sp = rules.param_specs(params, mesh_shape_dict(mesh))
dp = rules.distribute_params(params, mesh, sp)
w = dp["layers"]["attn"]["wq"]["w"]
assert w.placements == (Shard(1), Shard(2)), (sp, w.placements)
assert torch.equal(w.full_tensor(), params["layers"]["attn"]["wq"]["w"])
dist.destroy_process_group()
print("ok")
"""


def test_ctx_and_mesh_on_two_gloo_ranks(tmp_path):
    """``constrain`` is the identity outside ``activate``, on a plain tensor
    and for an unmapped name; inside ``activate(standard_mapping(("data",)))``
    a replicated DTensor comes back sharded on dim 0 with each rank's half and
    the same full tensor. A 16 x 16 mesh over 2 ranks raises; params are
    placed by their specs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", CTX_CODE, str(r), str(tmp_path / "store")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0 and out.strip().endswith("ok"), err[-3000:]


def test_no_forced_host_device_count_in_this_process():
    """No module of the suite leaves the dry run's 512-device flag in this
    process's ``XLA_FLAGS``: under ``--dist loadfile`` every worker imports
    every test module before its first test, so a leak would give each
    worker's JAX client 512 host devices (and a thread for each)."""
    assert "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", "")
    assert jax.device_count() == 1
