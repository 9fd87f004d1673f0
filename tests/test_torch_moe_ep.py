"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) against the
JAX package's, on the CPU.

Reduced granite-moe-3b-a800m (4 experts, top-2) in f32, x of (2, 12, d) from
a numpy seed, the JAX weights carried across. The JAX side runs its
``shard_map`` function in one subprocess per mesh over 4 forced host devices,
on meshes (1, A) over the first A devices; the port runs ``moe_mlp_ep`` on a
gloo process group of world size A, one subprocess per rank, rank r taking
token block r and experts [r E_loc, (r + 1) E_loc). A = 3 pads 4 experts to
6. Capacity factor 8.0 drops nothing, 0.5 drops. Tolerance 2e-5 abs (f32 on
both sides; the orders of summation differ).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models import moe_ep as jax_moe_ep
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import moe_ep

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
SIZES = (2, 3, 4)
CFS = (8.0, 0.5)

JAX_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models.moe_ep import moe_mlp_ep, moe_ep_ref, pad_experts

cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), dtype="float32")
A, data = int(sys.argv[1]), np.load(sys.argv[2])
p = {k: jnp.asarray(data["p_" + k]) for k in ("router", "gate", "up", "down")}
x = data["x"]
res = {}
axis_type = getattr(jax.sharding, "AxisType", None)
kw = {"axis_types": (axis_type.Auto,) * 2} if axis_type is not None else {}
mesh = jax.make_mesh((1, A), ("data", "model"), devices=jax.devices()[:A], **kw)
pp, _ = pad_experts(p, cfg, A)
res[f"ref_{A}"] = np.asarray(moe_ep_ref(pp, jnp.asarray(x), cfg))
for cf in (8.0, 0.5):
    with jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") else mesh:
        out = moe_mlp_ep(pp, jnp.asarray(x), cfg, mesh, capacity_factor=cf)
    res[f"ep_{A}_{cf}"] = np.asarray(out)
np.savez(sys.argv[3], **res)
"""

RANK_CODE = """
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import moe_ep

rank, A, store, src, dst = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=A)
cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), dtype="float32")
data = np.load(src)
p = params_from_jax({k: data["p_" + k] for k in ("router", "gate", "up", "down")}, cfg)
pp, E_pad = moe_ep.pad_experts(p, cfg, A)
E_loc = E_pad // A
local = {"router": pp["router"],
         **{k: pp[k][rank * E_loc:(rank + 1) * E_loc] for k in ("gate", "up", "down")}}
x = torch.from_numpy(data["x"]).reshape(-1, cfg.d_model)
T_loc = x.shape[0] // A
x_loc = x[rank * T_loc:(rank + 1) * T_loc]
res = {"eidx": moe_ep.route(local["router"], x_loc, cfg)[1].numpy()}
for cf in (8.0, 0.5):
    moe_ep.moe_mlp_ep.collectives = 0
    res[f"ep_{cf}"] = moe_ep.moe_mlp_ep(local, x_loc, cfg, dist.group.WORLD,
                                        capacity_factor=cf).numpy()
    res[f"collectives_{cf}"] = np.array(moe_ep.moe_mlp_ep.collectives)
np.savez(dst, **res)
dist.destroy_process_group()
"""


def _env():
    # one intra-op thread a process: the 12 processes run together
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _jax_cfg():
    return dataclasses.replace(jax_get_config("granite-moe-3b-a800m").reduced(),
                               dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX weights and x, then a JAX subprocess for each group size and
    every rank of every group size, all started together (the JAX side's
    eager ``shard_map`` calls take most of the time). Returns (the JAX side's
    arrays with the inputs, per size the ranks' outputs concatenated in rank
    order)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    p = jax_moe.init_moe(jax.random.PRNGKey(0), _jax_cfg())
    inputs = {"x": np.random.default_rng(1).standard_normal((2, 12, 256)).astype(np.float32),
              **{"p_" + k: np.asarray(v) for k, v in p.items()}}
    src = tmp / "in.npz"
    np.savez(src, **inputs)
    procs = {("jax", A): subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(A), str(src), str(tmp / f"jax{A}.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for A in SIZES}
    procs.update({(A, r): subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, str(r), str(A), str(tmp / f"store{A}"), str(src),
         str(tmp / f"out{A}_{r}.npz")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for A in SIZES for r in range(A)})
    errs = {}
    for key, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        if proc.returncode:
            errs[key] = err[-2000:]
    assert not errs, errs
    port = {}
    for A in SIZES:
        ranks = [dict(np.load(tmp / f"out{A}_{r}.npz")) for r in range(A)]
        port[A] = {k: (np.concatenate([r[k] for r in ranks]) if ranks[0][k].ndim
                       else [int(r[k]) for r in ranks]) for k in ranks[0]}
    jax_side = dict(inputs)
    for A in SIZES:
        jax_side.update(np.load(tmp / f"jax{A}.npz"))
    return jax_side, port


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_run(runs):
    return runs[1]


def _cfg():
    return dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), dtype="float32")


def _port_params(jax_run):
    return params_from_jax({k: jax_run["p_" + k] for k in ("router", "gate", "up", "down")},
                           _cfg())


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("A", SIZES)
def test_moe_mlp_ep_matches_jax(jax_run, port_run, A, cf):
    """Each rank's block, concatenated, equals the JAX shard_map output: same
    routing, same capacity drops, same combine. Three collectives a call."""
    want = jax_run[f"ep_{A}_{cf}"].reshape(-1, jax_run["x"].shape[-1])
    got = port_run[A][f"ep_{cf}"]
    err = float(np.abs(got - want).max())
    assert err < TOL, (A, cf, err)
    assert port_run[A][f"collectives_{cf}"] == [3] * A


@pytest.mark.parametrize("A", SIZES)
def test_capacity_drops_show(jax_run, port_run, A):
    """At capacity factor 0.5 choices drop (the output moves), at 8.0 none."""
    d = jax_run["x"].shape[-1]
    moved = np.abs(jax_run[f"ep_{A}_0.5"] - jax_run[f"ep_{A}_8.0"]).max()
    assert moved > 100 * TOL
    assert np.abs(port_run[A]["ep_0.5"] - port_run[A]["ep_8.0"]).max() > 100 * TOL
    no_drop = np.abs(jax_run[f"ep_{A}_8.0"] - jax_run[f"ref_{A}"]).reshape(-1, d).max()
    assert no_drop < TOL


@pytest.mark.parametrize("A", SIZES)
def test_no_choice_on_a_dead_expert(port_run, A):
    cfg = _cfg()
    eidx = port_run[A]["eidx"]
    assert eidx.shape == (24, cfg.experts_per_token)
    assert eidx.max() < cfg.num_experts


@pytest.mark.parametrize("A", SIZES)
def test_moe_ep_ref_matches_jax(jax_run, port_run, A):
    """The port's oracle on the padded weights equals the JAX one; at
    capacity factor 8.0 the port's EP output equals its own oracle."""
    cfg = _cfg()
    pp, _ = moe_ep.pad_experts(_port_params(jax_run), cfg, A)
    x = torch.from_numpy(jax_run["x"])
    ref = moe_ep.moe_ep_ref(pp, x, cfg).numpy()
    assert np.abs(ref - jax_run[f"ref_{A}"]).max() < TOL
    ep = port_run[A]["ep_8.0"].reshape(ref.shape)
    assert np.abs(ep - ref).max() < TOL


@pytest.mark.parametrize("A", SIZES)
def test_pad_experts_matches_jax(jax_run, A):
    """Shapes, the carried slabs, and zeros in the dead slots and router
    columns, as the JAX package pads them."""
    jp = {k: jnp.asarray(jax_run["p_" + k]) for k in ("router", "gate", "up", "down")}
    jpp, jE = jax_moe_ep.pad_experts(jp, _jax_cfg(), A)
    pp, E = moe_ep.pad_experts(_port_params(jax_run), _cfg(), A)
    assert E == jE == -(-4 // A) * A
    for k in ("router", "gate", "up", "down"):
        assert tuple(pp[k].shape) == tuple(jpp[k].shape)
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jpp[k]))
    assert not pp["gate"][4:].any() and not pp["router"][:, 4:].any()


def test_moe_mlp_ep_needs_a_process_group(jax_run):
    """No group, no shortcut: the call raises instead of skipping the
    exchange."""
    cfg = _cfg()
    pp, _ = moe_ep.pad_experts(_port_params(jax_run), cfg, 2)
    with pytest.raises(RuntimeError, match="process group"):
        moe_ep.moe_mlp_ep(pp, torch.from_numpy(jax_run["x"]), cfg, None)
