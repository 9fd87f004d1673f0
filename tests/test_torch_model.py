"""The port's model pieces (``repro_torch.models``) against the JAX package's,
on the same numpy-made inputs and the same weights carried across with
``params_from_jax``; plus the weight round trip and the port's import
isolation.

Tolerances: f32 compares at 2e-5 (XLA and torch sum in other orders and their
sin/cos differ in the last ulps); bf16 at 2e-2 (one or two bf16 roundings of
values of order 1, where XLA and torch round at different points).
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
from repro.models import attention as jattn, layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import attention, layers
from repro_torch.models.model import build_model

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(dtype, **kw):
    jc = dataclasses.replace(jax_get_config("qwen2.5-7b").reduced(), dtype=dtype, **kw)
    tc = dataclasses.replace(get_config("qwen2.5-7b").reduced(), dtype=dtype, **kw)
    return jc, tc


def _both(x: np.ndarray, dtype):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x, jnp.float32).astype(dtype),
            torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype)))


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_rope_mlp_match_jax(dtype):
    rng = np.random.default_rng(0)
    jc, tc = _cfgs(dtype)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(256)).astype(np.float32)
    jx, tx = _both(x, dtype)
    _close(layers.rmsnorm({"scale": _both(scale, dtype)[1]}, tx),
           jlayers.rmsnorm({"scale": _both(scale, dtype)[0]}, jx), dtype)

    h = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5))
    jh, th = _both(h, dtype)
    _close(layers.apply_rope(th, torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jh, jnp.asarray(pos, jnp.int32), 1e6), dtype)

    for act in ("silu", "gelu"):
        jp = jlayers.init_mlp(jax.random.PRNGKey(1), 256, 96, jc.jnp_dtype, act)
        tp = params_from_jax(_to_np(jp), tc)
        _close(layers.mlp(tp, tx, act), jlayers.mlp(jp, jx, act), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", [{}, {"num_heads": 4, "num_kv_heads": 2, "head_dim": 64},
                                     {"qk_norm": True, "attn_bias": False}])
def test_attention_matches_jax(dtype, variant):
    """_project_qkv (bias, qk-norm, rope) and attn_prefill with padded
    kv_lens: the port's flash-prefill wrapper (its plain version on CPU) and
    the ``ref`` backend both against the JAX XLA flash path."""
    rng = np.random.default_rng(1)
    jc, tc = _cfgs(dtype, **variant)
    jp = jattn.init_attn(jax.random.PRNGKey(2), jc)
    tp = params_from_jax(_to_np(jp), tc)
    B, S = 2, 24
    x = rng.standard_normal((B, S, 256)).astype(np.float32)
    jx, tx = _both(x, dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jq = jattn._project_qkv(jp, jx, jc, jnp.asarray(pos))
    tq = attention._project_qkv(tp, tx, tc, torch.from_numpy(pos.copy()))
    for a, b in zip(tq, jq):
        _close(a, b, dtype)
    lens = np.array([S, 17], np.int32)
    jout, _ = jattn.attn_prefill(jp, jx, jnp.asarray(pos), jc,
                                 kv_lens=jnp.asarray(lens), impl="xla")
    for backend in ("cuda", "ref"):
        tout, _ = attention.attn_prefill(tp, tx, torch.from_numpy(pos.copy()), tc,
                                         kv_lens=torch.from_numpy(lens),
                                         backend=backend)
        _close(tout, jout, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_and_logits_match_jax(dtype):
    jc, tc = _cfgs(dtype)
    jm, tm = jax_build_model(jc, remat=False), build_model(tc)
    jp = jm.init(jax.random.PRNGKey(3))
    tp = params_from_jax(_to_np(jp), tc)
    toks = np.array([[0, 5, 511, 77]], np.int64)
    _close(tm._embed(tp, torch.from_numpy(toks)), jm._embed(jp, jnp.asarray(toks)), dtype)
    x = np.random.default_rng(4).standard_normal((3, 256)).astype(np.float32)
    jx, tx = _both(x, dtype)
    tl, jl = tm._logits(tp, tx), jm._logits(jp, jx)
    assert tl.dtype == torch.float32 and tl.shape == (3, tc.vocab_size)
    _close(tl, jl, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_jax_round_trips_every_leaf(dtype):
    jc, tc = _cfgs(dtype)
    jp = jax_build_model(jc, remat=False).init(jax.random.PRNGKey(5))
    tp = params_from_jax(_to_np(jp), tc)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jleaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == tc.torch_dtype and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32))


def test_port_init_draws_the_reference_shapes():
    """The port's own init (used on the card, where no JAX weights exist)
    makes the same tree of shapes and dtypes as the JAX package's."""
    jc, tc = _cfgs("bfloat16")
    jp = jax_build_model(jc, remat=False).init(jax.random.PRNGKey(0))
    tp = build_model(tc).init(torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert jshapes == tshapes
    emb = tp["embed"].float()
    assert abs(emb.std().item() - 0.02) < 2e-3


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch, and chip_smoke.py, import in a fresh
    interpreter without pulling in jax or the JAX package; the walk reaches
    every subpackage (core, sharding, models, cluster among them), the dry
    run among the modules, and no import starts a process group."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert len(mods) > 20 and not bad, (len(mods), bad)\n"
        "need = {'repro_torch.core.perf_model', 'repro_torch.sharding.rules',\n"
        "        'repro_torch.models.moe_ep', 'repro_torch.cluster.simulator',\n"
        "        'repro_torch.launch.dryrun', 'repro_torch.launch.hlo_analysis'}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import started a process group'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
