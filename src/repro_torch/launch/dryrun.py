"""Multi-pod dry run over DTensors: place every (architecture x input shape)
on the production meshes, run one step on shapes only, count its per-device
work and emit the roofline terms. The port of ``repro.launch.dryrun``.

Nothing is compiled and nothing is allocated on any device. Params,
optimizer state, batch and cache are ``meta`` tensors (shapes and dtypes, no
storage), placed as DTensors by the sharding rules over a ``cpu`` device
mesh of a fake process group of prod(mesh) ranks (torch's ``fake`` backend,
whose collectives move nothing); the step runs once on them as rank 0, and
``hlo_analysis.Analysis`` counts the dot FLOPs and collective bytes of the
ops that rank runs on its local shards. So the dry run takes no
``--device``: it touches no device, and a card would not change the count.
Attention runs its plain version (``backend="ref"``): a ``meta`` tensor
launches no kernel.

Constants that meet DTensors in the layers (rope frequencies, masks,
``arange``s) are taken as replicated DTensors: the step runs under
``implicit_replication()``. Where the reference lowers and compiles,
``lower_s`` times building and placing the abstract state and ``compile_s``
the counted step. Torch has no ``memory_analysis()``: ``argument_bytes`` and
``output_bytes`` are summed over the local shards; temporaries are not
measured. Nothing is set at import, and no module starts a process group
then.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out f.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.perf_model import PerfModel
from repro_torch.launch import hlo_analysis, specs as sp
from repro_torch.launch.mesh import make_production_mesh, mesh_shape_dict
from repro_torch.launch.specs import skip_reason
from repro_torch.models.config import INPUT_SHAPES, ModelConfig
from repro_torch.models.model import build_model
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import activate, standard_mapping
from repro_torch.training.optimizer import AdamWConfig, OptState
from repro_torch.training.train_loop import make_train_step

P = rules.P

#: one NVLink direction of an H100 SXM (the 450 GB/s behind ``H100_SXM.B_c``),
#: where the reference divides by one 50 GB/s ICI link
NVLINK_BW = 450e9


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of ``world`` ranks on torch's fake backend,
    this process as rank 0, destroyed on exit. A group of that size that
    already exists is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks exists; "
                               f"the dry run needs {world}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(*trees) -> int:
    """Bytes of the local shards of every tensor in ``trees`` (nested dicts,
    tuples and NamedTuples): what one rank holds."""
    n = 0
    for leaf in _leaves(trees):
        t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        n += t.numel() * t.element_size()
    return n


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def lower_case(arch: str, shape_name: str, *, multi_pod: bool = False,
               compile_: bool = True, seq_shard: str | None = "model",
               weight_mode: str | None = None, seq_attn: bool | None = None) -> dict:
    """Place one (arch, shape, mesh) case and count its step; returns the
    result dict (``hlo`` and ``roofline`` only with ``compile_``).

    weight_mode overrides the sharding baseline (fsdp_tp); serving shapes
    accept "tp_only"/"replicated". seq_attn forces/disables sequence-sharded
    attention (default: auto for head counts not dividing the model axis).
    """
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    with fake_group(2 * 16 * 16 if multi_pod else 16 * 16):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        msd = mesh_shape_dict(mesh)
        n_chips = math.prod(msd.values())
        dp = math.prod(msd[a] for a in rules.dp_axes(multi_pod))
        long_ctx = shape_name == "long_500k"
        if shape.kind == "train" and cfg.is_moe:
            # train with the classic 1.25 capacity factor (serving keeps 2.0 for
            # fewer drops); the capacity buffers are the MoE activation peak
            cfg = dataclasses.replace(cfg, moe_capacity_factor=1.25)
        model = build_model(cfg, long_context=long_ctx, moe_groups=dp, remat=True,
                            backend="ref")

        t0 = time.perf_counter()
        params_abs = sp.abstract_params(model)
        wm = weight_mode or "fsdp_tp"
        pspecs = rules.param_specs(params_abs, msd, weight_mode=wm)
        params = rules.distribute_params(params_abs, mesh, pspecs)
        batch_abs = sp.input_specs(cfg, shape)
        bspecs = rules.batch_spec(cfg, shape.kind, shape.global_batch, multi_pod, msd)
        bspecs = {k: bspecs.get(k, P(*([None] * v.ndim))) for k, v in batch_abs.items()}

        if shape.kind == "train":
            opt_abs = sp.abstract_opt_state(params_abs)
            opt = OptState(step=rules.distribute_params(opt_abs.step, mesh, P()),
                           mu=rules.distribute_params(opt_abs.mu, mesh, pspecs),
                           nu=rules.distribute_params(opt_abs.nu, mesh, pspecs))
            batch = rules.distribute_params(batch_abs, mesh, bspecs)
            # grad accumulation: saved layer carries scale with depth x
            # per-device microbatch, so deeper stacks get more splits
            micro = 16 if cfg.num_layers >= 56 else 8 if cfg.num_layers >= 32 else 4
            while micro > 1 and shape.global_batch % (micro * dp):
                micro //= 2
            step = make_train_step(model, AdamWConfig(), microbatches=micro)
            args = (params, opt, batch)
        elif shape.kind == "prefill":
            def step(params, batch):
                return model.prefill(params, batch, cache_len=shape.seq_len)
            args = (params, rules.distribute_params(batch_abs, mesh, bspecs))
        else:  # decode
            cache_abs = sp.abstract_cache(model, shape)
            cspecs = rules.cache_specs(cfg, cache_abs, shape.global_batch,
                                       multi_pod, msd, seq_shard=seq_shard)
            b = rules.batch_axis(shape.global_batch, multi_pod, msd)

            def step(params, tokens, cache):
                return model.decode_step(params, tokens, cache)
            args = (params, rules.distribute_params(batch_abs["tokens"], mesh, P(b)),
                    rules.distribute_params(cache_abs, mesh, cspecs))

        b_axes = rules.batch_axis(shape.global_batch, multi_pod, msd)
        mapping = standard_mapping(b_axes)
        if seq_attn is None:
            # auto, as the reference: serving shapes with head counts not
            # dividing the TP axis; not MoE, SSM or audio
            seq_attn = (shape.kind != "train"
                        and cfg.num_heads % msd["model"] != 0
                        and not cfg.is_moe
                        and cfg.family not in ("ssm", "audio"))
        if seq_attn:
            mapping["attn_q_seq"] = P(b_axes, "model", None, None)
            mapping["attn_kv_rep"] = P(b_axes, None, None, None)
            mapping["attn_q_dec"] = P(b_axes, None, None)
        result = {
            "arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "chips": n_chips, "lower_s": round(time.perf_counter() - t0, 1),
        }
        if not compile_:
            return result
        t1 = time.perf_counter()
        with activate(mapping), implicit_replication(), hlo_analysis.Analysis() as counter:
            out = step(*args)
        result["compile_s"] = round(time.perf_counter() - t1, 1)
        result["memory"] = {
            "argument_bytes": local_bytes(args),
            "output_bytes": local_bytes(out),
            # torch keeps no record of a step's temporaries on meta tensors
            "temp_bytes": None,
            "generated_code_bytes": None,
        }
    hlo = counter.result(shape.kind)
    result["hlo"] = hlo
    result["roofline"] = roofline_terms(cfg, shape, hlo, n_chips, multi_pod)
    return result


def roofline_terms(cfg: ModelConfig, shape, hlo: dict, n_chips: int,
                   multi_pod: bool) -> dict:
    """Three roofline terms (seconds) from the counted step and the
    analytic perf-model cross-check, on an H100 SXM's data-sheet peaks.
    ``collective_s`` divides by one NVLink direction: a figure for cards in
    one node, while a 256-card mesh spans 32 nodes and their slower links."""
    hw = H100_SXM
    pm = PerfModel(cfg, hw, tp=1)
    # analytic per-cluster totals from the paper's own operator model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        est = pm.prefill_estimate([shape.seq_len] * shape.global_batch)
        analytic_flops = 3.0 * est.flops        # fwd + bwd (2x fwd)
        analytic_bytes = 3.0 * est.bytes
        model_flops = 6.0 * cfg.num_active_params() * tokens
    elif shape.kind == "prefill":
        est = pm.prefill_estimate([shape.seq_len] * shape.global_batch)
        analytic_flops, analytic_bytes = est.flops, est.bytes
        model_flops = 2.0 * cfg.num_active_params() * shape.global_batch * shape.seq_len
    else:
        est = pm.decode_estimate([shape.seq_len] * shape.global_batch)
        analytic_flops, analytic_bytes = est.flops, est.bytes
        model_flops = 2.0 * cfg.num_active_params() * shape.global_batch
    dot_flops_dev = hlo["dot_flops_per_device"]
    coll_bytes_dev = hlo["collective_bytes_per_device"]
    compute_t = dot_flops_dev / hw.peak_flops
    memory_t = (analytic_bytes / n_chips) / hw.peak_hbm_bw
    collective_t = coll_bytes_dev / NVLINK_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": collective_t}
    dom = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "hlo_flops_per_device": dot_flops_dev,
        "hlo_flops_cluster": dot_flops_dev * n_chips,
        "analytic_flops_cluster": analytic_flops,
        "analytic_bytes_cluster": analytic_bytes,
        "model_flops": model_flops,
        "useful_fraction": (model_flops / (dot_flops_dev * n_chips)
                            if dot_flops_dev else None),
        "collective_breakdown": hlo["collective_breakdown"],
    }


def serving_weight_mode(cfg: ModelConfig) -> str:
    """Serving layout of the reference's perf iterations: replicate small
    models, TP-only mid-size, keep FSDP for MoE (expert tensors dominate)
    and for models whose TP-16 shard exceeds ~8 GB a device."""
    if cfg.is_moe:
        return "fsdp_tp"
    bytes_tp16 = 2 * cfg.num_params() / 16
    if 2 * cfg.num_params() < 6e9:
        return "replicated"
    if bytes_tp16 < 8e9:
        return "tp_only"
    return "fsdp_tp"


def run_all(multi_pod: bool, out_path: str | None, archs=None, shapes=None,
            optimized: bool = False):
    results = []
    mesh = "2x16x16" if multi_pod else "16x16"
    for arch in (archs or ASSIGNED):
        for shape_name in (shapes or list(INPUT_SHAPES)):
            reason = skip_reason(arch, shape_name)
            tag = f"{arch} x {shape_name} [{mesh}]"
            if reason:
                print(f"SKIP {tag}: {reason}", flush=True)
                results.append({"arch": arch, "shape": shape_name, "mesh": mesh,
                                "skipped": reason})
                continue
            kw = {}
            if optimized and INPUT_SHAPES[shape_name].kind != "train":
                kw["weight_mode"] = serving_weight_mode(get_config(arch))
            if not optimized:
                kw["seq_attn"] = False  # paper-faithful baseline sharding
            try:
                res = lower_case(arch, shape_name, multi_pod=multi_pod, **kw)
                rf = res["roofline"]
                ratio = rf["hlo_flops_cluster"] / max(rf["analytic_flops_cluster"], 1)
                print(f"OK   {tag}: count {res['compile_s']}s  "
                      f"args/dev {res['memory']['argument_bytes'] / 1e9:.2f} GB  "
                      f"flops/analytic {ratio:.3f}  dominant={rf['dominant']}", flush=True)
                results.append(res)
            except Exception as e:  # a failure here is a sharding bug
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape_name, "mesh": mesh,
                                "error": f"{type(e).__name__}: {e}"})
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {out_path}")
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results)} cases: {n_fail} failures")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--weight-mode", default=None,
                    choices=["fsdp_tp", "tp_only", "replicated"])
    ap.add_argument("--optimized", action="store_true",
                    help="beyond-paper sharding (seq-attn auto + serving "
                         "weight layouts); default is the recorded baseline")
    args = ap.parse_args()
    if args.all:
        run_all(args.multi_pod, args.out,
                archs=[args.arch] if args.arch else None,
                shapes=[args.shape] if args.shape else None,
                optimized=args.optimized)
        return
    assert args.arch and args.shape, "--arch and --shape (or --all)"
    res = lower_case(args.arch, args.shape, multi_pod=args.multi_pod,
                     weight_mode=args.weight_mode)
    print(res["memory"])
    print({k: v for k, v in res["hlo"].items() if k != "collective_breakdown"})
    print(json.dumps(res["roofline"], indent=1, default=float))


if __name__ == "__main__":
    main()
