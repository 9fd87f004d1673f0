#!/usr/bin/env python3
"""A/B timing of the port's two attention kernels on one NVIDIA GPU: this
checkout's versions against another tree's (for example a parent commit),
each timed by three methods, alternating, in one process.

    mkdir -p build/other && git archive <commit> | tar -x -C build/other
    python3 tools/kernel_ab.py --other build/other [--rounds 5] \
        [--out chiprun_out/kernel_ab.json]

The other tree's wrappers (``src/repro_torch/kernels/*/ops.py``) are loaded
from its files under private module names, and its ``csrc/*.cu`` are built
with this checkout's nvcc flags into ``build/kernels/<name>-other-<hash>.so``,
so each version runs through its own wrapper and C interface.

Every timed call follows a 64 MB L2 flush. The methods:

- ``events``: CUDA events around each call, after a 64 MB write (the method
  ``chip_smoke.py`` used before its ``time_ms`` changed); host enqueue gaps
  and the write-back of the flush's dirty lines can land inside the window.
- ``queued``: ``chip_smoke.time_ms`` (runs queued behind a device sleep, a
  64 MB read flush, the per-call difference of runs with and without the
  call), which also charges each call its launch.
- ``profiler``: the device time of the call's own kernels per call, as
  torch.profiler records it (the flush's kernels excluded), which is what
  ``chip_smoke.py``'s engine profile reads.

Shapes, qwen2.5-7b heads (28 query, 4 KV, hd 128), bf16: paged decode at
bucket 8 with every row at context 512 (tables of 32 pages) and at 544
(64 pages: a 512-token prompt after 32 decode steps); flash prefill at B=1,
S=512 and S=2048. SDPA, the library yardstick (on a pre-gathered cache for
decode), is timed by every method in every round as well. Each version's
output is held against the plain version before it is timed. Order within
a round: other, this, library, this, other, for each shape, for each
method; the methods' order rotates between rounds, so each round gives two
(other, this) pairs per shape and method. Reported: the median of each
(shape, version, method) over all its samples, the ratios, how many pairs
this version won, and the spread of the other version's own samples (the
distance between their quartiles).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

KERNELS = ("paged_attention", "flash_prefill")


class OtherBuild:
    """Stands in for ``repro_torch.kernels.build`` in the other tree's
    wrappers: builds and loads that tree's sources."""

    def __init__(self, tree: Path):
        from repro_torch.kernels import build
        self.build = build
        self.csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
        self.libs: dict[str, ctypes.CDLL] = {}

    def path(self, name: str) -> Path:
        digest = hashlib.sha256((self.csrc / f"{name}.cu").read_bytes())
        digest.update(" ".join(self.build.NVCC_FLAGS).encode())
        return self.build.BUILD_DIR / f"{name}-other-{digest.hexdigest()[:16]}.so"

    def build_all(self) -> None:
        self.build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {n: subprocess.Popen(
            [self.build.nvcc_path(), *self.build.NVCC_FLAGS, "-o", str(self.path(n)),
             str(self.csrc / f"{n}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for n in KERNELS if not self.path(n).exists()}
        for n, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for the other tree's {n}.cu:\n{out}")
            print_ptxas(f"other {n}", out)

    def load(self, name: str) -> ctypes.CDLL:
        if name not in self.libs:
            self.libs[name] = ctypes.CDLL(str(self.path(name)))
        return self.libs[name]


def print_ptxas(name: str, report: str) -> None:
    """The lines of an ``-Xptxas -v`` report on registers, spills and shared
    memory, and ptxas's performance warnings."""
    for line in report.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "Performance")):
            print(f"  {name}: {line.strip()}")


def load_other(tree: Path) -> dict:
    """The other tree's wrapper modules, keyed by kernel."""
    ob = OtherBuild(tree)
    ob.build_all()
    mods = {}
    for name in KERNELS:
        path = tree / "src" / "repro_torch" / "kernels" / name / "ops.py"
        spec = importlib.util.spec_from_file_location(f"_other_{name}_ops", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.build = ob
        mods[name] = mod
    return mods


# ---------------------------------------------------------------------------
# timing methods
# ---------------------------------------------------------------------------

def time_events(fn, iters: int, flush) -> float:
    """Mean ms between CUDA events around each call, after a 64 MB write."""
    import torch
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def _device_ms(prof) -> dict[str, float]:
    return {e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / 1e3
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)}


def make_time_profiler(flush):
    """Device ms per call of the call's own kernels under torch.profiler;
    the kernels of the flush (a 64 MB read) are found first and left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(3):
            flush.sum()
        torch.cuda.synchronize()
    flush_keys = {k for k, ms in _device_ms(prof).items() if ms > 0}

    def time_profiler(fn, iters: int, _flush) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(iters):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        ms = _device_ms(prof)
        return sum(v for k, v in ms.items() if k not in flush_keys) / iters

    return time_profiler, flush_keys


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def paged_shape(ctx: int, P: int, ops: dict, ref):
    """Calls of each version and of SDPA at bucket 8, every row at ``ctx``."""
    import torch.nn.functional as F
    B, Hq, Hkv, hd = 8, 28, 4, 128
    q, kp, vp, tables, lens = cs.paged_case(B, [ctx] * B, P=P)
    want = ref.paged_attention_ref(q.reshape(B, Hkv, Hq // Hkv, hd), kp, vp, tables,
                                   lens).reshape(q.shape)
    calls = {}
    for who, mod in ops.items():
        def call(mod=mod):
            return mod.paged_attention(q, kp, vp, tables, lens, num_kv_heads=Hkv)
        cs.compare(f"[{who}] paged decode B={B} ctx={ctx} P={P}", call(), want)
        calls[who] = call
    kc = kp[tables.long()].reshape(B, -1, Hkv, hd)[:, :ctx].transpose(1, 2).contiguous()
    vc = vp[tables.long()].reshape(B, -1, Hkv, hd)[:, :ctx].transpose(1, 2).contiguous()
    qs = q[:, :, None]
    calls["library"] = lambda: F.scaled_dot_product_attention(qs, kc, vc, enable_gqa=True)
    return calls


def flash_shape(S: int, ops: dict, ref):
    """Calls of each version and of SDPA causal GQA at B=1, prompt ``S``."""
    import torch
    import torch.nn.functional as F
    q, k, v = cs.flash_case(1, S, S)
    lens = torch.tensor([S], dtype=torch.int32, device=cs.DEVICE)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    want = ref.flash_prefill_ref(qt, kt, vt, kv_len=S, kv_lens=lens).transpose(1, 2)
    calls = {}
    for who, mod in ops.items():
        def call(mod=mod):
            return mod.flash_attention(q, k, v, kv_lens=lens)
        cs.compare(f"[{who}] flash prefill S={S}", call(), want)
        calls[who] = call
    calls["library"] = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other tree (holds src/repro_torch)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "kernel_ab.json")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import ops as fp_ops, ref as fp_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref

    card = cs.card_line()
    print(f"card: {card}")
    for name, report in build.build().items():
        print_ptxas(f"this {name}", report)
    other = load_other(args.other.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = {
        "paged B=8 ctx=512 P=32": (paged_shape(512, 32, {
            "other": other["paged_attention"], "this": pa_ops}, pa_ref), 200),
        "paged B=8 ctx=544 P=64": (paged_shape(544, 64, {
            "other": other["paged_attention"], "this": pa_ops}, pa_ref), 200),
        "flash B=1 S=512": (flash_shape(512, {
            "other": other["flash_prefill"], "this": fp_ops}, fp_ref), 20),
        "flash B=1 S=2048": (flash_shape(2048, {
            "other": other["flash_prefill"], "this": fp_ops}, fp_ref), 20),
    }
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=cs.DEVICE)
    time_profiler, flush_keys = make_time_profiler(flush)
    print(f"flush kernels left out of the profiler times: {sorted(flush_keys)}")
    methods = {"events": time_events, "queued": cs.time_ms, "profiler": time_profiler}
    samples: dict = {}
    order = list(methods)
    for r in range(args.rounds):
        for m in order[r % len(order):] + order[:r % len(order)]:
            for shape, (calls, iters) in shapes.items():
                for who in ("other", "this", "library", "this", "other"):
                    t = methods[m](calls[who], iters, flush)
                    samples.setdefault((shape, m, who), []).append(t)

    rows = []
    print(f"\nmedian ms per call ({args.rounds} rounds; {card})")
    print(f"{'shape':24} {'method':9} {'other':>9} {'this':>9} {'library':>9} "
          f"{'this/other':>10} {'other/lib':>9} {'this/lib':>9} {'wins':>6} {'IQR other':>9}")
    for shape in shapes:
        for m in methods:
            med = {w: statistics.median(samples[(shape, m, w)])
                   for w in ("other", "this", "library")}
            pairs = list(zip(samples[(shape, m, "other")], samples[(shape, m, "this")]))
            wins = sum(t < o for o, t in pairs)
            q = statistics.quantiles(samples[(shape, m, "other")], n=4)
            row = {"shape": shape, "method": m, **{f"{w}_ms": v for w, v in med.items()},
                   "this_over_other": med["this"] / med["other"],
                   "other_over_library": med["other"] / med["library"],
                   "this_over_library": med["this"] / med["library"],
                   "this_wins": wins, "pairs": len(pairs), "other_iqr_ms": q[2] - q[0],
                   "samples": {w: samples[(shape, m, w)] for w in ("other", "this",
                                                                    "library")}}
            rows.append(row)
            print(f"{shape:24} {m:9} {med['other']:9.4f} {med['this']:9.4f} "
                  f"{med['library']:9.4f} {row['this_over_other']:10.3f} "
                  f"{row['other_over_library']:9.3f} {row['this_over_library']:9.3f} "
                  f"{wins:>3}/{len(pairs):<2} {q[2] - q[0]:9.4f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "other": str(args.other),
                                    "rounds": args.rounds, "rows": rows}, indent=1))
    print(f"wrote {args.out}")
    print(json.dumps([{k: v for k, v in r.items() if k != "samples"} for r in rows]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
