"""The traced slice's profile, summarised in the process: the device's busy
time (the union of every device operation's interval), its operations by
name, the kernels' device time, and the device's idle time by the host span
the benchmark was in. No trace file is written."""
from __future__ import annotations

import time
from collections import defaultdict

from ooco_bench.harness import SPAN

#: kernel name fragments of the port's two CUDA kernels
KERNELS = {"paged": ("paged_decode_split_kernel", "paged_decode_merge_kernel"),
           "flash": ("flash_prefill_kernel",)}


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labelled_segments(ann: list, lo: float, hi: float) -> list:
    """[lo, hi) cut where any host span starts or ends, each piece labelled
    with the innermost span covering it (the covering span that started
    last), or "no span"."""
    cuts = sorted({lo, hi, *(max(lo, min(hi, x)) for a in ann for x in a[:2])})
    segs = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        cover = [x for x in ann if x[0] <= mid < x[1]]
        segs.append((a, b, max(cover, key=lambda x: (x[0], -x[1]))[2] if cover else "no span"))
    return segs


def summarize(prof, window_s: float) -> dict:
    """Read a stopped ``torch.profiler.profile``. Times in its events are
    microseconds."""
    t0 = time.perf_counter()
    dev, ann = [], []
    ops = defaultdict(float)
    for e in prof.events():
        on_dev = "CUDA" in str(e.device_type)
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN):
            if not on_dev:
                ann.append((s, t, e.name[len(SPAN):]))
            continue
        if on_dev:
            dev.append((s, t))
            ops[e.name] += (t - s) * 1e-6
    parse_s = time.perf_counter() - t0
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    kernel_s = {k: sum(v for name, v in ops.items() if any(f in name for f in frags))
                for k, frags in KERNELS.items()}
    idle = defaultdict(float)
    if ann:
        lo = min(a[0] for a in ann)
        hi = max([a[1] for a in ann] + [e for _, e in busy])
        gaps, cur = [], lo
        for s, e in busy:
            if s > cur:
                gaps.append((cur, min(s, hi)))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
        segs = _labelled_segments(ann, lo, hi)
        j = 0
        for gs, ge in gaps:
            while j < len(segs) and segs[j][1] <= gs:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < ge:
                a, b, name = segs[k]
                idle[name] += (min(b, ge) - max(a, gs)) * 1e-6
                k += 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernel_s": kernel_s,
        "device_ops": [[name[:120], s] for name, s in top],
        "idle_gaps": [[name, s] for name, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        "device_events": len(dev),
        "host_spans": len(ann),
        "parse_s": parse_s,
    }
