#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and builds both CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with nvcc, in parallel.
2. Kernel check: each kernel against its plain PyTorch version on the card,
   in bf16, at the main path's shapes (paged decode at B in {1, 8}: the
   main path's split plans at 32 and 64 pages, ragged lengths 1..2048, a
   trash-page row and lengths on the split planner's chunk boundaries;
   flash prefill at S in {8, 128, 512, 2048} with per-row kv_lens, a chunk
   at q_offset > 0, a sliding window, a softcap, rows that see no key and
   hd 64; and on chunk shapes: Sq in {16, 256, 512} over one request's K/V
   gathered from a paged pool through its table, q_offset in {96, 200,
   320}), each max abs error beside its tolerance, and each wrapper call's
   host syncs (must be 0). Then timings on CUDA events (``time_ms``):
   kernel, plain version, the least time the card could take (bound) and
   one PyTorch library call computing the same function (which the port
   never calls).
3. Phase 1: full-width qwen2.5-7b (28 layers, bf16, seeded random weights)
   served by the port's PoolRuntime in CoLocatedServer's configuration
   (ooco, 1 strict + 1 relaxed engine, decode bucket 8, whole-prompt
   prefill, one decode step per dispatch) on a few online and offline
   requests. Every request must finish, both kernels must have launched,
   and one prompt's logits through the kernels must agree with the plain
   path.
4. Engine checks at full width: a 300-token prompt in chunks of 96 against
   whole-prompt prefill and against the plain versions; a mixed step's 7
   decode rows against ``decode_step`` from the same state; K=4 decode and
   mixed horizons against 4 serial steps (tokens equal but for near-ties of
   the serial logits, counted); a warm 256-token prefix against a cold one;
   one host sync per mixed step and per horizon.
5. Phase 2: the reference's default configuration (chunked prefill and
   decode horizons ``auto``, prefix cache on) over the same weights, on the
   same online trace plus an offline backlog with shared prefixes. Every
   request must finish, with mixed steps, prefix hits, and both kernels
   launched (flash at q_offset > 0 too). Then one mixed step and one K=4
   horizon profiled.
6. Prints the kernel table as one JSON line (flash prefill at S=512, at
   S=2048 and on the chunk shape, each row with its ratio to the library
   call and its launches by path), the card line again, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Without a CUDA device the
script exits 1 at once. It imports nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12   # H100 SXM data sheet, dense bf16
PEAK_HBM_BYTES = 3.35e12   # H100 SXM data sheet
# Kernel vs plain version: |out - ref| <= ATOL + RTOL * |ref|. Both sides
# compute in f32 from the same bf16 inputs and round the output to bf16, so
# they may differ by one bf16 ulp (2^-7 of |ref| at most); ATOL covers the
# summation order and, in flash prefill, P rounded to bf16 before P @ V
# (2^-9 relative on weights that sum to 1, over |V| of a few units).
ATOL, RTOL = 1e-2, 2.0 ** -7
LOGITS_REL_TOL = 5e-2  # kernels vs plain versions through 28 bf16 layers
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def compare(name: str, out, want) -> float:
    """Max abs error of a kernel's output against its plain version; fails
    past ATOL + RTOL * |ref|."""
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= ATOL + RTOL * want.float().abs()).all())
    print(f"{name}: max_abs_err={err:.3e} (tol {ATOL} + {RTOL:.4f} |ref|) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def count_syncs(fn) -> list[str]:
    """Where ``fn`` synchronizes host and device (file:line of each call),
    from PyTorch's sync debug mode: one "called a synchronizing CUDA
    operation" warning per synchronizing call (its first use also warns
    once that the mode is a prototype, which is not a sync)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, flush) -> float:
    """Device ms that one call of ``fn`` adds to the stream, with the L2 cache
    flushed before each call as the main path finds it cold: between two
    attention calls the engine streams a layer's weights, so the flush reads
    64 MB (a read leaves clean lines, as a weight stream does; a write would
    leave 50 MB of dirty lines for the call to write back). Each run of
    ``iters`` flushes is queued behind a device-side sleep (outside the timed
    window), so the host's time to enqueue a call never shows as a gap. Runs
    with ``fn`` after every flush alternate with runs of the flushes alone,
    twice each; the difference per call is the time ``fn`` adds to the
    stream, its launch included."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run(with_fn: bool) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)   # ~0.1 s at the card's clock: room to enqueue
        start.record()
        for _ in range(iters):
            flush.sum()
            if with_fn:
                fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    runs = [run(True), run(False), run(True), run(False)]
    return (runs[0] + runs[2] - runs[1] - runs[3]) / (2 * iters)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def paged_case(B, lengths, *, Hq=28, Hkv=4, hd=128, page=16, trash_row=None,
               P=None, seed=0):
    """A paged pool and (B, P) tables for ``lengths`` (P by default the
    fewest pages that hold the longest row; the engine pads it to a power of
    two): each row's pages are drawn without replacement from pages >= 1,
    and table entries past the length are garbage page ids. ``trash_row``
    mimics a padded batch row: table row all zeros (the trash page) and
    length 1."""
    import torch
    g = torch.Generator(DEVICE).manual_seed(seed)
    P = P or -(-max(lengths) // page)
    num_pages = B * P + 1
    q = torch.randn(B, Hq, hd, generator=g, device=DEVICE).bfloat16()
    kp = torch.randn(num_pages, page, Hkv, hd, generator=g, device=DEVICE).bfloat16()
    vp = torch.randn(num_pages, page, Hkv, hd, generator=g, device=DEVICE).bfloat16()
    perm = torch.randperm(num_pages - 1, generator=g, device=DEVICE) + 1
    tables = perm[: B * P].reshape(B, P).int()
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    if trash_row is not None:
        tables[trash_row] = 0
        lens[trash_row] = 1
    return q, kp, vp, tables.contiguous(), lens


def check_paged(ops, ref, softcap_cases=(0.0, 50.0)) -> float:
    """The main path's plans first: bucket 8 with tables padded to 32 and to
    64 pages (contexts up to 512 and up to 1024; 8 splits of 64 and of 128
    tokens), ragged, with a padded row. Then ragged lengths 1..2048; lengths
    at the planner's chunk boundaries (one below, at, one above), shorter
    than one chunk, and 2048, so that empty chunks, chunks cut by the length
    and the merge all run; and short contexts (two pages), where the planner
    takes one chunk, as for the main path's short prompts."""
    import torch
    worst = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, splits = ops.plan_splits(8, 4, 2048 // 16, 16, sms)
    print(f"paged decode plan at B=8, 128 pages of 16: chunk {chunk} tokens, "
          f"{splits} splits, {8 * 4 * splits} blocks on {sms} SMs")
    boundary = [chunk - 1, chunk, chunk + 1, 2 * chunk, 5, 2048, 1, 3 * chunk + 1]
    cases = [(8, [512, 300, 497, 1, 64, 65, 511, 129], 3, 32),
             (8, [540, 512, 129, 1, 128, 1000, 257, 33], 3, 64),
             (1, [2048], None, None), (8, [1, 17, 100, 512, 1000, 2048, 5, 777], 6, None),
             (8, boundary, 6, None), (8, [5, 30, 17, 32, 1, 9, 31, 2], 6, None)]
    for B, lengths, trash, P in cases:
        q, kp, vp, tables, lens = paged_case(B, lengths, trash_row=trash, P=P)
        print(f"paged decode plan at B={B}, {tables.shape[1]} pages: "
              f"{ops.plan_splits(B, 4, tables.shape[1], 16, sms)} (chunk, splits)")
        for cap in softcap_cases:
            out = ops.paged_attention(q, kp, vp, tables, lens, num_kv_heads=4,
                                      logit_softcap=cap)
            want = ref.paged_attention_ref(q.reshape(B, 4, 7, 128), kp, vp, tables,
                                           lens, logit_softcap=cap).reshape(q.shape)
            err = compare(f"paged decode B={B} P={tables.shape[1]} lengths={lengths} "
                          f"softcap={cap}", out, want)
            worst = max(worst, err)
    syncs = count_syncs(lambda: ops.paged_attention(q, kp, vp, tables, lens,
                                                    num_kv_heads=4))
    print(f"host syncs per paged decode call: {len(syncs)} {syncs}")
    check(not syncs, f"the paged decode wrapper synchronized: {syncs}")
    return worst


def flash_case(B, Sq, Skv, *, Hq=28, Hkv=4, hd=128, seed=1):
    import torch
    g = torch.Generator(DEVICE).manual_seed(seed)
    q = torch.randn(B, Sq, Hq, hd, generator=g, device=DEVICE).bfloat16()
    k = torch.randn(B, Skv, Hkv, hd, generator=g, device=DEVICE).bfloat16()
    v = torch.randn(B, Skv, Hkv, hd, generator=g, device=DEVICE).bfloat16()
    return q, k, v


def check_flash(ops, ref) -> tuple[float, float]:
    """Max abs errors of the whole-prompt cases and of the chunk cases."""
    import torch
    worst = 0.0
    # (B, Sq, Skv, q_offset, kv_lens, window, softcap, Hq, Hkv, hd): whole
    # prompts with ragged rows, from the smallest prompt bucket up; a chunk at
    # q_offset > 0 over a longer key range; a sliding window (gemma2's local
    # layers) and a softcap (gemma2's attention), alone and together on a
    # chunk whose Sq is no multiple of the query tile; the two together on a
    # ragged row whose last queries see no key (past kv_lens + window: the
    # plain version gives them the mean of V); and hd 64 with G = 2
    qwen = (28, 4, 128)
    cases = [(1, 8, 8, 0, [8], 0, 0.0, *qwen)]
    cases += [(2, S, S, 0, [S, S // 2 + 3], 0, 0.0, *qwen) for S in (128, 512, 2048)]
    cases += [(1, 128, 512, 384, [512], 0, 0.0, *qwen),
              (1, 512, 512, 0, [512], 100, 0.0, *qwen),
              (2, 512, 512, 0, [512, 300], 0, 50.0, *qwen),
              (1, 200, 600, 400, [600], 256, 30.0, *qwen),
              (2, 200, 264, 64, [264, 130], 96, 30.0, *qwen),
              (2, 300, 300, 0, [300, 77], 0, 0.0, 8, 4, 64)]
    for B, Sq, Skv, off, kv, window, cap, Hq, Hkv, hd in cases:
        q, k, v = flash_case(B, Sq, Skv, Hq=Hq, Hkv=Hkv, hd=hd)
        lens = torch.tensor(kv, dtype=torch.int32, device=DEVICE)
        out = ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off, window=window,
                                  logit_softcap=cap)
        want = ref.flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), kv_len=Skv, q_offset=off,
                                     kv_lens=lens, window=window,
                                     logit_softcap=cap).transpose(1, 2)
        err = compare(f"flash prefill B={B} Sq={Sq} Skv={Skv} q_offset={off} "
                      f"kv_lens={kv} window={window} softcap={cap} heads={Hq}/{Hkv} "
                      f"hd={hd}", out, want)
        worst = max(worst, err)
    syncs = count_syncs(lambda: ops.flash_attention(q, k, v, kv_lens=lens))
    print(f"host syncs per flash prefill call: {len(syncs)} {syncs}")
    check(not syncs, f"the flash prefill wrapper synchronized: {syncs}")
    # the chunk side of a mixed step: C query rows (c real) at q_offset over
    # a request's pages gathered from a paged pool through its table, which
    # is padded with the trash page 0 to cp pages; kv_lens = q_offset + c.
    # No q_offset is a multiple of the 64-row query tile.
    whole, worst = worst, 0.0
    for Sq, c, cp, off in CHUNK_CASES:
        q, k, v, lens = chunk_case(Sq, c, cp, off)
        out = ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off)
        want = ref.flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), kv_len=k.shape[1],
                                     q_offset=off, kv_lens=lens).transpose(1, 2)
        err = compare(f"flash prefill chunk Sq={Sq} c={c} Skv={cp * 16} (cp={cp}) "
                      f"q_offset={off} kv_lens={off + c}", out, want)
        worst = max(worst, err)
    return whole, worst


#: chunk-side shapes (Sq bucket, real rows c, pages cp of 16, q_offset)
CHUNK_CASES = [(16, 13, 8, 96), (16, 9, 32, 200), (16, 15, 64, 320),
               (256, 30, 8, 96), (256, 192, 32, 320), (256, 130, 64, 200),
               (512, 190, 32, 320), (512, 300, 64, 200), (512, 500, 64, 320)]


def chunk_case(Sq, c, cp, off, *, Hq=28, Hkv=4, hd=128, page=16, seed=2):
    """q (1, Sq, Hq, hd) and the K/V of one request gathered from a random
    paged pool: the pages that hold ``off + c`` tokens, drawn without
    replacement from pages >= 1, then the trash page 0 up to ``cp`` pages,
    as the engine's ``PagedKVCache.gather_pages`` lays them out."""
    import torch
    g = torch.Generator(DEVICE).manual_seed(seed)
    num_pages = 2 * cp + 1
    kp = torch.randn(num_pages, page, Hkv, hd, generator=g, device=DEVICE).bfloat16()
    vp = torch.randn(num_pages, page, Hkv, hd, generator=g, device=DEVICE).bfloat16()
    used = -(-(off + c) // page)
    table = torch.zeros(cp, dtype=torch.long, device=DEVICE)
    table[:used] = torch.randperm(num_pages - 1, generator=g, device=DEVICE)[:used] + 1
    q = torch.randn(1, Sq, Hq, hd, generator=g, device=DEVICE).bfloat16()
    k = kp[table].reshape(1, cp * page, Hkv, hd)
    v = vp[table].reshape(1, cp * page, Hkv, hd)
    lens = torch.tensor([off + c], dtype=torch.int32, device=DEVICE)
    return q, k, v, lens


def time_paged(ops, ref, flush, B=8, ctx=512) -> dict:
    """The runtime's decode shape: bucket 8, context 512, qwen2.5-7b heads.
    The timed call's output is held against the plain version first."""
    import torch
    import torch.nn.functional as F
    q, kp, vp, tables, lens = paged_case(B, [ctx] * B)
    Hq, hd, Hkv = 28, 128, 4
    compare(f"paged decode B={B} ctx={ctx} (timed inputs)",
            ops.paged_attention(q, kp, vp, tables, lens, num_kv_heads=Hkv),
            ref.paged_attention_ref(q.reshape(B, Hkv, Hq // Hkv, hd), kp, vp, tables,
                                    lens).reshape(q.shape))
    t_kernel = time_ms(lambda: ops.paged_attention(q, kp, vp, tables, lens,
                                                   num_kv_heads=Hkv), 200, flush)
    t_plain = time_ms(lambda: ref.paged_attention_ref(
        q.reshape(B, Hkv, Hq // Hkv, hd), kp, vp, tables, lens), 20, flush)
    # library yardstick: SDPA over a pre-gathered contiguous cache (the
    # gather is excluded from its time)
    kc = kp[tables.long()].reshape(B, -1, Hkv, hd)[:, :ctx].transpose(1, 2).contiguous()
    vc = vp[tables.long()].reshape(B, -1, Hkv, hd)[:, :ctx].transpose(1, 2).contiguous()
    qs = q[:, :, None]
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(qs, kc, vc, enable_gqa=True),
                    200, flush)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, splits = ops.plan_splits(B, Hkv, tables.shape[1], kp.shape[1], sms)
    lengths = lens.long()
    nbytes = (2 * int(lengths.sum()) * Hkv * hd * 2      # K and V rows read once
              + 2 * B * Hq * hd * 2                      # q in, out
              + tables.numel() * 4 + B * 4)
    flops = 4 * int(lengths.sum()) * Hq * hd             # QK^T and PV
    b_ms, b_by = bound(nbytes, flops)
    print(f"paged decode B={B} ctx={ctx}: kernel {t_kernel:.4f} ms, plain "
          f"{t_plain:.4f} ms, SDPA on a pre-gathered cache {t_lib:.4f} ms "
          f"(gather excluded), bound {b_ms:.4f} ms ({b_by}); grid {B}x{Hkv}x{splits} = "
          f"{B * Hkv * splits} blocks of {chunk} tokens on {sms} SMs")
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t_lib}


def time_flash(ops, ref, flush, S) -> dict:
    """Whole-prompt prefill: B=1, prompt bucket S, qwen2.5-7b heads."""
    import torch
    import torch.nn.functional as F
    Hq, Hkv, hd = 28, 4, 128
    q, k, v = flash_case(1, S, S)
    lens = torch.tensor([S], dtype=torch.int32, device=DEVICE)
    t_kernel = time_ms(lambda: ops.flash_attention(q, k, v, kv_lens=lens), 20, flush)
    t_plain = time_ms(lambda: ref.flash_prefill_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_len=S,
        kv_lens=lens), 5, flush)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    nbytes = 2 * (2 * S * Hq * hd + 2 * S * Hkv * hd)    # q, out, K, V
    flops = 4 * (S * (S + 1) // 2) * Hq * hd             # causal pairs
    b_ms, b_by = bound(nbytes, flops)
    print(f"flash prefill S={S}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
          f"SDPA {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t_lib}


def time_flash_chunk(ops, ref, flush, Sq=256, c=192, cp=32, off=320) -> dict:
    """The chunk side of a mixed step: the second chunk of a 512-token prompt
    (C=256 with c=192 real rows at q_offset 320 over 512 gathered keys,
    kv_len 512). The library call is SDPA with a boolean mask over the same
    gathered K/V."""
    import torch
    import torch.nn.functional as F
    Hq, Hkv, hd = 28, 4, 128
    q, k, v, lens = chunk_case(Sq, c, cp, off)
    Skv, kv_len = k.shape[1], off + c
    compare(f"flash prefill chunk Sq={Sq} c={c} q_offset={off} Skv={Skv} (timed inputs)",
            ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off),
            ref.flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  kv_len=Skv, q_offset=off, kv_lens=lens).transpose(1, 2))
    t_kernel = time_ms(lambda: ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off),
                       20, flush)
    t_plain = time_ms(lambda: ref.flash_prefill_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_len=Skv,
        q_offset=off, kv_lens=lens), 5, flush)
    qi = torch.arange(Sq, device=DEVICE)[:, None]
    kj = torch.arange(Skv, device=DEVICE)[None]
    mask = (kj <= off + qi) & (kj < kv_len)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 20, flush)
    nbytes = 2 * (2 * Sq * Hq * hd + 2 * Skv * Hkv * hd) + 4   # q, out, K, V, kv_lens
    flops = 4 * int(mask.sum()) * Hq * hd                 # the pairs the mask keeps
    b_ms, b_by = bound(nbytes, flops)
    print(f"flash prefill chunk Sq={Sq} c={c} q_offset={off} Skv={Skv}: kernel "
          f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, SDPA with a boolean mask "
          f"{t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"ms": t_kernel, "plain_ms": t_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": t_lib}


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def logits_agree(model, params, cfg) -> None:
    """One prompt at full width through a kernel engine and a plain-version
    engine (``backend="ref"``, asked for by name) over the same weights:
    the next-token logits of a decode step on the same input token agree."""
    import torch
    from repro_torch.core.request import Kind, Request
    from repro_torch.engine.engine import ServingEngine

    prompt = torch.randint(0, cfg.vocab_size, (300,),
                           generator=torch.Generator().manual_seed(7)).tolist()
    logits, tok = [], None
    for backend in ("auto", "ref"):
        eng = ServingEngine(model, params, num_pages=64, decode_buckets=(8,),
                            backend=backend, device=DEVICE)
        req = Request(Kind.ONLINE, 0.0, len(prompt), 4)
        eng.add_request(req, prompt)
        eng.prefill(req.rid)
        _, _, tokens, positions, tables, lengths = eng._decode_args([req.rid])
        tok = tokens[0] if tok is None else tok     # same input token on both
        tokens[0] = tok
        with torch.inference_mode():
            out = eng._decode_logits(*(torch.as_tensor(a, device=DEVICE) for a in (
                tokens.astype("int64"), positions.astype("int64"), tables, lengths)))
        logits.append(out[0].float())
        eng.release(req.rid)
    ker, pln = logits
    check(bool(torch.isfinite(ker).all()), "kernel-path logits are not finite")
    rel = ((ker - pln).abs().max() / pln.abs().max()).item()
    print(f"full-width logits, kernels vs plain versions: shape {tuple(ker.shape)}, "
          f"max abs err / max |logit| = {rel:.3e} (tol {LOGITS_REL_TOL}), "
          f"argmax {int(ker.argmax())} vs {int(pln.argmax())}")
    check(rel <= LOGITS_REL_TOL, f"full-width logits disagree: {rel}")


def main_path(fp_ops, pa_ops, cfg):
    """Phase 1: the co-located configuration (``CoLocatedServer``'s)."""
    import torch
    from repro_torch.cluster.runtime import PoolRuntime, WallClock
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.request import Kind, Request
    from repro_torch.data import traces as tr
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params "
          f"({n_params * 2 / 1e9:.2f} GB bf16), seeded in "
          f"{time.perf_counter() - t0:.1f} s")
    logits_agree(model, params, cfg)

    rt = PoolRuntime(cfg, policy="ooco", n_strict=1, n_relaxed=1,
                     clock=WallClock(), hw=H100_SXM, decode_buckets=(8,),
                     chunk_tokens=0, decode_horizon=1, num_pages=1024,
                     page_size=16, slo_ttft=2.0, slo_tpot=0.05, seed=0,
                     device=DEVICE, model=model, params=params)
    pool = rt.strict_pool[0].engine.cache
    print(f"KV pools per engine: {pool.num_pages} pages x {pool.page_size} tokens, "
          f"{2 * pool.k_pool.numel() * pool.k_pool.element_size() / 1e9:.3f} GB")
    # warm-up outside the measured run: cuBLAS handles and the GEMM shapes
    # of every prefill bucket up to 512 tokens and of the decode bucket, on
    # each engine
    for slot in rt.strict_pool + rt.relaxed_pool:
        eng = slot.engine
        for n in (8, 16, 32, 64, 128, 256, 512):
            req = Request(Kind.OFFLINE, 0.0, n, 2)
            eng.add_request(req, [1] * n)
            eng.prefill(req.rid)
            eng.decode_step([req.rid])
            eng.release(req.rid)
    # the scheduler's bs_sat memo (Alg. 1, PerfModel.compute_saturated_batch)
    # costs ~1 s of host time the first time each power-of-two context bucket
    # is seen; a server pays that once at startup
    t0 = time.perf_counter()
    for b in range(1, 12):
        rt.pm.compute_saturated_batch(1 << b)
    print(f"scheduler bs_sat memo for contexts up to 2048 filled in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()

    online = tr.online_trace("ooc", duration=6.0, mean_qps=1.0, seed=0)
    offline = tr.with_uniform_qps(tr.offline_requests(8, seed=1), 2.0)
    torch.cuda.reset_peak_memory_stats()
    fp_ops.flash_attention.launches = 0
    pa_ops.paged_attention.launches = 0
    t0 = time.perf_counter()
    summary = rt.run(online, offline, duration=6.0, max_prompt=512, max_output=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_prefill": fp_ops.flash_attention.launches,
                "paged_attention": pa_ops.paged_attention.launches}
    print("summary " + json.dumps(summary, sort_keys=True))
    n_req = summary["online_requests"] + summary["offline_requests"]
    n_fin = summary["online_finished"] + summary["offline_finished"]
    print(f"requests finished: {n_fin}/{n_req} in {wall:.2f} s wall")
    print(f"measured online TTFT p50 {summary['online_ttft_p50']} s, "
          f"TPOT p50 {summary['online_tpot_p50']} s")
    print(f"kernel launches on the main path: {launches}")
    for slot in rt.strict_pool + rt.relaxed_pool:
        st = slot.engine.stats
        print(f"{slot.name}: {st.dispatches_by_kind['prefill']} prefills in "
              f"{st.prefill_seconds:.3f} s, {st.decode_steps} decode steps in "
              f"{st.decode_seconds:.3f} s (host wall, warm-up included)")
    print("online (arrival s, TTFT s): " + ", ".join(
        f"({r.arrival:.2f}, {r.ttft():.3f})" for r in rt.all_requests
        if r.kind is Kind.ONLINE and r.ttft() is not None))
    print(f"migrations {summary['migrations']}, pulls {summary['pulls']}, "
          f"preemptions {summary['preemptions']}, evictions {summary['evictions']}")
    print(f"torch.cuda.max_memory_allocated: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(n_req > 0 and n_fin == n_req, f"only {n_fin}/{n_req} requests finished")
    for name, n in launches.items():
        check(n > 0, f"{name} kernel never launched on the main path")
    for toks in rt.tokens.values():
        check(all(0 <= t < cfg.vocab_size for t in toks), "token id out of range")
    profile_engine(rt.relaxed_pool[0].engine, cfg)
    return launches, model, params, rt.kernel_donor, rt.pm


def profile_engine(eng, cfg) -> None:
    """Where the time goes on one engine at the runtime's shapes: a 512-token
    prefill, then decode steps of a full bucket (8 requests, context ~512).
    Host wall time per call is taken without the profiler; a second pass
    under torch.profiler gives the device's busy time (the sum of its kernel
    times) and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.request import Kind, Request

    g = torch.Generator().manual_seed(11)
    reqs = [Request(Kind.OFFLINE, 0.0, 512, 64) for _ in range(8)]
    for r in reqs:
        eng.add_request(r, torch.randint(0, cfg.vocab_size, (512,), generator=g).tolist())
    rids = [r.rid for r in reqs]

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    pending = iter(rids)
    t_prefill = timed(lambda: eng.prefill(next(pending)), 3)
    syncs_prefill = count_syncs(lambda: eng.prefill(next(pending)))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_p:
        eng.prefill(next(pending))
        torch.cuda.synchronize()
    for r in pending:
        eng.prefill(r)
    t_decode = timed(lambda: eng.decode_step(rids), 8)
    syncs_decode = count_syncs(lambda: eng.decode_step(rids))
    print(f"host syncs: {len(syncs_prefill)} per prefill {syncs_prefill}, "
          f"{len(syncs_decode)} per decode step {syncs_decode}")
    check(len(syncs_decode) == 1, f"a decode step made {syncs_decode} host syncs, not 1")
    with profile(activities=acts) as prof_d:
        for _ in range(4):
            eng.decode_step(rids)
        torch.cuda.synchronize()
    for r in rids:
        eng.release(r)
    report_profile("prefill of 512 tokens", prof_p, t_prefill, 1)
    report_profile("decode step, B=8, context ~512", prof_d, t_decode, 4)


def report_profile(what, prof, wall, n) -> float:
    """Device busy time per call from a torch.profiler run over ``n`` calls
    (the sum of its kernel times), beside the host wall time per call, and
    the kernels that take most of it. Returns the busy ms per call."""
    ev = [e for e in prof.key_averages()
          if getattr(e, "device_type", None) is not None
          and "CUDA" in str(e.device_type)]
    busy = {e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / 1e3 / n
            for e in ev}
    total = sum(busy.values())
    launched = sum(e.count for e in ev) / n
    print(f"{what}: host wall {wall:.3f} ms per call (no profiler); device "
          f"busy {total:.3f} ms per call ({100 * total / wall:.1f}% of the wall "
          f"time, {100 - 100 * total / wall:.1f}% idle); {launched:.0f} kernels "
          f"per call")
    top = sorted(busy.items(), key=lambda kv: -kv[1])
    ours = [kv for kv in top[6:] if "paged_decode" in kv[0] or "flash_prefill" in kv[0]]
    for key, ms in top[:6] + ours:
        print(f"  {ms:8.3f} ms  {100 * ms / max(total, 1e-9):5.1f}%  {key[:90]}")
    return total


# ---------------------------------------------------------------------------
# the engine's chunked, fused and horizon paths at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_logits(model):
    """Every logits row block the model computes while the block runs."""
    seen = []
    orig = model._logits
    model._logits = lambda params, x: seen.append(orig(params, x).float()) or seen[-1]
    try:
        yield seen
    finally:
        del model._logits


def rel_err(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def margin_excused(logits, tok_serial, tok_fused) -> bool:
    """The margin rule: a token that differs from the serial run's is
    excused only where the serial top-2 logit margin is below 1e-2 of the
    largest logit (a near-tie the summation order may flip)."""
    top2 = logits.topk(2).values
    margin = (top2[0] - top2[1]).item()
    ok = margin < 1e-2 * logits.abs().max().item()
    print(f"    token {tok_fused} vs serial {tok_serial}: serial top-2 margin "
          f"{margin:.4f} ({'excused' if ok else 'NOT a near-tie'})")
    return ok


def compare_streams(what, serial_logits, serial_toks, fused_toks, rows, diverged):
    """Per row, fused tokens against serial ones under the margin rule; a
    row is compared up to its first excused step only (its inputs differ
    after it). Returns the number of excused steps."""
    excused = 0
    for i, r in enumerate(rows):
        if r in diverged:
            continue
        for t, (a, b) in enumerate(zip(serial_toks[r], fused_toks[r])):
            if a != b:
                check(margin_excused(serial_logits[t][i], a, b),
                      f"{what}: row {i} step {t} differs from serial")
                excused += 1
                diverged.add(r)
                break
    return excused


def engine_checks(model, params, cfg) -> None:
    """At full width, on engines of their own: chunked prefill against whole
    prefill and against the plain versions; a mixed step's decode rows
    against ``decode_step``; K=4 decode and mixed horizons against 4 serial
    steps; a warm prefix against a cold one; one host sync per dispatch."""
    import torch
    from repro_torch.core.request import Kind, Request
    from repro_torch.core.scheduling import split_chunk
    from repro_torch.engine.engine import ServingEngine

    g = torch.Generator().manual_seed(13)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    def engine(backend="auto", prefix_cache=False):
        return ServingEngine(model, params, num_pages=256, decode_buckets=(8,),
                             backend=backend, prefix_cache=prefix_cache, device=DEVICE)

    def add(eng, toks, out=64):
        r = Request(Kind.OFFLINE, 0.0, len(toks), out)
        eng.add_request(r, toks)
        return r.rid

    def chunked(eng, rid, chunk=96):
        """Land a prompt through chunk-only mixed steps; returns the offsets
        and the first-token logits."""
        offsets = []
        with recorded_logits(model) as seen:
            while eng.requests[rid].generated == 0:
                offsets.append(eng.prefill_progress(rid))
                eng.mixed_step([], rid, chunk)
        return offsets, seen[-1][0]

    # 1. a 300-token prompt in chunks of 96 against whole-prompt prefill,
    #    and against the same chunks on the plain versions
    p300 = prompt(300)
    eng = engine()
    with recorded_logits(model) as seen:
        eng.prefill(add(eng, p300))
    whole = seen[-1][0]
    engine_k = engine()
    offsets, chunk_k = chunked(engine_k, add(engine_k, p300))
    engine_r = engine("ref")
    _, chunk_r = chunked(engine_r, add(engine_r, p300))
    del eng, engine_k, engine_r
    check(offsets == [0, 96, 192, 288], f"chunk offsets {offsets}")
    for name, a, b in (("chunked vs whole-prompt prefill", chunk_k, whole),
                       ("chunked, kernels vs plain versions", chunk_k, chunk_r)):
        rel = rel_err(a, b)
        print(f"full-width first-token logits of a 300-token prompt, {name} (chunks "
              f"of 96 at offsets {offsets}): max abs err / max |logit| = {rel:.3e} "
              f"(tol {LOGITS_REL_TOL}), argmax {int(a.argmax())} vs {int(b.argmax())}")
        check(rel <= LOGITS_REL_TOL, f"{name}: logits disagree ({rel})")

    # 2. a mixed step's 7 decode rows against decode_step from the same state:
    #    decode_step's logits first (its K/V writes are the mixed step's own,
    #    same values into the same slots)
    lens8 = [40, 100, 177, 256, 300, 333, 420, 500]
    prompts8 = [prompt(n) for n in lens8]
    serial, fused = engine(), engine()
    rows_s = [add(serial, p) for p in prompts8]
    rows_f = [add(fused, p) for p in prompts8]
    for e, rows in ((serial, rows_s), (fused, rows_f)):
        for r in rows:
            e.prefill(r)
    dec7 = rows_f[:7]
    pf = add(fused, prompt(384), 8)
    _, _, *args = fused._decode_args(dec7)
    with torch.inference_mode():
        step_logits = fused._decode_logits(*fused._upload_decode(*args))[:7].float()
    with recorded_logits(model) as seen:
        syncs = count_syncs(lambda: fused.mixed_step(dec7, pf, 96))
    mixed_logits = seen[0][:7]
    diff = (mixed_logits - step_logits).abs().max().item()
    same = mixed_logits.argmax(-1).tolist() == step_logits.argmax(-1).tolist()
    print(f"mixed step (7 decode rows + a 96-token chunk) vs decode_step from the "
          f"same state: max logit difference {diff} (0 by construction), tokens "
          f"{'equal' if same else 'DIFFER'}; host syncs {len(syncs)} {syncs}")
    check(same, "a mixed step's decode rows disagree with decode_step")
    check(len(syncs) == 1, f"a mixed step made {len(syncs)} host syncs, not 1")
    # the other engine takes the same step, so both hold the same state
    pf_s = add(serial, fused.token_buf[pf][:384], 8)
    serial.mixed_step(rows_s[:7], pf_s, 96)

    # 3. K=4 horizons against 4 serial steps, under the margin rule
    diverged, excused = set(), 0
    with recorded_logits(model) as seen:
        before = {r: len(serial.token_buf[r]) for r in rows_s}
        for _ in range(4):
            serial.decode_step(rows_s)
    s_toks = {r: serial.token_buf[r][before[r]:] for r in rows_s}
    out = {}
    syncs = count_syncs(lambda: out.update(fused.decode_horizon(rows_f, 4)))
    f_toks = {rs: out[rf] for rs, rf in zip(rows_s, rows_f)}
    print(f"decode horizon K=4, B=8 vs 4 serial decode steps: host syncs "
          f"{len(syncs)} {syncs}")
    check(len(syncs) == 1, f"a decode horizon made {len(syncs)} host syncs, not 1")
    excused += compare_streams("decode horizon", seen, s_toks, f_toks, rows_s, diverged)
    pf2 = prompt(384)
    ps, pfh = add(serial, pf2, 8), add(fused, pf2, 8)
    with recorded_logits(model) as seen:
        before = {r: len(serial.token_buf[r]) for r in rows_s}
        for sub in split_chunk(96, 4):
            serial.mixed_step(rows_s, ps, sub)
    s_toks = {r: serial.token_buf[r][before[r]:] for r in rows_s}
    dec_logits = seen[0::2]                    # decode rows, then the chunk row
    out = {}
    syncs = count_syncs(lambda: out.update(fused.mixed_horizon(rows_f, pfh, 96, 4)))
    f_toks = {rs: out[rf] for rs, rf in zip(rows_s, rows_f)}
    print(f"mixed horizon K=4 (8 decode rows + a 96-token chunk in 4 slices) vs 4 "
          f"serial mixed steps: host syncs {len(syncs)} {syncs}")
    check(len(syncs) == 1, f"a mixed horizon made {len(syncs)} host syncs, not 1")
    check(fused.prefill_progress(pfh) == serial.prefill_progress(ps) == 96,
          "the mixed horizon landed another share of the chunk")
    excused += compare_streams("mixed horizon", dec_logits, s_toks, f_toks, rows_s,
                               diverged)
    print(f"horizons vs serial steps: tokens equal except {excused} step(s) excused "
          f"by the margin rule")
    del serial, fused

    # 4. a prompt that shares a 256-token prefix with an earlier one, warm
    #    (claimed from the prefix cache) against cold
    prefix = prompt(256)
    pa, pb = prefix + prompt(44), prefix + prompt(60)
    warm, cold = engine(prefix_cache=True), engine()
    chunked(warm, add(warm, pa))
    _, warm_logits = chunked(warm, add(warm, pb))
    _, cold_logits = chunked(cold, add(cold, pb))
    st = warm.stats
    rel = rel_err(warm_logits, cold_logits)
    print(f"warm prefix (256 tokens claimed, the 60-token suffix at q_offset 256) vs "
          f"cold: max abs err / max |logit| = {rel:.3e} (tol {LOGITS_REL_TOL}); "
          f"prefix_hits {st.prefix_hits}, cached_tokens {st.cached_tokens}")
    check(rel <= LOGITS_REL_TOL, f"warm vs cold logits disagree ({rel})")
    check(st.prefix_hits == 1 and st.cached_tokens == 256, "the prefix was not claimed")
    del warm, cold
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2: the default configuration
# ---------------------------------------------------------------------------

def default_path(fp_ops, pa_ops, cfg, model, params, donor, pm) -> dict:
    """Phase 2: the reference's default serving configuration (chunked
    prefill and horizons ``auto``, prefix cache on) over the first phase's
    weights, on a backlog with shared prefixes."""
    import torch
    from repro_torch.cluster.runtime import PoolRuntime, WallClock
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.request import Kind, Request
    from repro_torch.data import traces as tr
    from repro_torch.engine.engine import EngineStats

    rt = PoolRuntime(cfg, policy="ooco", n_strict=1, n_relaxed=1,
                     clock=WallClock(), hw=H100_SXM, decode_buckets=(8,),
                     chunk_tokens="auto", decode_horizon="auto", prefix_cache=True,
                     num_pages=1024, page_size=16, slo_ttft=2.0, slo_tpot=0.05,
                     seed=0, device=DEVICE, model=model, params=params,
                     kernels_from=donor)
    del donor    # the last engine of phase 1: its pools go now
    torch.cuda.empty_cache()
    # same model and hardware model as phase 1: its bs_sat memo carries over
    rt.pm._bs_sat_cache = pm._bs_sat_cache
    print(f"phase 2 runtime built; torch.cuda.memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    # warm-up outside the measured run (cuBLAS shapes of the chunk buckets,
    # mixed steps and horizons), then the engines start clean: no stats,
    # nothing in the prefix trees
    g = torch.Generator().manual_seed(17)
    for slot in rt.strict_pool + rt.relaxed_pool:
        eng = slot.engine
        rows = []
        for n in (8, 16, 32, 64, 128, 256, 512):
            req = Request(Kind.OFFLINE, 0.0, n, 16)
            eng.add_request(req, torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist())
            eng.mixed_step(rows[:7], req.rid, n)
            rows.append(req.rid)
        eng.decode_horizon(rows[:8], 4)
        req = Request(Kind.OFFLINE, 0.0, 512, 4)
        eng.add_request(req, torch.randint(0, cfg.vocab_size, (512,), generator=g).tolist())
        eng.mixed_horizon(rows[:7], req.rid, 320, 4)
        eng.mixed_step(rows[:7], req.rid, 192)
        for r in rows + [req.rid]:
            eng.release(r)
        eng.cache.prefix.release_all()
        eng.stats = EngineStats()
    torch.cuda.synchronize()

    online = tr.online_trace("ooc", duration=6.0, mean_qps=1.0, seed=0)
    shared = tr.shared_prefix_requests(
        num_prefixes=2, variants=1, queries=3, prefix_tokens=256, variant_tokens=64,
        query_tokens=64, output_len=32, vocab=cfg.vocab_size, seed=5)
    ooc = tr.offline_requests(8, seed=1)
    backlog = [r for pair in zip(shared, ooc) for r in pair] + ooc[len(shared):]
    offline = tr.with_uniform_qps(backlog, 2.0)
    fp_ops.flash_attention.launches = 0
    fp_ops.flash_attention.offset_launches = 0
    pa_ops.paged_attention.launches = 0
    t0 = time.perf_counter()
    summary = rt.run(online, offline, duration=6.0, max_prompt=512, max_output=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_prefill": fp_ops.flash_attention.launches,
                "flash_prefill_at_offset": fp_ops.flash_attention.offset_launches,
                "paged_attention": pa_ops.paged_attention.launches}
    print("phase 2 summary " + json.dumps(summary, sort_keys=True))
    n_req = summary["online_requests"] + summary["offline_requests"]
    n_fin = summary["online_finished"] + summary["offline_finished"]
    print(f"phase 2 requests finished: {n_fin}/{n_req} in {wall:.2f} s wall")
    print(f"phase 2 online TTFT p50 {summary['online_ttft_p50']} s, p99 "
          f"{summary['online_ttft_p99']} s; TPOT p50 {summary['online_tpot_p50']} s, "
          f"p99 {summary['online_tpot_p99']} s; attainment "
          f"{summary['online_slo_attainment']}; offline "
          f"{summary['offline_tokens_per_s']:.2f} tokens/s")
    print(f"phase 2 dispatches {summary['dispatches_by_kind']}; horizon rounds "
          f"{summary['horizon_rounds']}, mixed-horizon rounds "
          f"{summary['mixed_horizon_rounds']}, horizon steps {summary['horizon_steps']}; "
          f"chunks {summary['chunks']}, chunk preemptions {summary['chunk_preemptions']}; "
          f"prefix hits {summary['prefix_hits']}, cached tokens "
          f"{summary['cached_tokens']}; migrations {summary['migrations']}, pulls "
          f"{summary['pulls']}")
    print(f"phase 2 kernel launches: {launches}")
    check(n_req > 0 and n_fin == n_req, f"phase 2: only {n_fin}/{n_req} requests finished")
    check(summary["dispatches_by_kind"]["mixed"] > 0, "phase 2 ran no mixed step")
    check(summary["prefix_hits"] > 0, "phase 2 claimed no cached prefix")
    for name, n in launches.items():
        check(n > 0, f"phase 2: {name} never launched")
    for toks in rt.tokens.values():
        check(all(0 <= t < cfg.vocab_size for t in toks), "token id out of range")
    profile_fused(rt.relaxed_pool[0].engine, cfg)
    return launches


def profile_fused(eng, cfg) -> None:
    """One full-width mixed step (7 decode rows at context ~512 plus a
    256-token chunk) and one K=4 decode horizon (B=8): host wall time per
    call without the profiler, then the device's busy time under it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.request import Kind, Request

    g = torch.Generator().manual_seed(19)

    def add(n, out):
        r = Request(Kind.OFFLINE, 0.0, n, out)
        eng.add_request(r, torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist())
        return r.rid

    rows = [add(512, 64) for _ in range(8)]
    for r in rows:
        eng.mixed_step([], r, 512)
    pending = [add(512, 4) for _ in range(4)]

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    it = iter(pending)
    t_mixed = timed(lambda: eng.mixed_step(rows[:7], next(it), 256), 3)
    with profile(activities=acts) as prof_m:
        eng.mixed_step(rows[:7], next(it), 256)
        torch.cuda.synchronize()
    t_horizon = timed(lambda: eng.decode_horizon(rows, 4), 2)
    with profile(activities=acts) as prof_h:
        eng.decode_horizon(rows, 4)
        torch.cuda.synchronize()
    for r in rows + pending:
        eng.release(r)
    report_profile("mixed step, 7 decode rows at context ~512 + a 256-token chunk",
                   prof_m, t_mixed, 1)
    report_profile("decode horizon K=4, B=8, context ~512", prof_h, t_horizon, 1)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import ops as fp_ops, ref as fp_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops, ref as pa_ref

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(reports) or 'cached'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    paged_err = check_paged(pa_ops, pa_ref)
    flash_err, chunk_err = check_flash(fp_ops, fp_ref)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    paged_t = time_paged(pa_ops, pa_ref, flush)
    flash_t = time_flash(fp_ops, fp_ref, flush, 512)
    flash_long_t = time_flash(fp_ops, fp_ref, flush, 2048)
    chunk_t = time_flash_chunk(fp_ops, fp_ref, flush)
    del flush
    torch.cuda.empty_cache()

    from repro_torch.configs import get_config
    cfg = get_config("qwen2.5-7b")
    colocated, model, params, donor, pm = main_path(fp_ops, pa_ops, cfg)
    engine_checks(model, params, cfg)
    default = default_path(fp_ops, pa_ops, cfg, model, params, donor, pm)
    del donor
    # launches by path: phase 1 (co-located: whole prompts) and phase 2
    # (default configuration: every prompt through chunks)
    paged_n = {"colocated": colocated["paged_attention"],
               "default": default["paged_attention"]}
    paged = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:72",
             "launches": sum(paged_n.values()), "launches_by_path": paged_n,
             "max_abs_err": paged_err}
    flash = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
             "replaces": "src/repro/kernels/flash_prefill/kernel.py:86",
             "launches": colocated["flash_prefill"], "max_abs_err": flash_err}
    kernels = [
        {"name": "paged_attention", "shape": "B=8 ctx=512", **paged, **paged_t},
        {"name": "flash_prefill", "shape": "B=1 S=512", "use": "whole prompt",
         **flash, **flash_t},
        # prompts are clipped to 512 tokens on the main path: no launch at S=2048
        {"name": "flash_prefill (S=2048)", "shape": "B=1 S=2048", "use": "whole prompt",
         **flash, "launches": 0, **flash_long_t},
        {"name": "flash_prefill (chunk)",
         "shape": "B=1 C=256 c=192 q_offset=320 Skv=512 kv_len=512", "use": "chunk",
         **flash, "launches": default["flash_prefill"],
         "launches_at_q_offset": default["flash_prefill_at_offset"],
         "max_abs_err": chunk_err, **chunk_t},
    ]
    for k in kernels:
        k["x_library"] = k["ms"] / k["library_ms"]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
