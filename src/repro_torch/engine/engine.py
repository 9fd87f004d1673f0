"""Serving engine: continuous batching + paged KV + layer-interruptible prefill.

One ``ServingEngine`` is an xllm-instance analogue (DESIGN §3): it holds the
model weights once and runs Prefill and/or Decode iterations. This is the
PyTorch port of ``repro.engine.engine`` for the co-located configuration
(``CoLocatedServer``: whole-prompt prefill, one decode step per dispatch):

* **Layer-level interruption** (§3.4.1): ``prefill()`` runs the prompt
  through the layers one at a time and polls a preemption callback between
  layers. An interrupted prefill keeps (hidden, layer index) with the KV of
  the finished layers already in the pool, and resumes exactly where it
  stopped. Prompts are padded to power-of-two buckets and masked with the
  runtime ``kv_lens`` the flash-prefill kernel takes.
* **Decode**: ``decode_step`` embeds one token per request, and per layer
  writes the new K/V in place into the paged pools and runs paged decode
  attention straight over the block tables. Batches are padded to bucket
  sizes; padded rows write into the reserved trash page 0.
* ``backend="auto"|"cuda"|"ref"`` picks the attention implementation: the
  hand-written Hopper kernels on a CUDA device, the plain PyTorch versions on
  the CPU or when ``ref`` is asked for by name.

``jax.jit`` and ``lax.scan`` become an eager Python loop over layers. The
KV pools are written in place (their ``data_ptr()`` never changes), and one
decode step makes one device-to-host sync: the ``.tolist()`` of its (B,) ids.
Chunked prefill with fused mixed steps and multi-step horizons are not
ported yet (ROADMAP queue 1): their entry points raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Phase, Request
from repro_torch.engine.kv_cache import (PagedKVCache, to_device, transfer_checksum,
                                         verify_transfer)
from repro_torch.kernels import require_device, resolve_backend
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import attention, layers
from repro_torch.models.transformer import Transformer, _norm

_NOT_PORTED = ("{} is not ported yet: chunked prefill, mixed steps and "
               "decode horizons are ROADMAP queue 1, items 1-2")


class EngineCrashedError(RuntimeError):
    """Raised when a dispatch is attempted on a crashed engine."""


@dataclass
class SamplingParams:
    """Engine-default sampling. ``temperature <= 0`` means greedy; ``top_k``
    0 keeps the full vocab. Per-request overrides via ``set_sampling``."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


def sample_tokens(logits, gen: torch.Generator, temps, top_ks):
    """On-device sampler: greedy rows where temps <= 0, temperature/top-k
    elsewhere. logits (B, V) f32; temps (B,) f32; top_ks (B,) int
    (0 = full vocab). Returns (B,) int64 token ids."""
    V = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    srt = logits.sort(dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, top_ks, V).clamp(1, V).long()
    thresh = srt.gather(-1, (k_eff - 1)[:, None])
    masked = torch.where(logits >= thresh, logits, -torch.inf)
    scaled = masked / temps.clamp_min(1e-6)[:, None]
    sampled = torch.multinomial(scaled.softmax(dim=-1), 1, generator=gen)[:, 0]
    return torch.where(temps > 0, sampled, greedy)


class TokenRing:
    """Preallocated int32 token buffer (prompt + generated) with list-like
    reads. Appends write into preallocated storage (amortized O(1), no
    per-token Python list growth); capacity doubles if exceeded."""

    __slots__ = ("_buf", "_n")

    def __init__(self, tokens, capacity: int = 0):
        tokens = np.asarray(list(tokens), np.int32)
        cap = max(capacity, tokens.shape[0], 8)
        self._buf = np.empty(cap, np.int32)
        self._buf[: tokens.shape[0]] = tokens
        self._n = tokens.shape[0]

    def append(self, tok: int) -> None:
        if self._n == self._buf.shape[0]:
            grown = np.empty(self._buf.shape[0] * 2, np.int32)
            grown[: self._n] = self._buf
            self._buf = grown
        self._buf[self._n] = tok
        self._n += 1

    def tolist(self) -> list[int]:
        return self._buf[: self._n].tolist()

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self._buf[: self._n][i].tolist()
        n = self._n
        if not -n <= i < n:
            raise IndexError(i)
        return int(self._buf[i % n if i < 0 else i])

    def __iter__(self):
        return iter(self.tolist())

    def __eq__(self, other) -> bool:
        if isinstance(other, TokenRing):
            return self.tolist() == other.tolist()
        if isinstance(other, (list, tuple)):
            return self.tolist() == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"TokenRing({self.tolist()})"


@dataclass
class PartialPrefill:
    """State of a layer-interrupted prefill (resume token). KV of completed
    layers is already in the paged pool."""
    rid: int
    x: torch.Tensor           # hidden after `layer` layers, (1, S, d)
    layer: int                # layers completed
    tokens: np.ndarray


@dataclass
class ChunkedPrefill:
    """State of a chunk-granular prefill: ``done`` prompt tokens have run
    through EVERY layer and their KV is landed in the paged pool. The port
    keeps the type for the runtime's bookkeeping; the chunked path itself is
    not ported yet."""
    rid: int
    tokens: np.ndarray        # full prompt token ids
    done: int = 0             # tokens landed (all layers, KV in the pool)
    cached: int = 0           # leading tokens claimed from the prefix cache


@dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    preemptions: int = 0
    evictions: int = 0
    decode_steps: int = 0
    prefill_chunks: int = 0   # chunk-granular prefill dispatches
    mixed_steps: int = 0      # fused prefill-chunk + decode dispatches
    host_syncs: int = 0       # device->host syncs on the token path
                              # (one per dispatch that returns tokens)
    horizon_steps: int = 0    # decode iterations run inside K>1 horizons
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    prefix_hits: int = 0      # prompts that claimed >= 1 cached prefix page
    cached_tokens: int = 0    # prompt tokens served from the prefix cache
    shared_pages: int = 0     # pages claimed via refcount bumps, cumulative
    dispatches_by_kind: dict = field(default_factory=lambda: {
        "prefill": 0, "decode": 0, "mixed": 0, "horizon": 0,
        "mixed_horizon": 0})


class ServingEngine:
    def __init__(self, model: Transformer, params, *, num_pages: int = 512,
                 page_size: int = 16, decode_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                 perf_model: PerfModel | None = None, backend: str = "auto",
                 sampling: SamplingParams | None = None,
                 prefix_cache: bool = False, device="cuda",
                 kernels_from: "ServingEngine | None" = None):
        cfg = model.cfg
        if cfg.local_global or cfg.sliding_window:
            raise ValueError("engine supports full-attention archs (cluster-"
                             "scale behaviour of windowed/SSM families is "
                             "exercised via the simulator)")
        self.device = require_device(device)
        self.model = model
        self.cfg = cfg
        self.params = params
        self.backend = resolve_backend(backend, self.device)
        self.sampling = sampling or SamplingParams()
        self.cache = PagedKVCache(cfg, num_pages, page_size,
                                  enable_prefix_cache=prefix_cache,
                                  device=self.device)
        self.decode_buckets = tuple(sorted(decode_buckets))
        self.perf_model = perf_model
        self.requests: dict[int, Request] = {}
        self.token_buf: dict[int, TokenRing] = {}   # prompt + generated tokens
        self.partial: dict[int, PartialPrefill] = {}
        self.chunk_state: dict[int, ChunkedPrefill] = {}
        self.req_sampling: dict[int, tuple[float, int]] = {}
        self.stats = EngineStats()
        if kernels_from is not None:
            # pool runtimes run N+M engines over the SAME weights; siblings
            # share the per-layer parameter views instead of re-slicing
            src = kernels_from
            if not (src.model is model and src.params is params
                    and src.cache.page_size == page_size
                    and src.backend == self.backend and src.device == self.device):
                raise ValueError("kernel sharing requires identical model/params/"
                                 "page_size/backend/device")
            self._layer_params_cached = src._layer_params_cached
        else:
            # per-layer params sliced once (views, no copies)
            self._layer_params_cached = [
                _tree_index(params["layers"], i) for i in range(cfg.num_layers)]
        self._sample_step = 0
        self.alive = True

    # ------------------------------------------------------------------
    # fault surface
    # ------------------------------------------------------------------
    def crash(self) -> None:
        """Simulate an engine-process crash: device KV pools, block tables,
        and host-side request bookkeeping are all lost. Any further dispatch
        raises ``EngineCrashedError``. Recovery is the scheduler's job — the
        pool runtime re-admits every in-flight request from its frontend
        request log through the recompute path."""
        self.alive = False
        self.requests.clear()
        self.token_buf.clear()
        self.partial.clear()
        self.chunk_state.clear()
        self.req_sampling.clear()
        self.cache.tables.clear()
        self.cache.lengths.clear()
        if self.cache.prefix is not None:
            self.cache.prefix.clear()

    def _check_alive(self) -> None:
        if not self.alive:
            raise EngineCrashedError("engine has crashed; state is gone")

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def set_sampling(self, rid: int, temperature: float, top_k: int = 0) -> None:
        """Per-request override of the engine-default sampling params."""
        self.req_sampling[rid] = (temperature, top_k)

    def _sampling_arrays(self, rids: list[int], pad_to: int):
        d = (self.sampling.temperature, self.sampling.top_k)
        temps = np.zeros(pad_to, np.float32)
        topks = np.zeros(pad_to, np.int64)
        for i, r in enumerate(rids):
            temps[i], topks[i] = self.req_sampling.get(r, d)
        return temps, topks

    def _next_generator(self) -> torch.Generator:
        """A generator for the next sample step, seeded from (seed, step) —
        the port's counterpart of folding the step into the base key."""
        self._sample_step += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.sampling.seed * 1_000_003 + self._sample_step)
        return gen

    def _sample(self, logits, rids: list[int], sampled: bool):
        if not sampled:
            return logits.argmax(dim=-1)
        temps, topks = self._sampling_arrays(rids, logits.shape[0])
        return sample_tokens(logits, self._next_generator(),
                             to_device(temps, self.device), to_device(topks, self.device))

    def _any_sampled(self, rids: list[int]) -> bool:
        return (self.sampling.temperature > 0
                or any(self.req_sampling.get(r, (0.0, 0))[0] > 0 for r in rids))

    # ------------------------------------------------------------------
    # layer-interruptible prefill
    # ------------------------------------------------------------------
    @staticmethod
    def pad_chunk(n: int) -> int:
        """Bucket a prefill prompt length to the next power of two (min 8)."""
        return max(8, 1 << (max(n, 1) - 1).bit_length())

    def _layer_fn(self, lp, x, positions, kv_lens):
        cfg = self.cfg
        h = _norm(cfg, lp["ln1"], x)
        a, (k, v) = attention.attn_prefill(
            lp["attn"], h, positions, cfg, window=cfg.sliding_window,
            kv_lens=kv_lens, backend=self.backend)
        if cfg.use_post_norm:
            a = _norm(cfg, lp["post_ln1"], a)
        x = x + a
        h = _norm(cfg, lp["ln2"], x)
        m = layers.mlp(lp["mlp"], h, cfg.mlp_act)
        if cfg.use_post_norm:
            m = _norm(cfg, lp["post_ln2"], m)
        return x + m, k, v

    def _layer_params(self, i: int):
        return self._layer_params_cached[i]

    def add_request(self, req: Request, prompt_tokens: list[int]) -> None:
        self._check_alive()
        if len(prompt_tokens) != req.prompt_len:
            raise ValueError(f"rid {req.rid}: prompt_len={req.prompt_len} but "
                             f"{len(prompt_tokens)} tokens")
        self.requests[req.rid] = req
        self.token_buf[req.rid] = TokenRing(
            prompt_tokens, capacity=req.prompt_len + req.output_len + 8)

    @torch.inference_mode()
    def prefill(self, rid: int, *,
                should_preempt: Callable[[], bool] | None = None) -> str:
        """Run (or resume) prefill for one request, checking the preemption
        callback between transformer layers. Returns "done" | "preempted"."""
        self._check_alive()
        if rid in self.chunk_state:
            raise RuntimeError("prefill() cannot resume a chunked/warm-started request")
        t0 = time.perf_counter()
        req = self.requests[rid]
        cfg = self.cfg
        if rid in self.partial:
            part = self.partial.pop(rid)
            x, start_layer, tokens = part.x, part.layer, part.tokens
        else:
            tokens = np.asarray(self.token_buf[rid][: req.prompt_len], np.int32)
            self.cache.ensure(rid, req.prompt_len)
            # pad to a bucket length; the padded keys are masked out by
            # kv_lens, so every length in the bucket has the same shapes
            padded = np.zeros(self.pad_chunk(tokens.shape[0]), np.int64)
            padded[: tokens.shape[0]] = tokens
            x = self.model._embed(self.params, to_device(padded, self.device)[None])
            start_layer = 0
        S = tokens.shape[0]
        positions = torch.arange(x.shape[1], device=self.device)[None]
        kv_lens = to_device(np.array([S], np.int32), self.device)
        index = self.cache.scatter_index(rid, S)
        req.phase = Phase.PREFILLING
        for li in range(start_layer, cfg.num_layers):
            x, k, v = self._layer_fn(self._layer_params(li), x, positions, kv_lens)
            self.cache.write_prefill_layers(rid, li, k[:, :S], v[:, :S], index)
            req.prefill_layers_done = li + 1
            if should_preempt is not None and li < cfg.num_layers - 1 and should_preempt():
                self.partial[rid] = PartialPrefill(rid, x, li + 1, tokens)
                self.stats.preemptions += 1
                self.stats.prefill_seconds += time.perf_counter() - t0
                return "preempted"
        # first token from the last REAL hidden state
        logits = self.model._logits(self.params, x[:, S - 1])
        nxt = int(self._sample(logits, [rid], self._any_sampled([rid]))[0])
        self.token_buf[rid].append(nxt)
        req.generated = 1
        req.phase = Phase.DECODING
        self.stats.prefill_tokens += S
        self.stats.host_syncs += 1
        self.stats.dispatches_by_kind["prefill"] += 1
        self.stats.prefill_seconds += time.perf_counter() - t0
        return "done"

    def abort_prefill(self, rid: int) -> None:
        """Discard partial prefill state (the whole prompt is re-run later,
        the pessimistic legacy accounting)."""
        part = self.partial.pop(rid, None)
        state = self.chunk_state.pop(rid, None)
        self.cache.free(rid)
        req = self.requests[rid]
        if state is not None:
            req.recompute_tokens += state.done - state.cached
        elif part is not None:
            req.recompute_tokens += req.prompt_len
        req.prefill_layers_done = 0
        req.prefill_tokens_done = 0
        req.cached_tokens = 0
        req.phase = Phase.QUEUED

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.decode_buckets:
            if n <= b:
                return b
        return self.decode_buckets[-1]

    @staticmethod
    def pad_pages(pages: int) -> int:
        """Pad a decode batch's page dimension to a power of two."""
        return 1 << (pages - 1).bit_length()

    def _attend(self, q, li: int, tables, lengths):
        """Paged decode attention of layer ``li``: the kernel reads the
        layer's pool through the real block tables; the plain path gathers
        the batch's pages first, as the reference does."""
        cfg = self.cfg
        kp, vp = self.cache.k_pool[li], self.cache.v_pool[li]
        if self.backend == "ref":
            B, Hq, hd = q.shape
            Hkv = cfg.num_kv_heads
            o = paged_attention_ref(q.reshape(B, Hkv, Hq // Hkv, hd), kp, vp,
                                    tables, lengths,
                                    logit_softcap=cfg.attn_logit_softcap)
            return o.reshape(B, Hq, hd)
        return paged_attention(q, kp, vp, tables, lengths,
                               num_kv_heads=cfg.num_kv_heads,
                               logit_softcap=cfg.attn_logit_softcap)

    def _decode_logits(self, tokens, positions, tables, lengths):
        """One decode iteration over the layer stack: per layer, the new
        token's K/V lands in the pools in place, then paged attention reads
        them. Returns (B, V) f32 logits."""
        cfg = self.cfg
        page_size = self.cache.page_size
        rows = torch.arange(tables.shape[0], device=self.device)
        page_ids = tables.long()[rows, positions // page_size]
        offs = positions % page_size
        x = self.model._embed(self.params, tokens[:, None])
        for li in range(cfg.num_layers):
            lp = self._layer_params(li)
            h = _norm(cfg, lp["ln1"], x)
            q, k_new, v_new = attention._project_qkv(lp["attn"], h, cfg, positions[:, None])
            self.cache.k_pool[li, page_ids, offs] = self.cache.store(k_new[:, 0])
            self.cache.v_pool[li, page_ids, offs] = self.cache.store(v_new[:, 0])
            a = self._attend(q[:, 0], li, tables, lengths)
            a = layers.dense(lp["attn"]["wo"], a.reshape(a.shape[0], 1, -1))
            if cfg.use_post_norm:
                a = _norm(cfg, lp["post_ln1"], a)
            x = x + a
            h = _norm(cfg, lp["ln2"], x)
            m = layers.mlp(lp["mlp"], h, cfg.mlp_act)
            if cfg.use_post_norm:
                m = _norm(cfg, lp["post_ln2"], m)
            x = x + m
        return self.model._logits(self.params, x[:, 0])

    def decode_step(self, rids: list[int]) -> dict[int, int]:
        """One continuous-batching decode iteration for the given requests;
        batches larger than the biggest bucket run as multiple bucket-sized
        chunks (no request is ever silently dropped). Returns rid -> new
        token for every rid passed."""
        self._check_alive()
        if not rids:
            return {}
        out: dict[int, int] = {}
        max_bucket = self.decode_buckets[-1]
        for i in range(0, len(rids), max_bucket):
            out.update(self._decode_chunk(rids[i: i + max_bucket]))
        return out

    def _decode_args(self, rids: list[int]):
        """Build the padded host args of a decode batch."""
        B = len(rids)
        bucket = self._bucket(B)
        for r in rids:
            self.cache.ensure(r, self.requests[r].context_len)
        pages = self.pad_pages(max(len(self.cache.tables[r]) for r in rids))
        tables = self.cache.batch_tables(rids, pad_to=pages)
        # the input token is the last one in the buffer; its position is
        # context_len - 1 and the cache covers [0, context_len) after writing
        positions = np.array([self.requests[r].context_len - 1 for r in rids], np.int32)
        tokens = np.array([self.token_buf[r][int(pos)] for r, pos in zip(rids, positions)],
                          np.int32)
        lengths = positions + 1
        pad = bucket - B
        if pad:
            # padded rows: table row of page 0 (the trash page), length 1
            tables = np.pad(tables, ((0, pad), (0, 0)))
            positions = np.pad(positions, (0, pad))
            tokens = np.pad(tokens, (0, pad))
            lengths = np.pad(lengths, (0, pad), constant_values=1)
        return bucket, pages, tokens, positions, tables, lengths

    def _decode_finish(self, rids: list[int], nxt: list[int], dt: float) -> dict[int, int]:
        """Per-request bookkeeping after a decode dispatch."""
        out = {}
        for i, r in enumerate(rids):
            req = self.requests[r]
            tok = int(nxt[i])
            self.token_buf[r].append(tok)
            req.generated += 1
            req.decode_time_sum += dt
            out[r] = tok
            if req.done:
                req.phase = Phase.FINISHED
                self.cache.free(r)
                self.req_sampling.pop(r, None)
        self.stats.decode_tokens += len(rids)
        self.stats.decode_steps += 1
        self.stats.decode_seconds += dt
        return out

    @torch.inference_mode()
    def _decode_chunk(self, rids: list[int]) -> dict[int, int]:
        t0 = time.perf_counter()
        _, _, tokens, positions, tables, lengths = self._decode_args(rids)
        dev = self.device
        logits = self._decode_logits(
            to_device(tokens.astype(np.int64), dev), to_device(positions.astype(np.int64), dev),
            to_device(tables, dev), to_device(lengths, dev))
        nxt = self._sample(logits, rids, self._any_sampled(rids)).tolist()  # the one sync
        self.stats.host_syncs += 1
        self.stats.dispatches_by_kind["decode"] += 1
        return self._decode_finish(rids, nxt, time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # not ported yet (ROADMAP queue 1)
    # ------------------------------------------------------------------
    def mixed_step(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("mixed_step"))

    def decode_horizon(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("decode_horizon"))

    def mixed_horizon(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("mixed_horizon"))

    def max_horizon_for(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("max_horizon_for"))

    def max_mixed_horizon_for(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format("max_mixed_horizon_for"))

    # ------------------------------------------------------------------
    def prefill_progress(self, rid: int) -> int:
        """Prompt tokens landed so far by the chunked path (0 if none)."""
        state = self.chunk_state.get(rid)
        return state.done if state is not None else 0

    def claim_prefix(self, rid: int) -> int:
        """Match the request's prompt against the radix prefix cache and
        claim the hit by bumping page refcounts. Returns the matched token
        count (0 on miss / cache disabled). The match is capped at
        ``prompt_len - 1`` and rounded down to a page boundary, so the
        uncached suffix is >= 1 token and starts exactly on a fresh page:
        shared pages are never written — copy-on-write by construction."""
        if self.cache.prefix is None:
            return 0
        if rid in self.chunk_state or rid in self.cache.tables:
            return 0   # already started (warm or cold) — nothing to claim
        req = self.requests[rid]
        tokens = np.asarray(self.token_buf[rid][: req.prompt_len], np.int32)
        pages, matched = self.cache.prefix.match(
            tokens.tolist(), limit=req.prompt_len - 1)
        if matched == 0:
            return 0
        self.cache.adopt(rid, pages, matched)
        self.chunk_state[rid] = ChunkedPrefill(
            rid, tokens, done=matched, cached=matched)
        req.prefill_tokens_done = matched
        req.cached_tokens = matched
        self.stats.prefix_hits += 1
        self.stats.cached_tokens += matched
        self.stats.shared_pages += len(pages)
        return matched

    def evict(self, rid: int) -> None:
        """Evict a decoding request (offline victim): free pages; it must
        re-prefill (recompute) later. Prefix-cache claims were a page-table
        update, not compute, so only context beyond the claimed prefix
        counts as recompute."""
        req = self.requests[rid]
        req.recompute_tokens += max(req.context_len - req.cached_tokens, 0)
        req.evictions += 1
        req.phase = Phase.EVICTED
        self.cache.free(rid)
        self.stats.evictions += 1

    def release(self, rid: int) -> None:
        """Drop EVERY trace of a request from this engine — the cancel
        path. Idempotent and stage-agnostic; bills no recompute waste."""
        self.partial.pop(rid, None)
        self.chunk_state.pop(rid, None)
        self.req_sampling.pop(rid, None)
        self.requests.pop(rid, None)
        self.token_buf.pop(rid, None)
        if rid in self.cache.tables:
            self.cache.free(rid)
        else:
            self.cache.lengths.pop(rid, None)

    def migrate_out(self, rid: int):
        """Export KV for migration to another engine (RDMA->NVLink analogue)."""
        k, v, n = self.cache.export_request(rid)
        self.cache.free(rid)
        return k, v, n

    def export_for_transfer(self, rid: int):
        """Export KV *without* freeing the source pages, plus an integrity
        checksum — the retry-safe transfer primitive: the source keeps its
        state until the destination has verified and imported the payload
        (``commit_transfer_out`` then releases it)."""
        k, v, n = self.cache.export_request(rid)
        return k, v, n, transfer_checksum(k, v)

    def commit_transfer_out(self, rid: int) -> None:
        """Release a request's local state after a verified transfer."""
        self.cache.free(rid)
        self.requests.pop(rid, None)
        self.token_buf.pop(rid, None)

    def migrate_in(self, rid: int, req: Request, tokens, k, v, n: int,
                   sampling: tuple[float, int] | None = None,
                   checksum: float | None = None) -> None:
        self._check_alive()
        if checksum is not None:
            # raises TransferIntegrityError BEFORE any state lands here
            verify_transfer(k, v, checksum)
        self.requests[rid] = req
        toks = list(tokens)
        self.token_buf[rid] = TokenRing(
            toks, capacity=len(toks) + max(req.remaining, 0) + 8)
        if sampling is not None:
            self.req_sampling[rid] = sampling
        self.cache.import_request(rid, k, v, n)
        req.phase = Phase.DECODING


def _tree_index(tree, i: int):
    """Layer ``i`` of a params dict whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]
