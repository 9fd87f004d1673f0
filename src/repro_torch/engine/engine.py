"""Serving engine: continuous batching + paged KV + chunked and layer-interruptible prefill.

One ``ServingEngine`` is an xllm-instance analogue (DESIGN §3): it holds the
model weights once and runs Prefill and/or Decode iterations. This is the
PyTorch port of ``repro.engine.engine``:

* **Chunked prefill + fused mixed steps** (§3.4.1 boundary granularity):
  ``mixed_step(decode_rids, prefill_rid, chunk_tokens)`` advances a prompt by
  a token-budgeted chunk in the same dispatch that decodes the resident
  batch. Per layer the chunk's K/V lands in the pools first, then its
  (length-bucketed) queries attend over the request's gathered pages with
  the flash-prefill kernel at a runtime ``q_offset`` and ``kv_lens``.
  Between chunks the only state is the count of landed tokens
  (``ChunkedPrefill``), and prefix-cache claims warm-start it.
* **Layer-level interruption** (§3.4.1, whole-prompt path): ``prefill()``
  runs the prompt through the layers one at a time and polls a preemption
  callback between layers, keeping (hidden, layer index) to resume from.
  Prompts are padded to power-of-two buckets and masked with ``kv_lens``.
* **Decode**: per layer, each row's new K/V is written in place into the
  paged pools and paged decode attention reads them straight through the
  block tables. Batches are padded to bucket sizes; padded rows write into
  the reserved trash page 0.
* **Horizons**: ``decode_horizon`` and ``mixed_horizon`` run K iterations
  with the sampled token fed back on the device and one host sync for the
  (K, B) token block.
* ``backend="auto"|"cuda"|"ref"`` picks the attention implementation: the
  hand-written Hopper kernels on a CUDA device, the plain PyTorch versions on
  the CPU or when ``ref`` is asked for by name.

``jax.jit`` and ``lax.scan`` become eager Python loops over layers and
iterations, all sharing one decode layer body (``_decode_layer``), so every
fused-vs-serial comparison runs the same ops at the same shapes. The KV
pools are written in place (their ``data_ptr()`` never changes), and each
dispatch makes one device-to-host sync: the ``.tolist()`` of its token ids.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.request import Phase, Request
from repro_torch.core.scheduling import split_chunk
from repro_torch.engine.kv_cache import (PagedKVCache, to_device, transfer_checksum,
                                         trash_sources, verify_transfer)
from repro_torch.kernels import require_device, resolve_backend
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import attention, layers
from repro_torch.models.transformer import (Transformer, _norm, _tree_unbind, block_prefill,
                                            block_tail)

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
    (0 = full vocab). Returns (B,) int64 token ids. Draws by the Gumbel-max
    rule over ``gen``'s uniforms, so nothing waits for the device (an
    argmax, where ``torch.multinomial`` checks its input on the host)."""
    V = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    srt = logits.sort(dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, top_ks, V).clamp(1, V).long()
    thresh = srt.gather(-1, (k_eff - 1)[:, None])
    masked = torch.where(logits >= thresh, logits, -torch.inf)
    scaled = masked / temps.clamp_min(1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    sampled = (scaled - torch.log(-torch.log(u))).argmax(dim=-1)
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
    through EVERY layer and their KV is landed in the paged pool. Pausing
    between chunks costs nothing, and a resume re-runs no layer."""
    rid: int
    tokens: np.ndarray        # full prompt token ids
    done: int = 0             # tokens landed (all layers, KV in the pool)
    cached: int = 0           # leading tokens claimed from the prefix cache


@dataclass
class _DecodeRows:
    """Device args of one decode iteration over a padded batch."""
    tokens: torch.Tensor      # (B,) int64 input token per row
    positions: torch.Tensor   # (B,) int64 its position
    tables: torch.Tensor      # (B, P) int32 block tables
    lengths: torch.Tensor     # (B,) int32 keys each row attends over
    page_ids: torch.Tensor    # (B,) int64 page its K/V lands in (0: trash)
    offs: torch.Tensor        # (B,) int64 slot in that page
    src: torch.Tensor | None  # (B,) int64 row whose K/V each row writes (MoE only)


@dataclass
class _ChunkRows:
    """Device args of one prefill chunk, bucketed to C rows."""
    tokens: torch.Tensor      # (C,) int64, real rows first
    positions: torch.Tensor   # (1, C) int64, from q_offset on
    page_ids: torch.Tensor    # (C,) int64 page each row's K/V lands in (0: trash)
    offs: torch.Tensor        # (C,) int64
    tables: torch.Tensor      # (cp,) int64 the request's pages, padded with 0
    q_offset: int             # prompt tokens landed before this chunk
    kv_lens: torch.Tensor     # (1,) int32 q_offset + n
    n: int                    # real rows
    src: torch.Tensor | None  # (C,) int64 row whose K/V each row writes (MoE only)


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
        if cfg.local_global or cfg.sliding_window or not isinstance(model, Transformer):
            raise ValueError("engine supports full-attention Transformer archs "
                             "(cluster-scale behaviour of windowed/SSM/hybrid/audio "
                             "families is exercised via the simulator)")
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
            self._layer_params_cached = _tree_unbind(params["layers"])
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

    def _sampling(self, rids: list[int], pad_to: int, prid: int | None = None):
        """(temps, top_ks) on the device for ``pad_to`` logits rows, or None
        when every row is greedy: the decode rids' rows first; with ``prid``,
        the last row is that prefill request's (row ``bucket`` of a mixed
        step, after the padded rows)."""
        if not self._any_sampled(rids if prid is None else [*rids, prid]):
            return None
        d = (self.sampling.temperature, self.sampling.top_k)
        temps = np.zeros(pad_to, np.float32)
        topks = np.zeros(pad_to, np.int64)
        for i, r in enumerate(rids):
            temps[i], topks[i] = self.req_sampling.get(r, d)
        if prid is not None:
            temps[-1], topks[-1] = self.req_sampling.get(prid, d)
        return to_device(temps, self.device), to_device(topks, self.device)

    def _reserve_steps(self, n: int) -> int:
        """Reserve ``n`` consecutive sample steps; returns the first. A K-step
        horizon reserves the K step ids that K serial dispatches would take,
        so it samples exactly as they do (the reference's ``_next_key_block``)."""
        first = self._sample_step + 1
        self._sample_step += n
        return first

    def _generator(self, step: int) -> torch.Generator:
        """The generator of one sample step, seeded from (seed, step) — the
        port's counterpart of folding the step into the base key."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.sampling.seed * 1_000_003 + step)
        return gen

    def _sample(self, logits, step: int, sampling):
        """Next tokens of ``logits`` at sample step ``step`` (``sampling``
        from ``_sampling``)."""
        if sampling is None:
            return logits.argmax(dim=-1)
        return sample_tokens(logits, self._generator(step), *sampling)

    def _any_sampled(self, rids: list[int]) -> bool:
        return (self.sampling.temperature > 0
                or any(self.req_sampling.get(r, (0.0, 0))[0] > 0 for r in rids))

    # ------------------------------------------------------------------
    # the layer bodies
    # ------------------------------------------------------------------
    @staticmethod
    def pad_chunk(n: int) -> int:
        """Bucket a prefill prompt/chunk length to the next power of two (min 8)."""
        return max(8, 1 << (max(n, 1) - 1).bit_length())

    def _layer_tail(self, lp, x, a):
        """The model's ``block_tail`` after attention's out-projection ``a``,
        shared by every layer body. An MoE layer routes all rows of ``x``
        together (one group), as the reference engine does: the padded
        prompt bucket, the padded decode bucket, or a chunk's bucket on its
        own. Capacity couples those rows, in token order."""
        return block_tail(lp, x, a, self.cfg, moe_groups=1)[0]

    def _layer_fn(self, lp, x, positions, kv_lens):
        """Whole-prompt prefill layer (the model's ``block_prefill``);
        returns (x, k, v)."""
        x, (k, v), _ = block_prefill(lp, x, positions, self.cfg,
                                     window=self.cfg.sliding_window, kv_lens=kv_lens,
                                     backend=self.backend, moe_groups=1)
        return x, k, v

    def _decode_layer(self, li: int, x, d: "_DecodeRows"):
        """One layer of one decode iteration, the body that ``decode_step``,
        the decode rows of a mixed step and every horizon iteration share, so
        each fused-vs-serial comparison runs the same ops at the same shapes:
        the new token's K/V lands in the pools in place, then paged attention
        reads them. x (B, 1, d)."""
        cfg = self.cfg
        lp = self._layer_params(li)
        h = _norm(cfg, lp["ln1"], x)
        q, k_new, v_new = attention._project_qkv(lp["attn"], h, cfg, d.positions[:, None])
        self.cache.write_layer(li, d.page_ids, d.offs, k_new[:, 0], v_new[:, 0], d.src)
        a = self._attend(q[:, 0], li, d.tables, d.lengths)
        a = layers.dense(lp["attn"]["wo"], a.reshape(a.shape[0], 1, -1))
        return self._layer_tail(lp, x, a)

    def _chunk_layer(self, li: int, x, c: "_ChunkRows"):
        """One layer of a prefill chunk: its K/V lands in the pools first,
        then its queries attend over the request's gathered pages (everything
        landed so far plus the chunk itself). x (1, C, d)."""
        cfg = self.cfg
        lp = self._layer_params(li)
        h = _norm(cfg, lp["ln1"], x)
        q, k, v = attention._project_qkv(lp["attn"], h, cfg, c.positions)
        self.cache.write_layer(li, c.page_ids, c.offs, k[0], v[0], c.src)
        k_ctx, v_ctx = self.cache.gather_pages(li, c.tables)
        a = attention.attn_chunk(lp["attn"], q, k_ctx, v_ctx, cfg,
                                 q_offset=c.q_offset, kv_lens=c.kv_lens,
                                 backend=self.backend)
        return self._layer_tail(lp, x, a)

    def _forward(self, d: "_DecodeRows | None", c: "_ChunkRows | None" = None):
        """One iteration over the layer stack for decode rows ``d`` and/or a
        prefill chunk ``c``, layer by layer side by side. Returns the logits
        rows to sample, (B, V) f32: the decode rows, then the chunk's last
        real row. The two sides never share a GEMM, so the decode rows
        compute exactly what a plain decode step computes."""
        cfg = self.cfg
        xd = None if d is None else self.model._embed(self.params, d.tokens[:, None])
        xc = None if c is None else self.model._embed(self.params, c.tokens[None])
        for li in range(cfg.num_layers):
            if d is not None:
                xd = self._decode_layer(li, xd, d)
            if c is not None:
                xc = self._chunk_layer(li, xc, c)
        logits = []
        if d is not None:
            logits.append(self.model._logits(self.params, xd[:, 0]))
        if c is not None:
            # only the final chunk's row is consumed (its first token)
            logits.append(self.model._logits(self.params, xc[:, c.n - 1]))
        return logits[0] if len(logits) == 1 else torch.cat(logits)

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
        sampling = self._sampling([rid], 1)
        step = 0 if sampling is None else self._reserve_steps(1)
        nxt = int(self._sample(logits, step, sampling)[0])
        self.token_buf[rid].append(nxt)
        req.generated = 1
        req.phase = Phase.DECODING
        self.stats.prefill_tokens += S
        self.stats.host_syncs += 1
        self.stats.dispatches_by_kind["prefill"] += 1
        self.stats.prefill_seconds += time.perf_counter() - t0
        return "done"

    def abort_prefill(self, rid: int) -> None:
        """Discard partial prefill state — layer-granular (the whole prompt
        is re-run later, the pessimistic legacy accounting) or chunk-granular
        (only the tokens actually landed, not those claimed from the prefix
        cache, count as recompute waste)."""
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

    def _decode_rows(self, tokens, positions, tables, lengths, active=None):
        """Device args of one decode iteration. Rows whose ``active`` flag is
        false (a horizon row past its last step) write into the trash page 0
        and attend as the reference's do: over ``positions + 1`` keys read
        through their table, whose last one they did not write, capped at
        the table's ``P * page_size`` slots (the reference's gather holds no
        more). Their output is discarded, but under MoE capacity a row's
        hidden state decides which later rows keep their expert slots, so
        there the rows that share a trash slot write one row's K/V
        (``_trash_sources``)."""
        P, page = tables.shape[1], self.cache.page_size
        rows = torch.arange(tables.shape[0], device=self.device)
        # a masked row's position may sit one page past its claim
        page_ids = tables.long()[rows, (positions // page).clamp_max(P - 1)]
        if active is not None:
            page_ids = torch.where(active, page_ids, 0)
            lengths = (positions + 1).clamp_max(P * page).int()
        offs = positions % page
        return _DecodeRows(tokens, positions, tables, lengths, page_ids, offs,
                           self._trash_sources(page_ids, offs))

    def _trash_sources(self, page_ids, offs):
        """``kv_cache.trash_sources`` of one write where rows are coupled (an
        MoE model: capacity makes a row's hidden state decide later rows'
        expert slots, and a row that reads a trash slot back must read the
        same K/V on every run); None for a dense model, whose rows never
        meet, so its writes stay as they are."""
        if not self.cfg.is_moe:
            return None
        return trash_sources(page_ids, offs, self.cache.page_size)

    def _decode_logits(self, tokens, positions, tables, lengths):
        """One decode iteration over the layer stack: per layer, the new
        token's K/V lands in the pools in place, then paged attention reads
        them. Returns (B, V) f32 logits."""
        return self._forward(self._decode_rows(tokens, positions, tables, lengths))

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

    def _decode_args(self, rids: list[int], claim_ahead: list[int] | None = None):
        """Build the padded host args of a decode batch (shared by the plain
        decode step, the fused mixed step and the K-step horizons).

        ``claim_ahead`` (per-rid step counts) grows each block table to
        cover the horizon's writes at positions
        ``[context_len - 1, context_len - 1 + a)`` BEFORE the dispatch —
        the page claim-ahead; ``None`` is the single-step claim."""
        B = len(rids)
        bucket = self._bucket(B)
        for i, r in enumerate(rids):
            req = self.requests[r]
            self.cache.ensure(r, req.context_len if claim_ahead is None
                              else req.context_len - 1 + claim_ahead[i])
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

    def _upload_decode(self, tokens, positions, tables, lengths):
        dev = self.device
        return (to_device(tokens.astype(np.int64), dev), to_device(positions.astype(np.int64), dev),
                to_device(tables, dev), to_device(lengths, dev))

    def _decode_finish(self, rids: list[int], nxt: list[int], dt: float) -> dict[int, int]:
        """Per-request bookkeeping after a decode (or fused) dispatch."""
        out = {}
        for i, r in enumerate(rids):
            req = self.requests[r]
            tok = int(nxt[i])
            self.token_buf[r].append(tok)
            req.generated += 1
            req.decode_time_sum += dt
            out[r] = tok
            if req.done:
                self._finish(r)
        self.stats.decode_tokens += len(rids)
        self.stats.decode_steps += 1
        self.stats.decode_seconds += dt
        return out

    def _finish(self, rid: int) -> None:
        self.requests[rid].phase = Phase.FINISHED
        self.cache.free(rid)
        self.req_sampling.pop(rid, None)

    @torch.inference_mode()
    def _decode_chunk(self, rids: list[int]) -> dict[int, int]:
        t0 = time.perf_counter()
        bucket, _, tokens, positions, tables, lengths = self._decode_args(rids)
        sampling = self._sampling(rids, bucket)
        logits = self._decode_logits(*self._upload_decode(tokens, positions, tables, lengths))
        nxt = self._sample(logits, self._reserve_steps(1), sampling).tolist()  # the one sync
        self.stats.host_syncs += 1
        self.stats.dispatches_by_kind["decode"] += 1
        return self._decode_finish(rids, nxt, time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # multi-step decode horizons (K iterations, one host sync)
    # ------------------------------------------------------------------
    def max_horizon_for(self, rids: list[int], steps: int) -> int:
        """Largest horizon <= ``steps`` whose page claim-ahead fits the free
        pool (the claim is monotone in steps, and the K=1 claim is exactly
        what ``decode_step`` would take, so an admitted batch always gets at
        least 1)."""
        free = self.cache.available_pages
        while steps > 1 and self._claim_need(rids, steps) > free:
            steps -= 1
        return max(steps, 1)

    def _claim_need(self, rids: list[int], k: int) -> int:
        """New pages a K-step claim-ahead of ``rids`` takes."""
        tot = 0
        for r in rids:
            req = self.requests[r]
            a = min(k, max(req.remaining, 1))
            tot += max(0, self.cache.pages_for(req.context_len - 1 + a)
                       - len(self.cache.tables.get(r, ())))
        return tot

    def decode_horizon(self, rids: list[int], steps: int) -> dict[int, list[int]]:
        """Run up to ``steps`` consecutive decode iterations for ``rids`` as
        ONE dispatch: the sampled token of step t feeds step t+1 on the
        device, so only a (steps, B) token block crosses to the host — one
        host sync per horizon instead of one per token. Token-identical to
        ``steps`` serial ``decode_step`` calls (greedy and seeded sampling)
        for a fixed batch. Requests reaching ``max_new_tokens`` mid-horizon
        stop emitting (masked rows). Batches larger than the biggest bucket
        run as multiple bucket-sized horizons. Returns rid -> new tokens."""
        self._check_alive()
        if not rids:
            return {}
        steps = int(steps)
        if steps <= 1:
            return {r: [t] for r, t in self.decode_step(rids).items()}
        out: dict[int, list[int]] = {}
        max_bucket = self.decode_buckets[-1]
        for i in range(0, len(rids), max_bucket):
            out.update(self._horizon_chunk(rids[i: i + max_bucket], steps))
        return out

    def _horizon_args(self, rids: list[int], steps: int):
        """Host args of a K-step horizon over ``rids``: (tokens, positions,
        tables, active), where the pages of every row's active steps are
        claimed ahead and ``active`` holds each row's step budget (0 for
        bucket padding)."""
        ahead = [min(steps, self.requests[r].remaining) for r in rids]
        if min(ahead) < 1:
            raise RuntimeError("decode horizon over a finished request")
        bucket, _, tokens, positions, tables, _ = self._decode_args(rids, claim_ahead=ahead)
        active = np.zeros(bucket, np.int64)
        active[: len(rids)] = ahead
        return tokens.astype(np.int64), positions.astype(np.int64), tables, active

    def _horizon_iterations(self, steps: int, decode, sampling, chunks=None):
        """The eager horizon loop: ``steps`` iterations of ``_forward``. With
        ``decode`` (``_horizon_args``' host arrays), each sampled token is fed
        back and each active row's position advanced on the device; rows past
        their budget write into the trash page 0, keep their position and
        repeat their token. ``chunks`` (one ``_ChunkRows`` per iteration)
        ride along in a mixed horizon. Returns, still on the device and
        flat, the (steps, bucket) decode block followed by the last chunk
        row's sample."""
        first = self._reserve_steps(steps)
        block, bucket = [], 0
        if decode is not None:
            tokens, positions, tables, active = (to_device(a, self.device) for a in decode)
            bucket = tokens.shape[0]
        for t in range(steps):
            d = None
            if decode is not None:
                act = active > t
                d = self._decode_rows(tokens, positions, tables, None, act)
            nxt = self._sample(self._forward(d, None if chunks is None else chunks[t]),
                               first + t, sampling)
            if decode is not None:
                tokens = torch.where(act, nxt[:bucket], tokens)
                positions = torch.where(act, positions + 1, positions)
                block.append(tokens)
        if chunks is not None:
            block.append(nxt[bucket:])
        return torch.cat(block)

    def _horizon_finish(self, rids, flat: list[int], active, steps: int,
                        dt: float) -> tuple[dict, int]:
        """Append each row's active tokens from a flat (steps, bucket) host
        block (``_horizon_iterations``' order)."""
        bucket = active.shape[0]
        out: dict[int, list[int]] = {}
        total = 0
        for i, r in enumerate(rids):
            req = self.requests[r]
            a = int(active[i])
            toks = flat[i: a * bucket: bucket]
            buf = self.token_buf[r]
            for tok in toks:
                buf.append(tok)
            req.generated += a
            # the horizon's wall time amortizes over its steps; a row that
            # exits early is only charged for the steps it ran
            req.decode_time_sum += dt * a / steps
            total += a
            out[r] = toks
            if req.done:
                self._finish(r)
        return out, total

    @torch.inference_mode()
    def _horizon_chunk(self, rids: list[int], steps: int) -> dict[int, list[int]]:
        t0 = time.perf_counter()
        decode = self._horizon_args(rids, steps)
        sampling = self._sampling(rids, decode[0].shape[0])
        flat = self._horizon_iterations(steps, decode, sampling).tolist()  # the ONLY sync
        dt = time.perf_counter() - t0
        out, total = self._horizon_finish(rids, flat, decode[3], steps, dt)
        self.stats.decode_tokens += total
        self.stats.decode_steps += steps
        self.stats.horizon_steps += steps
        self.stats.host_syncs += 1
        self.stats.dispatches_by_kind["horizon"] += 1
        self.stats.decode_seconds += dt
        return out

    # ------------------------------------------------------------------
    # fused mixed prefill/decode step (chunked prefill)
    # ------------------------------------------------------------------
    def mixed_step(self, decode_rids: list[int], prefill_rid: int | None = None,
                   chunk_tokens: int = 0) -> dict[int, int]:
        """One co-located iteration: decode ``decode_rids`` while advancing
        ``prefill_rid``'s chunk-granular prefill by up to ``chunk_tokens``
        prompt tokens, in one dispatch with one host sync. Either side may
        be empty (falls back to plain decode / chunk-only prefill). Returns
        rid -> new token for the decode rids; chunk progress is visible via
        ``prefill_progress`` and the request's phase flip to DECODING once
        the prompt completes."""
        self._check_alive()
        if prefill_rid is None or chunk_tokens <= 0:
            return self.decode_step(decode_rids)
        max_bucket = self.decode_buckets[-1]
        out = self._mixed_dispatch(decode_rids[:max_bucket], prefill_rid, chunk_tokens)
        for i in range(max_bucket, len(decode_rids), max_bucket):
            out.update(self._decode_chunk(decode_rids[i: i + max_bucket]))
        return out

    def _chunk_start(self, prid: int, chunk_tokens: int) -> tuple[ChunkedPrefill, int]:
        """The request's chunked-prefill state (claiming its cached prefix on
        first use) and the size of its next chunk."""
        req = self.requests[prid]
        state = self.chunk_state.get(prid)
        if state is None:
            if prid in self.partial:
                raise RuntimeError("request is already mid layer-granular prefill")
            # direct engine users reach the cache here; the cluster runtime
            # claims earlier (at admission) so planning sees residual work
            self.claim_prefix(prid)
            state = self.chunk_state.get(prid)
        if state is None:
            state = self.chunk_state[prid] = ChunkedPrefill(
                prid, np.asarray(self.token_buf[prid][: req.prompt_len], np.int32))
        c = min(int(chunk_tokens), req.prompt_len - state.done)
        if c < 1:
            raise RuntimeError("prefill already complete")
        req.phase = Phase.PREFILLING
        return state, c

    def _chunk_rows(self, state: ChunkedPrefill, subs: list[int]) -> list["_ChunkRows"]:
        """Device args of consecutive sub-chunks of ``state``'s prompt, one
        per iteration, all at one bucket length and over one padded table
        (the pages must already cover them)."""
        rid, dev = state.rid, self.device
        C = self.pad_chunk(max(subs))
        table = self.cache.tables[rid]
        c_tables = np.zeros(self.pad_pages(len(table)), np.int64)
        c_tables[: len(table)] = table
        K = len(subs)
        toks, pos = np.zeros((K, C), np.int64), np.zeros((K, C), np.int64)
        pages, offs = np.zeros((K, C), np.int64), np.zeros((K, C), np.int64)
        lens = np.zeros(K, np.int32)
        start = state.done
        for i, s in enumerate(subs):
            toks[i, :s] = state.tokens[start: start + s]
            pos[i] = start + np.arange(C)
            pages[i], offs[i] = self.cache.chunk_index(rid, start, s, C)
            lens[i] = start + s
            start += s
        # each sub-chunk is one write, whose slots are known here on the host
        srcs = [self._trash_sources(torch.from_numpy(p), torch.from_numpy(o))
                for p, o in zip(pages, offs)]
        if srcs[0] is not None:
            srcs = to_device(torch.stack(srcs).numpy(), dev)
        toks, pos, pages, offs, lens, tables = (to_device(a, dev) for a in (
            toks, pos, pages, offs, lens, c_tables))
        out, start = [], state.done
        for i, s in enumerate(subs):
            out.append(_ChunkRows(toks[i], pos[i: i + 1], pages[i], offs[i], tables,
                                  start, lens[i: i + 1], s, srcs[i]))
            start += s
        return out

    def _land_chunk(self, prid: int, state: ChunkedPrefill, c: int, tok: int) -> None:
        """Bookkeeping after ``c`` prompt tokens landed; ``tok`` is the chunk
        row's sample, the first generated token if the prompt completed."""
        req = self.requests[prid]
        state.done += c
        req.prefill_tokens_done = state.done
        if state.done < req.prompt_len:
            return
        self.token_buf[prid].append(tok)
        req.generated = 1
        req.phase = Phase.DECODING
        self.stats.prefill_tokens += req.prompt_len
        if self.cache.prefix is not None:
            # publish the full pages into the radix tree (refcount bump per
            # adopted page) so later prompts can reuse them; the partial
            # tail page stays private
            self.cache.prefix.insert(state.tokens.tolist(), self.cache.tables[prid])
        del self.chunk_state[prid]
        if req.done:   # one-output request: finished at prefill
            self._finish(prid)

    @torch.inference_mode()
    def _mixed_dispatch(self, rids: list[int], prid: int,
                        chunk_tokens: int) -> dict[int, int]:
        t0 = time.perf_counter()
        state, c = self._chunk_start(prid, chunk_tokens)
        # pages are claimed chunk by chunk, so a preempted prefill only ever
        # holds capacity for what it has actually landed
        self.cache.ensure(prid, state.done + c)
        (chunk,) = self._chunk_rows(state, [c])
        d, bucket = None, 0
        if rids:
            bucket, _, *args = self._decode_args(rids)
            d = self._decode_rows(*self._upload_decode(*args))
        sampling = self._sampling(rids, bucket + 1, prid)
        nxt = self._sample(self._forward(d, chunk), self._reserve_steps(1),
                           sampling).tolist()   # (bucket + 1,): the one sync
        self.stats.host_syncs += 1
        dt = time.perf_counter() - t0
        out = self._decode_finish(rids, nxt, dt) if rids else {}
        self._land_chunk(prid, state, c, nxt[-1])
        self.stats.prefill_chunks += 1
        self.stats.dispatches_by_kind["mixed" if rids else "prefill"] += 1
        if rids:
            self.stats.mixed_steps += 1
        else:
            self.stats.prefill_seconds += dt
        return out

    # ------------------------------------------------------------------
    # fused mixed horizon (a chunk in K slices + K decode iterations, one sync)
    # ------------------------------------------------------------------
    def max_mixed_horizon_for(self, rids: list[int], prid: int,
                              chunk_tokens: int, steps: int) -> int:
        """Largest horizon <= ``steps`` whose combined page claim-ahead —
        the FULL chunk for ``prid`` plus up to ``steps`` decode tokens per
        resident — fits the free pool. The chunk's claim is set aside
        first (it does not shrink with K: the whole chunk lands inside one
        horizon either way), then K shrinks like ``max_horizon_for``
        against the remainder, so neither side can starve the other."""
        req = self.requests[prid]
        done = req.prefill_tokens_done
        c = min(int(chunk_tokens), req.prompt_len - done)
        chunk_need = max(0, self.cache.pages_for(done + max(c, 1))
                         - len(self.cache.tables.get(prid, ())))
        free = self.cache.available_pages - chunk_need
        steps = min(int(steps), max(c, 1))
        while steps > 1 and self._claim_need(rids, steps) > free:
            steps -= 1
        return max(steps, 1)

    def mixed_horizon(self, decode_rids: list[int],
                      prefill_rid: int | None = None, chunk_tokens: int = 0,
                      steps: int = 1) -> dict[int, list[int]]:
        """Run up to ``steps`` fused mixed iterations as ONE dispatch: per
        iteration a ``split_chunk`` slice of ``prefill_rid``'s pending chunk
        lands in the KV pools while one decode iteration runs for
        ``decode_rids`` with on-device token feedback — K steps, one host
        sync. Token-identical to ``steps`` serial ``mixed_step`` calls over
        the same slices (greedy and seeded sampling, for a fixed batch; rows
        hitting ``max_new_tokens`` mid-horizon stop emitting). Falls back to
        ``decode_horizon`` when no chunk rides and to ``mixed_step`` when
        ``steps <= 1``. Decode rids beyond the biggest bucket run as plain
        decode horizons alongside. Returns rid -> new tokens for the decode
        rids."""
        self._check_alive()
        if prefill_rid is None or chunk_tokens <= 0:
            return self.decode_horizon(decode_rids, steps)
        steps = int(steps)
        if steps <= 1:
            return {r: [t] for r, t in self.mixed_step(
                decode_rids, prefill_rid, chunk_tokens).items()}
        max_bucket = self.decode_buckets[-1]
        out = self._mixed_horizon_dispatch(
            decode_rids[:max_bucket], prefill_rid, chunk_tokens, steps)
        rest = decode_rids[max_bucket:]
        if rest:
            out.update(self.decode_horizon(rest, steps))
        return out

    @torch.inference_mode()
    def _mixed_horizon_dispatch(self, rids: list[int], prid: int,
                                chunk_tokens: int,
                                steps: int) -> dict[int, list[int]]:
        t0 = time.perf_counter()
        state, c = self._chunk_start(prid, chunk_tokens)
        steps = min(steps, c)   # every sub-chunk must carry >= 1 token
        if steps <= 1:
            return {r: [t] for r, t in self._mixed_dispatch(rids, prid, c).items()}
        # the WHOLE chunk is claimed up front; its slices land into it
        # iteration by iteration, each at its own host-side q_offset
        self.cache.ensure(prid, state.done + c)
        chunks = self._chunk_rows(state, split_chunk(c, steps))
        decode, bucket, active = None, 0, np.zeros(0, np.int64)
        if rids:
            decode = self._horizon_args(rids, steps)
            bucket, active = decode[0].shape[0], decode[3]
        sampling = self._sampling(rids, bucket + 1, prid)
        flat = self._horizon_iterations(steps, decode, sampling, chunks).tolist()  # the ONLY sync
        self.stats.host_syncs += 1
        self.stats.dispatches_by_kind["mixed_horizon"] += 1
        dt = time.perf_counter() - t0
        out, total = self._horizon_finish(rids, flat, active, steps, dt)
        # slices all carry >= 1 token and sum to c, so the prompt can only
        # complete at the final iteration: its chunk-row sample is the first
        # generated token
        self._land_chunk(prid, state, c, flat[-1])
        self.stats.prefill_chunks += steps
        if rids:
            self.stats.decode_tokens += total
            self.stats.decode_steps += steps
            self.stats.horizon_steps += steps
            self.stats.mixed_steps += steps
            self.stats.decode_seconds += dt
        else:
            self.stats.prefill_seconds += dt
        return out

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

