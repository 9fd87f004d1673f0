"""Paged KV cache: block allocator + torch page pools (vLLM-style, §2.1).

The pool is a pair of (L, num_pages, page_size, Hkv, hd) arrays; per-request
page lists (block tables) live Python-side in the engine. Non-contiguous
paging is what makes continuous batching + preemption cheap: evicting a
request is just returning its pages to the free list.

Pages are REFCOUNTED: ``BlockAllocator`` tracks owners per page, and a
``RadixPrefixCache`` (block-aligned radix tree keyed on token ids) lets a
new request claim another request's already-computed prefix pages by
bumping refcounts — cross-request KV reuse, sglang-style. Sharing is
copy-on-write by construction: matches are capped below the prompt length
and rounded down to a page boundary, so every position a request writes
(prefill suffix and all decode tokens) lands on pages it owns exclusively;
partial-page tails are recomputed, never shared.

Hot-path note: every pool write is an in-place indexed write
(``index_put_``) into the (L, num_pages, page, Hkv, hd) pools, the port's
counterpart of XLA donation: no write ever copies a pool, and the pools'
``data_ptr()`` never changes for the life of the cache.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels import require_device
from repro_torch.models.config import ModelConfig


def trash_sources(page_ids: torch.Tensor, offs: torch.Tensor, page_size: int) -> torch.Tensor:
    """For the n rows of one indexed pool write, (n,) int64 on their device:
    the row whose K/V each row writes. Rows that land on one slot of the
    trash page 0 all write the last such row's K/V, so the slot holds the
    same values whichever of the colliding writes the device applies last (a
    CUDA indexed write keeps an unspecified one; the CPU's, and the
    reference's, keep the last). Every other row writes its own. No host
    sync."""
    rows = torch.arange(page_ids.shape[0], device=page_ids.device)
    trash = page_ids == 0
    last = torch.full((page_size,), -1, dtype=rows.dtype, device=rows.device)
    last = last.scatter_reduce(0, offs, torch.where(trash, rows, -1), "amax")
    return torch.where(trash, last[offs], rows)


def to_device(a, device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a stream sync: a copy from
    pageable host memory makes PyTorch wait for the stream, so the array goes
    through pinned memory and an asynchronous upload instead (on the CPU the
    array itself is wrapped)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class OutOfPagesError(RuntimeError):
    pass


class DoubleFreeError(RuntimeError):
    """A page was released that the allocator does not consider live —
    double-free, unknown index, or a reserved page. Silently extending the
    free list here (the pre-refcount behaviour) would hand the same page to
    two owners; with shared pages that corrupts a *sibling's* KV."""


class TransferIntegrityError(RuntimeError):
    """A migrated KV payload failed its checksum at the destination."""


def transfer_checksum(k, v) -> float:
    """Order-independent integrity checksum of a KV transfer payload.

    f64 accumulation over both halves, on the tensors' own device — cheap at
    page-pool scale, and any single corrupted value moves the sum, which is
    all the deterministic fault injector's bit-flip model needs. Computed at
    export, verified at import (``verify_transfer``) BEFORE any destination
    state changes."""
    return float(k.double().abs().sum() + v.double().abs().sum())


def verify_transfer(k, v, checksum: float, rtol: float = 1e-9) -> None:
    got = transfer_checksum(k, v)
    if abs(got - checksum) > rtol * max(abs(checksum), 1.0):
        raise TransferIntegrityError(
            f"KV transfer checksum mismatch: expected {checksum!r}, "
            f"got {got!r}")


class BlockAllocator:
    """Refcounted page allocator. ``alloc`` hands out pages at refcount 1;
    ``incref`` lets a second owner (another request's block table, or the
    radix prefix cache) share a page copy-on-write-style; ``free`` is a
    decref — the page returns to the free list only when its LAST owner
    releases it, so no sibling can ever lose a shared page out from under
    itself.

    A ``RadixPrefixCache`` over the allocator (``tree``) is told whenever a
    page's refcount moves between 1 and 2, so that it can keep its page
    counts and eviction order as running indexes (a tree page at 1 is the
    tree's alone). Every owner's ``incref`` and ``free`` goes through here —
    requests' tables and the runtime's page leases alike — so no move is
    missed; ``alloc`` never hands out a tree page, which the tree's own
    reference keeps off the free list."""

    def __init__(self, num_pages: int, reserved: int = 0):
        """``reserved`` low pages are never handed out — page 0 serves as the
        trash page that padded decode-batch rows scatter into."""
        self.num_pages = num_pages
        self.reserved = reserved
        self._free = list(range(num_pages - 1, reserved - 1, -1))
        self._refs = [0] * num_pages
        self.tree: RadixPrefixCache | None = None

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages currently held by >= 1 owner (excludes reserved + free)."""
        return self.num_pages - self.reserved - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPagesError(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def incref(self, pages: list[int]) -> None:
        """Add an owner to already-live pages (prefix-cache claims)."""
        for p in pages:
            if self._refs[p] <= 0:
                raise DoubleFreeError(
                    f"incref on non-live page {p} (refcount "
                    f"{self._refs[p]}): only resident pages can be shared")
            self._refs[p] += 1
            if self._refs[p] == 2 and self.tree is not None:
                self.tree._sharing_changed(p, shared=True)

    def free(self, pages: list[int]) -> None:
        """Drop one owner per page; recycle pages whose refcount hits 0.
        Raises ``DoubleFreeError`` on unknown/reserved/already-free pages
        instead of silently corrupting the free list."""
        for p in pages:
            if not self.reserved <= p < self.num_pages:
                raise DoubleFreeError(
                    f"free of unknown page {p} (valid range "
                    f"[{self.reserved}, {self.num_pages}))")
            if self._refs[p] <= 0:
                raise DoubleFreeError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
            elif self._refs[p] == 1 and self.tree is not None:
                self.tree._sharing_changed(p, shared=False)


class _PrefixNode:
    """One full KV page in the radix tree, keyed by the token ids it holds."""

    __slots__ = ("key", "page", "children", "parent", "stamp")

    def __init__(self, key, page, parent, stamp):
        self.key = key                 # tuple of page_size token ids
        self.page = page               # pool page index (None for the root)
        self.children: dict[tuple, _PrefixNode] = {}
        self.parent = parent
        self.stamp = stamp             # logical LRU clock (deterministic)


class RadixPrefixCache:
    """Block-aligned radix/prefix tree over resident token sequences
    (sglang-style cross-request KV reuse).

    Each node is one FULL page of ``page_size`` token ids, child edges keyed
    by the next page's token tuple — so matching an incoming prompt is a
    dict walk, page by page, and a hit hands back pool pages whose KV bits
    are identical to what a cold prefill would compute (prefix KV depends
    only on token ids + absolute positions, and every pool write is rounded
    through the model dtype). The tree holds its OWN reference on every
    resident page (``BlockAllocator.incref`` at insert), so pages survive
    their computing request and are released only by ``evict``/LRU pressure.
    Partial-page tails are never inserted and never shared — the COW rule:
    any position a request might still write lives on a private page.

    Page accounting is kept as running indexes, not found by walking the
    tree (the runtime asks for ``reclaimable`` many times a round, over
    trees of tens of thousands of pages): a page -> node map, the count of
    tree pages at refcount 1, and two heaps of leaves keyed ``(stamp,
    page)``, unshared and shared, from which ``evict`` takes its victims.
    Heap entries are invalidated lazily: one whose node is gone, has
    children, or carries an old stamp or sharing state is dropped when it
    surfaces (``stale_pops``)."""

    def __init__(self, allocator: BlockAllocator, page_size: int):
        self.allocator = allocator
        allocator.tree = self
        self.page_size = page_size
        self._clock = 0
        # cumulative counters (deterministic; surfaced via runtime summary)
        self.evictions = 0         # tree pages dropped under pool pressure
        self.inserted_pages = 0    # pages adopted into the tree, cumulative
        self.stale_pops = 0        # outdated heap entries evict dropped
        self._reset()

    def _reset(self) -> None:
        self.root = _PrefixNode((), None, None, 0)
        self._nodes: dict[int, _PrefixNode] = {}   # page -> its node
        self._sole = 0                             # tree pages at refcount 1
        self._heaps: tuple[list, list] = ([], [])  # leaves: unshared, shared

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _push(self, node: _PrefixNode) -> None:
        """Enter a leaf in ``evict``'s index under its current stamp and
        sharing. A heap more than twice the tree's size is rebuilt from the
        leaves, so outdated entries cost amortised O(1) and bounded memory."""
        heap = self._heaps[self.allocator.refcount(node.page) > 1]
        heapq.heappush(heap, (node.stamp, node.page))
        if len(heap) > 2 * len(self._nodes) + 64:
            fresh: tuple[list, list] = ([], [])
            for n in self._nodes.values():
                if not n.children:
                    fresh[self.allocator.refcount(n.page) > 1].append((n.stamp, n.page))
            for h in fresh:
                heapq.heapify(h)
            self._heaps = fresh

    def _sharing_changed(self, page: int, shared: bool) -> None:
        """Allocator hook: ``page``'s refcount moved 1 -> 2 (``shared``) or
        2 -> 1. Pages outside the tree are no concern of it."""
        node = self._nodes.get(page)
        if node is None:
            return
        self._sole += -1 if shared else 1
        if not node.children:
            self._push(node)

    @property
    def resident_pages(self) -> int:
        """Pages currently referenced by the tree."""
        return len(self._nodes)

    def reclaimable(self) -> int:
        """Tree pages only the tree still references (refcount == 1) — the
        pages ``evict`` could return to the free list right now."""
        return self._sole

    def match(self, tokens, limit: int | None = None,
              touch: bool = True) -> tuple[list[int], int]:
        """Longest block-aligned cached prefix of ``tokens``.

        Returns (pages, matched_tokens); matching stops at ``limit`` tokens
        (callers pass ``prompt_len - 1`` so at least one suffix token is
        always recomputed — its logits produce the first output token, and
        the suffix then starts exactly on a page boundary). Walked nodes'
        LRU stamps are refreshed unless ``touch=False`` (planning peeks —
        e.g. the gating cost model — must not perturb eviction order). The
        caller must claim the pages (``PagedKVCache.adopt``) before
        anything else can evict them."""
        toks = [int(t) for t in tokens]
        cap = len(toks) if limit is None else min(limit, len(toks))
        pages: list[int] = []
        node, matched = self.root, 0
        while matched + self.page_size <= cap:
            key = tuple(toks[matched: matched + self.page_size])
            child = node.children.get(key)
            if child is None:
                break
            if touch:
                child.stamp = self._tick()
            pages.append(child.page)
            node = child
            matched += self.page_size
        if touch and pages and not node.children:
            self._push(node)
        return pages, matched

    def insert(self, tokens, table: list[int]) -> int:
        """Register a prefilled request's FULL pages in the tree. Pages
        whose prefix path already exists are skipped (the existing copy
        wins — the request keeps its private duplicate, freed with it);
        new nodes take a tree-owned reference (incref) so the KV outlives
        the request. Returns the number of pages adopted."""
        toks = [int(t) for t in tokens]
        node, adopted = self.root, 0
        for i in range(len(toks) // self.page_size):
            key = tuple(toks[i * self.page_size: (i + 1) * self.page_size])
            child = node.children.get(key)
            if child is None:
                # the request's own reference keeps the page shared (off
                # the reclaimable count) until the request lets it go
                page = table[i]
                self.allocator.incref([page])
                child = _PrefixNode(key, page, node, self._tick())
                node.children[key] = child
                self._nodes[page] = child
                adopted += 1
                self.inserted_pages += 1
            else:
                child.stamp = self._tick()
            node = child
        if node is not self.root and not node.children:
            self._push(node)
        return adopted

    def _pop_leaf(self, shared: bool) -> _PrefixNode | None:
        """The least ``(stamp, page)`` leaf of one sharing state, taken off
        its heap (None if it has none)."""
        heap = self._heaps[shared]
        while heap:
            stamp, page = heapq.heappop(heap)
            node = self._nodes.get(page)
            if (node is not None and node.stamp == stamp and not node.children
                    and (self.allocator.refcount(page) > 1) == shared):
                return node
            self.stale_pops += 1
        return None

    def evict(self, need_pages: int) -> int:
        """Drop LRU leaves until ``need_pages`` pages have actually returned
        to the free list (or the tree is empty). Unshared leaves
        (refcount == 1: dropping frees a page NOW) are always preferred;
        a shared leaf is dropped only when no unshared one exists — that
        frees nothing immediately (the sibling request keeps its reference)
        but unblocks the leaf's ancestors for the next pass. Never touches
        a page's other owners: eviction here is a decref, nothing more.
        Victims are the least ``(stamp, page)`` of their kind, in order."""
        freed = 0
        while freed < need_pages:
            victim = self._pop_leaf(shared=False) or self._pop_leaf(shared=True)
            if victim is None:
                break
            was_unshared = self.allocator.refcount(victim.page) == 1
            parent = victim.parent
            del parent.children[victim.key]
            # out of the page map first: leaving the tree is no sharing move
            del self._nodes[victim.page]
            self.allocator.free([victim.page])
            self.evictions += 1
            if was_unshared:
                freed += 1
                self._sole -= 1
            if parent is not self.root and not parent.children:
                self._push(parent)
        return freed

    def clear(self) -> None:
        """Drop the whole tree WITHOUT touching the allocator — the crash
        path, where the engine's pool and bookkeeping are gone wholesale
        (recovery recomputes from the frontend prompt log)."""
        self._reset()

    def release_all(self) -> int:
        """Drop the whole tree and RELEASE the tree's reference on every
        node page — the graceful-drain path, where the allocator stays
        authoritative and must end with zero live pages. Returns the number
        of references released. (Contrast ``clear``, which abandons the
        refcounts because the crashed pool is being discarded wholesale.)"""
        root = self.root
        self.clear()
        released = 0
        stack = list(root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.allocator.free([node.page])
            released += 1
        return released


@dataclass
class PagedKVCache:
    cfg: ModelConfig
    num_pages: int
    page_size: int = 16
    enable_prefix_cache: bool = False
    device: torch.device | str = "cuda"
    k_pool: torch.Tensor = field(init=False)
    v_pool: torch.Tensor = field(init=False)
    allocator: BlockAllocator = field(init=False)
    prefix: RadixPrefixCache | None = field(init=False, default=None)
    tables: dict[int, list[int]] = field(default_factory=dict)
    lengths: dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        cfg = self.cfg
        self.device = require_device(self.device)
        shape = (cfg.num_layers, self.num_pages, self.page_size,
                 cfg.num_kv_heads, cfg.head_dim_)
        # Storage dtype: on a CUDA device the pools store cfg's dtype (bf16)
        # natively. On the CPU they keep the JAX package's rule: f32 storage,
        # with every value ROUNDED through cfg's dtype before it is stored, so
        # the cached bits (and therefore tokens) equal the bf16-pool layout
        # and CPU streams compare with the reference.
        self.value_dtype = cfg.torch_dtype
        if self.device.type == "cpu" and self.value_dtype.itemsize < 4:
            self.storage_dtype = torch.float32
        else:
            self.storage_dtype = self.value_dtype
        self.k_pool = torch.zeros(shape, dtype=self.storage_dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self.storage_dtype, device=self.device)
        self.allocator = BlockAllocator(self.num_pages, reserved=1)
        self.prefix = (RadixPrefixCache(self.allocator, self.page_size)
                       if self.enable_prefix_cache else None)

    def store(self, x):
        """Round through cfg's dtype, then convert to the pools' storage dtype."""
        return x.to(self.value_dtype).to(self.storage_dtype)

    # ------------------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def available_pages(self) -> int:
        """Free pages plus prefix-cache pages reclaimable on demand —
        admission decisions should see both, since ``ensure`` evicts
        unshared tree pages before declaring the pool full."""
        free = self.allocator.free_pages
        if self.prefix is not None:
            free += self.prefix.reclaimable()
        return free

    def ensure(self, rid: int, target_len: int) -> None:
        """Grow rid's block table to cover target_len tokens."""
        table = self.tables.setdefault(rid, [])
        need = self.pages_for(target_len) - len(table)
        if need > 0:
            if need > self.allocator.free_pages and self.prefix is not None:
                # pool pressure: the prefix cache yields LRU unshared pages
                self.prefix.evict(need - self.allocator.free_pages)
            table.extend(self.allocator.alloc(need))
        self.lengths[rid] = target_len

    def adopt(self, rid: int, pages: list[int], matched_tokens: int) -> None:
        """Claim prefix-cache pages for a request: bump each page's
        refcount and seed the block table — a page-table update instead of
        ``matched_tokens`` of prefill compute. The request must not hold
        pages yet (claims happen before its first chunk)."""
        assert rid not in self.tables, f"request {rid} already has pages"
        self.allocator.incref(pages)
        self.tables[rid] = list(pages)
        self.lengths[rid] = matched_tokens

    def free(self, rid: int) -> int:
        """Release all pages of a request (completion or eviction). With
        refcounting this is a decref per page: pages shared with the prefix
        tree (or a sibling's table) stay resident for the other owners."""
        pages = self.tables.pop(rid, [])
        self.allocator.free(pages)
        return self.lengths.pop(rid, 0)

    def can_fit(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.available_pages

    def shared_tokens(self, rid: int) -> int:
        """Tokens of ``rid`` whose pages are shared with another owner —
        evicting the request frees nothing for those, so eviction-victim
        selection should prefer requests with fewer of them."""
        table = self.tables.get(rid)
        if not table:
            return 0
        shared = sum(1 for p in table if self.allocator.refcount(p) > 1)
        return min(shared * self.page_size, self.lengths.get(rid, 0))

    # ------------------------------------------------------------------
    def scatter_index(self, rid: int, S: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(page id, offset) on the pools' device of rid's first S positions."""
        table = to_device(np.asarray(self.tables[rid][: self.pages_for(S)], np.int64),
                          self.device)
        pos = torch.arange(S, device=self.device)
        return table[pos // self.page_size], pos % self.page_size

    def write_prefill_layers(self, rid: int, start_layer: int, k, v,
                             index=None) -> None:
        """Write ``n`` consecutive layers' prefill K/V in place.

        k/v: (n, S, Hkv, hd) — one indexed write per pool. ``index`` is
        ``scatter_index(rid, S)``, computed here when not given."""
        n, S = k.shape[0], k.shape[1]
        page_ids, offs = index if index is not None else self.scatter_index(rid, S)
        idx = (slice(start_layer, start_layer + n), page_ids, offs)
        self.k_pool[idx] = self.store(k)
        self.v_pool[idx] = self.store(v)

    def write_layer(self, li: int, page_ids, offs, k, v, src=None) -> None:
        """Write one layer's K/V rows in place: row i of k/v (n, Hkv, hd)
        lands at (page_ids[i], offs[i]) of layer ``li``. Rows that must not
        touch live state (bucket padding, masked horizon rows, padded chunk
        rows) carry page 0, the reserved trash page. With ``src``
        (``trash_sources``) row i writes row src[i] of k/v instead."""
        if src is not None:
            k, v = k[src], v[src]
        self.k_pool[li, page_ids, offs] = self.store(k)
        self.v_pool[li, page_ids, offs] = self.store(v)

    def chunk_index(self, rid: int, start: int, c: int, C: int) -> tuple[np.ndarray, np.ndarray]:
        """Host (page id, offset) of a prefill chunk's ``C`` bucketed rows at
        positions ``[start, start + C)``: the ``c`` real rows land in rid's
        pages, which must already cover ``start + c`` tokens; the padded rows
        land in the trash page 0."""
        pos = start + np.arange(C)
        table = np.asarray(self.tables[rid], np.int64)
        pages = np.zeros(C, np.int64)
        pages[:c] = table[pos[:c] // self.page_size]
        return pages, pos % self.page_size

    def gather_pages(self, li: int, table) -> tuple[torch.Tensor, torch.Tensor]:
        """One request's pages of layer ``li`` as contiguous K and V in the
        model layout, (1, len(table) * page_size, Hkv, hd): what the chunk
        side's flash attention reads (a gather, never a view of the pool).
        ``table`` is a (cp,) int64 tensor, padded with page 0."""
        shape = (1, -1, *self.k_pool.shape[3:])
        return self.k_pool[li, table].reshape(shape), self.v_pool[li, table].reshape(shape)

    def batch_tables(self, rids: list[int], pad_to: int | None = None) -> np.ndarray:
        """Dense (B, P) int32 table for a decode batch (padded with page 0 —
        masked out by lengths in the attention)."""
        P = pad_to or max(len(self.tables[r]) for r in rids)
        out = np.zeros((len(rids), P), np.int32)
        for i, r in enumerate(rids):
            t = self.tables[r]
            out[i, : len(t)] = t
        return out

    def export_request(self, rid: int) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Gather a request's KV (for migration): (L, n, Hkv, hd) x2 + len,
        on the pools' device."""
        n = self.lengths[rid]
        page_ids, offs = self.scatter_index(rid, n)
        return self.k_pool[:, page_ids, offs], self.v_pool[:, page_ids, offs], n

    def import_request(self, rid: int, k, v, n: int) -> None:
        """Write migrated KV (L, n, Hkv, hd) into freshly allocated pages."""
        self.ensure(rid, n)
        self.write_prefill_layers(rid, 0, k.to(self.device), v.to(self.device))
