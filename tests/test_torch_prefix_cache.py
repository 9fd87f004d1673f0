"""The port's page accounting (``BlockAllocator`` + ``RadixPrefixCache`` +
``PagedKVCache``) against the JAX package's, on the CPU.

The port keeps the tree's reclaimable count and its LRU leaves as running
indexes; the reference finds both by walking the tree. Every call must
return what the reference returns, and every page must come and go in the
same order, so that both hand out the same page ids:

* hypothesis churn over the operations an engine and a runtime make
  (prefill = match, adopt, evict under pressure, alloc, insert; ``match``
  with and without ``touch``, alone or as a claim; sibling shares and
  leases through ``incref`` and ``alloc``; ``free``; ``evict(n)``;
  ``release_all``; ``clear``), side
  by side, comparing after every operation ``reclaimable()``,
  ``resident_pages``, ``evict``'s return, every page freed in order (which
  holds ``evict``'s victims), the free list, refcounts and ``evictions``,
  and the running count against a walk of the port's own tree;
* ``PagedKVCache``: ``ensure`` under pool pressure (the tree evicts),
  ``adopt``, ``free``, ``available_pages`` and ``can_fit``, with the same
  tables and page ids;
* a scale guard: reads of ``available_pages`` and an ``evict`` on a tree
  of the qwen2.5-7b cell's pool size finish in time that does not grow
  with the tree.
"""
import copy
import dataclasses
import time

import numpy as np
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.engine import kv_cache as ref_kv
from repro_torch.configs import get_config
from repro_torch.engine import kv_cache as port_kv

PAGE = 2            # tokens a page: short prompts share prefixes often
NUM_PAGES = 24      # pool size (page 0 reserved): the tree runs short of room
ALPHABET = 2       # few distinct pages: prompts meet in the tree


def _tiny(get):
    return dataclasses.replace(get("qwen2.5-7b").reduced(), num_layers=1,
                               num_kv_heads=1, head_dim=8)


def _walk_sole(tree) -> int:
    """Tree pages at refcount 1, by walking every node."""
    n, stack = 0, [tree.root]
    while stack:
        node = stack.pop()
        for ch in node.children.values():
            n += tree.allocator.refcount(ch.page) == 1
            stack.append(ch)
    return n


def _nodes(tree) -> set:
    """(token path, page, stamp) of every node."""
    out, stack = set(), [((), tree.root)]
    while stack:
        path, node = stack.pop()
        for key, ch in node.children.items():
            out.add((path + key, ch.page, ch.stamp))
            stack.append((path + key, ch))
    return out


class _Side:
    """One package's allocator and tree, driven as an engine and a runtime
    drive them, with every ``free`` call recorded in order."""

    def __init__(self, kv):
        self.kv = kv
        self.alloc = kv.BlockAllocator(NUM_PAGES, reserved=1)
        self.tree = kv.RadixPrefixCache(self.alloc, PAGE)
        self.freed: list[int] = []
        free = self.alloc.free

        def recording_free(pages):
            self.freed.extend(pages)
            free(pages)
        self.alloc.free = recording_free

    def prefill(self, tokens):
        """A request's claim and prefill: the table it holds, or None if
        the pool cannot fit it even after eviction (its claim released)."""
        pages, _ = self.tree.match(tokens, limit=len(tokens) - 1)
        self.alloc.incref(pages)
        need = -(-len(tokens) // PAGE) - len(pages)
        if need > self.alloc.free_pages:
            self.tree.evict(need - self.alloc.free_pages)
        if need > self.alloc.free_pages:
            self.alloc.free(pages)
            return None
        table = pages + self.alloc.alloc(need)
        self.tree.insert(tokens, table)
        return table

    def state(self):
        return (self.tree.reclaimable(), self.tree.resident_pages,
                list(self.alloc._free), list(self.alloc._refs),
                self.tree.evictions, list(self.freed), _nodes(self.tree))


_tokens = st.lists(st.integers(0, ALPHABET - 1), min_size=1, max_size=14)
_ops = st.lists(st.one_of(
    st.tuples(st.just("prefill"), _tokens),
    st.tuples(st.just("reinsert"), st.integers(0, 99)),
    st.tuples(st.just("match"), _tokens, st.booleans()),
    st.tuples(st.just("rematch"), st.integers(0, 99), st.booleans()),
    st.tuples(st.just("claim"), _tokens, st.booleans()),
    st.tuples(st.just("incref"), st.integers(0, 99)),
    st.tuples(st.just("free"), st.integers(0, 99)),
    st.tuples(st.just("lease"), st.integers(1, 6)),
    st.tuples(st.just("evict"), st.integers(0, 8)),
    st.tuples(st.just("release_all")),
    st.tuples(st.just("clear")),
), min_size=20, max_size=80)


@given(ops=_ops)
@settings(max_examples=300, deadline=None)
def test_churn_matches_reference_op_by_op(ops):
    port, ref = _Side(port_kv), _Side(ref_kv)
    # owners: (tokens or None, pages), one entry per outstanding reference
    # (a request's table, a sibling's share of it, a runtime lease)
    owners: list[tuple] = []
    for op in ops:
        kind = op[0]
        if kind == "prefill":
            got = port.prefill(op[1])
            assert got == ref.prefill(op[1])
            if got is not None:
                owners.append((op[1], got))
        elif kind == "reinsert":
            reqs = [o for o in owners if o[0] is not None]
            if reqs:
                toks, table = reqs[op[1] % len(reqs)]
                assert port.tree.insert(toks, table) == ref.tree.insert(toks, table)
        elif kind == "match":
            limit = len(op[1]) - 1
            assert (port.tree.match(op[1], limit=limit, touch=op[2])
                    == ref.tree.match(op[1], limit=limit, touch=op[2]))
        elif kind == "rematch":
            # a request's whole prompt again, one token longer: the walk
            # reaches (and with touch restamps) the request's deepest page
            reqs = [o for o in owners if o[0] is not None]
            if reqs:
                toks = reqs[op[1] % len(reqs)][0] + [0]
                assert (port.tree.match(toks, limit=len(toks) - 1, touch=op[2])
                        == ref.tree.match(toks, limit=len(toks) - 1, touch=op[2]))
        elif kind == "claim":
            # a sibling's claim on cached pages, restamped or not
            got = port.tree.match(op[1], touch=op[2])[0]
            assert got == ref.tree.match(op[1], touch=op[2])[0]
            port.alloc.incref(got)
            ref.alloc.incref(got)
            owners.append((None, got))
        elif kind == "incref" and owners:
            pages = owners[op[1] % len(owners)][1]
            port.alloc.incref(pages)
            ref.alloc.incref(pages)
            owners.append((None, list(pages)))
        elif kind == "free" and owners:
            _, pages = owners.pop(op[1] % len(owners))
            port.alloc.free(pages)
            ref.alloc.free(pages)
        elif kind == "lease":
            n = min(op[1], port.alloc.free_pages)
            pages = port.alloc.alloc(n)
            assert pages == ref.alloc.alloc(n)
            owners.append((None, pages))
        elif kind == "evict":
            assert port.tree.evict(op[1]) == ref.tree.evict(op[1])
        elif kind == "release_all":
            assert port.tree.release_all() == ref.tree.release_all()
        elif kind == "clear":
            # the crash path abandons the tree's references for good
            port.tree.clear()
            ref.tree.clear()
        assert port.state() == ref.state()
        assert port.tree.reclaimable() == _walk_sole(port.tree)


def test_victims_follow_stamps_and_sharing():
    """Victims that only a restamp, or a change of sharing without one, puts
    in order: a touched leaf goes after an untouched one; a leaf claimed
    without a touch is shared and waits for the unshared ones; a leaf its
    last sibling releases is unshared again."""
    sides = port, ref = _Side(port_kv), _Side(ref_kv)
    prompts = [[0, 0], [1, 1], [0, 1], [1, 0]]
    leaf = {}
    for side in sides:
        for i, toks in enumerate(prompts):       # one page each, oldest first
            table = side.prefill(toks + [0])
            leaf[i] = table[0]
            side.alloc.free(table)
    claim = {}

    def step(fn, victim=None):
        for side in sides:
            fn(side)
        assert port.state() == ref.state()
        if victim is not None:
            assert port.freed[-1] == leaf[victim]

    step(lambda s: s.tree.match(prompts[0] + [0]))             # 0 restamped
    step(lambda s: s.tree.evict(1), victim=1)
    step(lambda s: claim.update({s: s.tree.match(prompts[2] + [0], touch=False)[0]}))
    step(lambda s: s.alloc.incref(claim[s]))                   # 2 shared
    step(lambda s: s.tree.evict(1), victim=3)
    step(lambda s: s.alloc.free(claim[s]))                     # 2 unshared
    step(lambda s: s.tree.evict(1), victim=2)
    step(lambda s: s.tree.evict(1), victim=0)
    assert port.tree.evictions == 4 and port.tree.resident_pages == 0


def test_outdated_entries_stay_bounded():
    """Leaves restamped again and again leave outdated entries in the
    eviction index; it is rebuilt before they outgrow twice the tree. After
    every restamp, evicting the whole tree (on copies) frees the pages in
    the reference's order."""
    trees = []
    for kv in (port_kv, ref_kv):
        alloc = kv.BlockAllocator(NUM_PAGES, reserved=1)
        tree = kv.RadixPrefixCache(alloc, PAGE)
        for toks in ([0, 0, 0, 0, 0], [1, 1, 0, 0, 0], [0, 1, 1, 1, 0]):
            table = alloc.alloc(3)
            tree.insert(toks, table)
            if toks[:2] == [0, 1]:                  # its leaf stays claimed
                table = table[:1] + table[2:]
            alloc.free(table)
        trees.append(tree)
    port, ref = trees
    prompts = ([0, 0, 0, 0, 0], [0, 1, 1, 1, 0], [1, 1, 0, 0, 0], [1, 1, 1])
    for i in range(300):
        for tree in trees:
            tree.match(prompts[i % 4])
        assert sum(map(len, port._heaps)) <= 2 * (2 * port.resident_pages + 64)
        a, b = copy.deepcopy(port), copy.deepcopy(ref)
        assert a.evict(NUM_PAGES) == b.evict(NUM_PAGES)
        assert a.allocator._free == b.allocator._free and a.evictions == b.evictions == 6


def _caches(num_pages):
    port = port_kv.PagedKVCache(_tiny(get_config), num_pages, page_size=4,
                                enable_prefix_cache=True, device="cpu")
    ref = ref_kv.PagedKVCache(_tiny(jax_get_config), num_pages, page_size=4,
                              enable_prefix_cache=True)
    return port, ref


def test_paged_cache_under_pressure_matches_reference():
    """Requests claim, grow, publish and finish on a pool too small for
    them all: ``ensure`` makes the tree evict, and the tables, page ids and
    page counts stay the reference's at every step."""
    port, ref = _caches(40)
    rng = np.random.default_rng(0)
    stems = [rng.integers(0, 50, 12).tolist() for _ in range(3)]
    live: list[int] = []
    evicted_any = False
    for rid in range(60):
        prompt = stems[rid % 3] + rng.integers(0, 50, int(rng.integers(1, 14))).tolist()
        for c in (port, ref):
            pages, matched = c.prefix.match(prompt, limit=len(prompt) - 1)
            if matched:
                c.adopt(rid, pages, matched)
        total = len(prompt) + int(rng.integers(0, 9))
        assert port.can_fit(total) == ref.can_fit(total)
        assert port.available_pages == ref.available_pages
        while not port.can_fit(total - port.lengths.get(rid, 0)) and live:
            gone = live.pop(0)
            assert port.free(gone) == ref.free(gone)
        if not port.can_fit(total - port.lengths.get(rid, 0)):
            assert port.free(rid) == ref.free(rid)     # drop its claim
            continue
        before = port.prefix.evictions
        for c in (port, ref):
            c.ensure(rid, len(prompt))
            c.prefix.insert(prompt, c.tables[rid])
            c.ensure(rid, total)
        evicted_any |= port.prefix.evictions > before
        live.append(rid)
        if rid % 4 == 3:
            gone = live.pop(int(rng.integers(0, len(live))))
            assert port.free(gone) == ref.free(gone)
        assert port.tables == ref.tables and port.lengths == ref.lengths
        assert port.allocator._free == ref.allocator._free
        assert port.available_pages == ref.available_pages
        assert port.prefix.reclaimable() == _walk_sole(port.prefix)
        assert port.prefix.evictions == ref.prefix.evictions
    assert evicted_any, "the pool never ran short: no eviction was checked"
    for rid in list(live):
        assert port.free(rid) == ref.free(rid)
    assert port.prefix.release_all() == ref.prefix.release_all()
    assert port.allocator.live_pages == ref.allocator.live_pages == 0


def test_page_counts_and_eviction_do_not_walk_the_tree():
    """A tree of the qwen2.5-7b cell's pool (30,300 pages of 16 tokens) of
    distinct prompts, about 70% of its pages held by the tree alone: 10,000
    reads of ``available_pages`` and one ``evict`` of a 3,968-token chunk's
    248 pages take well under 2 s: no read and no victim walks the tree."""
    pages, page_size = 30_300, 16
    cache = port_kv.PagedKVCache(_tiny(get_config), pages + 1, page_size=page_size,
                                 enable_prefix_cache=True, device="cpu")
    rng = np.random.default_rng(0)
    rid = 0
    while cache.allocator.free_pages:
        n = min(int(rng.integers(20, 180)), cache.allocator.free_pages) * page_size
        prompt = rng.integers(0, 150_000, n).tolist()
        cache.ensure(rid, n)
        cache.prefix.insert(prompt, cache.tables[rid])
        if rng.random() < 0.7:
            cache.free(rid)
        rid += 1
    tree = cache.prefix
    assert tree.resident_pages == pages
    assert 0.6 < tree.reclaimable() / pages < 0.8
    reclaimable = tree.reclaimable()
    t0 = time.perf_counter()
    reads = sum(cache.available_pages for _ in range(10_000))
    freed = tree.evict(248)
    took = time.perf_counter() - t0
    assert reads == 10_000 * reclaimable and freed == 248
    assert cache.available_pages == reclaimable
    assert took < 2.0, f"10,000 reads and one evict took {took:.2f} s"
