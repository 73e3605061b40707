"""Radix prefix cache: the page-granular index behind KV sharing — a
copy of ``hpc_patterns_tpu/memory/prefix_cache.py`` (stdlib and numpy
only; the port imports nothing of the JAX package).

Millions of users means shared system prompts, few-shot templates, and
conversation trees — the hottest KV bytes in the serving arena are the
SAME bytes, prefilled N ways into private pages. This module is the
index that lets the paged arena share them: a radix/trie over admitted
token prompts at PAGE granularity (one node = one full page of prompt
tokens = one pool page id), so admission can longest-prefix-match a
new prompt against everything already resident, map the matched pages
read-only into the new row's table, and prefill only the tail
(``models/serving.py``'s sharing-aware admission;
``models/decode.paged_tail_prefill`` is the compute half).

Design points, each load-bearing:

- **page-aligned nodes**: a node covers exactly ``page_size`` tokens,
  so a match IS a list of pool page ids — no partial-page bookkeeping,
  and the COW rule collapses to "decode never writes a page below the
  prompt's own tail" (docs/prefix_cache.md);
- **rung-keyed chains**: chains are scoped by the ADMISSION RUNG (the
  bucket-ladder length the prompt padded to). Prefix K/V is bitwise
  SUFFIX-independent under causal masking but NOT length-independent —
  GEMMs at different row counts may disagree in ULPs on shared rows
  (JAX measured prefill(32) vs prefill(40), layer-1 K, ~1e-6; cuBLAS
  picks its kernel by the row count) — so
  bytes written by a rung-R prefill are exactly what a same-rung
  reader's private prefill would have written, and nothing else is.
  A cross-rung reader simply misses (and inserts its own chain);
- **refcounts live in the arena, not here**: the cache is a pure host
  index. The serving engine owns page refcounts; the cache reports
  which pages it references and calls back into the arena when nodes
  are evicted. One owner of truth for "is this page free".

The engine-facing surface: :meth:`RadixPrefixCache.match` (longest
cached chain for a prompt; ``touch=False`` is the sizing peek that
leaves LRU stamps alone), :meth:`count_match` (fold an admission's
outcome into the hit/miss observables), :meth:`insert` (extend a
chain with newly prefilled full-prompt pages; stamps the traversed
chain — how an admission marks its chain hot), :meth:`evict` (free
LRU leaf pages under arena pressure — only nodes whose page no row
maps, the refcount-1 rule), :meth:`has_page` / :meth:`pages`
(membership, for the pin-while-shared and swap logic).

Import-light (numpy only): unit-testable without torch, like loadgen.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np


@dataclass
class _Node:
    """One cached page: ``key`` is the page's ``page_size`` tokens
    (canonical int32 little-endian bytes — the child-map key), ``page``
    the pool page id holding its K/V, ``rung`` the admission rung the
    bytes were computed at. Children extend the prompt by one page."""
    key: bytes
    page: int
    rung: int
    parent: "_Node | None"
    children: dict = field(default_factory=dict)
    last_touch: int = 0


class RadixPrefixCache:
    """The radix prefix index over one engine's paged arena."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        #: rung -> root children dict (a virtual root per rung)
        self._roots: dict[int, dict] = {}
        self._page_nodes: dict[int, _Node] = {}
        self._clock = 0
        # admission hit/miss observables, written ONLY by
        # :meth:`count_match` (the engine owns the token-volume
        # counters — serve.prefill_skip_tokens and prefill_skip_frac —
        # so the metric has one owner per layer)
        self.hits = 0
        self.misses = 0

    # -- internals ----------------------------------------------------------

    def _chunks(self, tokens) -> list[bytes]:
        t = np.ascontiguousarray(np.asarray(tokens, np.int32))
        P = self.page_size
        return [t[i * P:(i + 1) * P].tobytes()
                for i in range(len(t) // P)]

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- engine surface -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._page_nodes)

    def pages(self) -> set[int]:
        """Pool page ids this cache currently references (each holds
        one arena refcount)."""
        return set(self._page_nodes)

    def has_page(self, page: int) -> bool:
        return page in self._page_nodes

    def match(self, tokens, rung: int, *, max_pages: int | None = None,
              touch: bool = True) -> list[int]:
        """Longest cached chain for ``tokens`` at ``rung``: the page
        ids of the deepest root-anchored node path whose concatenated
        keys prefix ``tokens``, capped at ``max_pages`` (the engine
        caps at ``(len(tokens) - 1) // page_size`` so the tail always
        keeps the last prompt token — the first-token logits must be
        computed, not looked up). ``touch=True`` stamps the chain's
        LRU clock; the engine's sizing walks pass ``touch=False`` so
        a queued request that never admits cannot keep its chain
        artificially hot and skew eviction against admitting traffic
        (an admission stamps its chain through :meth:`insert`).
        Hit/miss accounting is separate (:meth:`count_match`) for the
        same reason."""
        chunks = self._chunks(tokens)
        if max_pages is not None:
            chunks = chunks[:max_pages]
        node_map = self._roots.get(int(rung), {})
        chain: list[_Node] = []
        for ch in chunks:
            node = node_map.get(ch)
            if node is None:
                break
            chain.append(node)
            node_map = node.children
        if touch:
            now = self._tick()
            for node in chain:
                node.last_touch = now
        return [n.page for n in chain]

    def count_match(self, n_pages: int) -> None:
        """Fold ONE admission's match outcome into the hit/miss
        observables — the engine's admission path walks the trie with
        :meth:`match` for its sizing/reclaim math and calls this only
        when the match actually becomes an admission, so candidates
        that were sized but never admitted don't inflate the hit
        rate. Token-volume accounting (the skip-frac counters) lives
        with the engine, which also sees migration installs."""
        if n_pages:
            self.hits += 1
        else:
            self.misses += 1

    def insert(self, tokens, rung: int, pages: Sequence[int]) -> list[int]:
        """Extend the rung's trie with the chain for ``tokens``:
        ``pages[i]`` holds page ``i``'s K/V. Existing nodes are kept
        (first writer wins — a same-pass duplicate admission's private
        page simply stays private); NEW nodes take a cache reference on
        their page, and the list of newly referenced page ids is
        returned so the ARENA can incref them (refcounts are the
        engine's, module docstring). ``len(pages)`` full pages of
        ``tokens`` must exist."""
        chunks = self._chunks(tokens)[:len(pages)]
        if len(chunks) < len(pages):
            raise ValueError(
                f"insert of {len(pages)} page(s) needs that many full "
                f"pages of tokens, got {len(chunks)}")
        node_map = self._roots.setdefault(int(rung), {})
        parent: _Node | None = None
        new_pages: list[int] = []
        now = self._tick()
        for ch, page in zip(chunks, pages):
            node = node_map.get(ch)
            if node is None:
                node = _Node(key=ch, page=int(page), rung=int(rung),
                             parent=parent, last_touch=now)
                node_map[ch] = node
                self._page_nodes[int(page)] = node
                new_pages.append(int(page))
            node.last_touch = now
            parent = node
            node_map = node.children
        return new_pages

    def evict(self, need_pages: int,
              may_evict: Callable[[int], bool]) -> list[int]:
        """Free up to ``need_pages`` pages by dropping LRU LEAF nodes
        (an interior node anchors its descendants' matches, so chains
        shrink from the tip). Only nodes whose page ``may_evict``
        approves are dropped — the engine passes ``refcount == 1``, so
        a page a resident row still maps (the hottest bytes) is never
        evicted, the shared-pages-are-pinned rule. Returns the
        freed page ids for the arena to decref (which frees them).

        One scan, not one per victim: current leaves heapify by
        (last_touch, page) and a parent enters the pool lazily when
        its last child drops — ``may_evict`` is stable across one call
        (refcounts only move after the arena decrefs the result), so a
        refused node stays refused and is popped exactly once."""
        freed: list[int] = []
        heap = [(n.last_touch, n.page)
                for n in self._page_nodes.values() if not n.children]
        heapq.heapify(heap)
        while heap and len(freed) < need_pages:
            _, page = heapq.heappop(heap)
            node = self._page_nodes.get(page)
            if node is None or node.children or not may_evict(page):
                continue
            parent = node.parent
            self._drop(node)
            freed.append(page)
            if parent is not None and not parent.children \
                    and parent.page in self._page_nodes:
                heapq.heappush(heap, (parent.last_touch, parent.page))
        return freed

    def _drop(self, node: _Node) -> None:
        if node.children:
            raise ValueError("evicting an interior node would orphan "
                             "its descendants' chains")
        siblings = (node.parent.children if node.parent is not None
                    else self._roots.get(node.rung, {}))
        siblings.pop(node.key, None)
        self._page_nodes.pop(node.page, None)

    def release_pages(self, pages: Sequence[int]) -> list[int]:
        """Drop the nodes holding ``pages`` (deepest-first so parents
        only go once their children have), EXCEPT nodes that still
        have cached descendants — those (and their ancestors) stay,
        and their pages stay allocated. Returns the page ids actually
        released (the arena decrefs exactly those). A targeted-release
        helper beside :meth:`clear`: the serving engine itself keeps
        cache references resident across swap-out BY DESIGN (shared
        pages stay in HBM and shareable while a row's private pages
        move — ``_row_swappable``), so nothing calls this on the hot
        path; it is for index surgery under explicit page-set
        invalidation (tests, future whole-tier drains)."""
        want = {int(p) for p in pages}
        released: list[int] = []
        # deepest-first: repeatedly drop childless wanted nodes
        progressed = True
        while progressed:
            progressed = False
            for p in list(want):
                node = self._page_nodes.get(p)
                if node is not None and not node.children:
                    self._drop(node)
                    released.append(p)
                    want.discard(p)
                    progressed = True
                elif node is None:
                    want.discard(p)
        return released

    def clear(self) -> list[int]:
        """Drop every node; returns all referenced pages (the arena
        decrefs them — an engine-teardown / test-drain helper)."""
        pages = sorted(self._page_nodes)
        self._roots.clear()
        self._page_nodes.clear()
        return pages
