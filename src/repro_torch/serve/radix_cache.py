"""Radix-tree prefix cache over the paged softermax KV block pool.

Softermax's online-normalization decode (PAPER.md §online softmax) makes
attention a pure function of the cached KV blocks, so any prompt prefix that
is already resident in ``PagedKVCache`` can be reused bit-for-bit instead of
re-prefilled. This module indexes the pool with a radix tree keyed on
**block-aligned token chunks**: each tree node owns exactly one physical
block and carries the ``block_size`` token ids whose K/V fill it. A node
whose key is shorter than ``block_size`` is a *partial tail* — a leaf whose
block holds valid K/V only for its first ``len(key)`` rows (rows beyond may
hold the original owner's decode junk; every reader masks by length).

Sharing protocol (SGLang-RadixAttention-style tree + vLLM-style refcounted
blocks):

* ``lookup(tokens)``   — read-only longest-prefix match, capped at
  ``len(tokens) - 1`` so prefill always recomputes at least the final prompt
  token (its logits seed decoding); ``plan(tokens)`` sizes an admission
  from the same match.
* ``admit(req_id, …)`` — pin the matched path (eviction-proof while the
  request runs), evict LRU/FIFO unreferenced blocks until the uncached part
  of the trajectory fits, splice the matched full blocks into the request's
  pool table (+1 ref each), and **copy-on-write** a matched partial tail:
  the cached block is device-copied into a fresh block owned by the request,
  which then keeps writing rows where the copy left off while the cached
  original stays intact for other matches.
* ``insert(req_id, …)`` — called right after prefill scatter: the request's
  full prompt blocks (and its partial prompt tail) are published to the
  tree immediately, so concurrent requests share with in-flight ones —
  no need to wait for the first holder to finish. Chunks already present
  keep the incumbent node; the request's duplicate block simply drops back
  to the free list when the request releases.
* ``release(req_id)``  — finish/preempt: unpin the request's path and drop
  its table references. Blocks owned by the tree stay cached (refcount
  ≥ 1) — this is what "release prefixes back to the tree instead of
  freeing" means — and become evictable once no running request pins them.
* ``evict(n)`` / ``evict_until_free(n)`` — walk childless unpinned nodes
  in LRU (or FIFO insertion) order, dropping their tree reference; a block
  leaves the pool only when its refcount hits zero.
* ``purge(req_id)``    — quarantine: detach every node owning one of the
  request's blocks, with its whole subtree.

All of this is host-side metadata; the only device work is the COW block
copy. Correctness invariant (``serve/invariants.check_invariants``):

    pool.refcount(b) == #request tables containing b + (1 if a tree node
    owns b else 0)   and   a block is on the free list iff refcount == 0.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.serve.kv_pool import PagedKVCache, PoolExhausted

EVICT_POLICIES = ("lru", "fifo")


@dataclasses.dataclass
class CacheStats:
    lookup_tokens: int = 0     # prompt tokens run through lookup/admit
    hit_tokens: int = 0        # prompt tokens served from the tree
    hits: int = 0              # admissions with a non-empty match
    misses: int = 0
    inserts: int = 0           # blocks donated to the tree
    evictions: int = 0         # blocks evicted from the tree
    purged_blocks: int = 0     # nodes dropped by quarantine purges
    # (COW copies are counted once, at the source: PoolStats.cow_copies)

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / max(self.lookup_tokens, 1)


class RadixNode:
    """One cached physical block. ``key`` holds the token ids whose K/V fill
    the block (len == block_size for interior/full nodes; shorter for a
    partial tail leaf, which is never descended through)."""

    __slots__ = ("key", "block", "parent", "children", "ref", "stamp", "seq")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["RadixNode"], seq: int):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], RadixNode] = {}
        self.ref = 0             # running requests pinning this node
        self.stamp = seq         # last touch (LRU priority)
        self.seq = seq           # insertion order (FIFO priority)

    def __repr__(self) -> str:  # debugging aid
        return (f"RadixNode(block={self.block}, len={len(self.key)}, "
                f"ref={self.ref}, children={len(self.children)})")


@dataclasses.dataclass
class MatchResult:
    path: List[RadixNode]              # full-block nodes, root-to-leaf order
    partial: Optional[RadixNode]       # node whose block seeds the COW tail
    tail_tokens: int                   # leading rows of ``partial`` reused
    n_tokens: int                      # total matched tokens

    @property
    def n_full_blocks(self) -> int:
        return len(self.path)


@dataclasses.dataclass
class AdmitPlan:
    hit_tokens: int     # prompt tokens a match would reuse
    n_shared: int       # full blocks spliced by reference
    n_cow: int          # fresh blocks needed for a copy-on-write tail (0/1)
    evictable: int      # cached blocks eviction could shed for this admit
    match: MatchResult  # the underlying match; hand the plan to admit() to
                        # avoid re-walking the tree (valid only while the
                        # tree is unmutated)


class RadixCache:
    def __init__(self, pool: PagedKVCache, evict_policy: str = "lru"):
        if evict_policy not in EVICT_POLICIES:
            raise ValueError(f"evict_policy must be one of {EVICT_POLICIES},"
                             f" got {evict_policy!r}")
        self.pool = pool
        self.bs = pool.block_size
        self.evict_policy = evict_policy
        self.root = RadixNode((), 0, None, 0)
        self._held: Dict[int, List[RadixNode]] = {}   # req_id -> pinned path
        # per-request publish cursor: (deepest full-block node inserted,
        # tokens covered by it). Progressive chunked-prefill publishing
        # calls insert() once per chunk with an ever-longer prefix of the
        # same sequence; resuming from the cursor keeps the total publish
        # work O(prompt) instead of O(prompt^2 / chunk). Cursor nodes are
        # pinned by the same request, so eviction cannot invalidate them;
        # release() drops the cursor with the pins.
        self._cursor: Dict[int, Tuple[RadixNode, int]] = {}
        self._clock = 0
        self.stats = CacheStats()

    # -- clock ------------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch(self, node: RadixNode) -> None:
        node.stamp = self._tick()

    # -- introspection ----------------------------------------------------

    def _walk(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            for ch in nd.children.values():
                out.append(ch)
                stack.append(ch)
        return out

    @property
    def cached_blocks(self) -> int:
        """Physical blocks currently owned by the tree."""
        return len(self._walk())

    def evictable_blocks(self) -> int:
        """Tree blocks reclaimable right now: nodes no running request pins.
        (Pinning refs every node on a request's path, so an unpinned node
        never has a pinned descendant and the whole unpinned frontier can be
        evicted leaf-first.)"""
        return sum(1 for nd in self._walk() if nd.ref == 0)

    # -- matching ---------------------------------------------------------

    def _match(self, tokens: Sequence[int]) -> MatchResult:
        toks = tokens.tolist() if isinstance(tokens, np.ndarray) else \
            [int(t) for t in tokens]
        limit = len(toks) - 1       # always leave >= 1 token to recompute
        node, path, matched = self.root, [], 0
        while matched + self.bs <= limit:
            # a bs-length lookup key can only hit a full-block node:
            # children are keyed by their own (shorter, for partials) keys
            child = node.children.get(tuple(toks[matched:matched + self.bs]))
            if child is None:
                break
            path.append(child)
            node = child
            matched += self.bs
        # Tail: ANY child block (full or partial) whose key shares a leading
        # run with the remaining tokens seeds a copy-on-write tail — the
        # copy's first `run` rows are valid, the request overwrites onward.
        rem = toks[matched:limit]
        best, best_run = None, 0
        for key, child in node.children.items():
            run = 0
            for a, b in zip(key, rem):
                if a != b:
                    break
                run += 1
            if run > best_run:
                best, best_run = child, run
        matched += best_run
        return MatchResult(path, best if best_run else None, best_run,
                           matched)

    def lookup(self, tokens: Sequence[int]) -> int:
        """Read-only longest-prefix match; returns reusable token count."""
        return self._match(tokens).n_tokens

    def plan(self, tokens: Sequence[int]) -> "AdmitPlan":
        """Size an admission without mutating anything: how many tokens a
        match would reuse, how many blocks it would splice by reference,
        whether it needs a copy-on-write tail block, and how many cached
        blocks eviction could shed for it (the matched path excluded —
        ``admit`` pins it)."""
        m = self._match(tokens)
        return AdmitPlan(m.n_tokens, len(m.path),
                         1 if m.partial is not None else 0,
                         self._sheddable(m), m)

    def _sheddable(self, m: MatchResult) -> int:
        matched = {id(nd) for nd in m.path}
        if m.partial is not None:
            matched.add(id(m.partial))
        return sum(1 for nd in self._walk()
                   if nd.ref == 0 and id(nd) not in matched)

    # -- admission --------------------------------------------------------

    def admit(self, req_id: int, tokens: np.ndarray,
              ensure_free: int = 0,
              plan: Optional[AdmitPlan] = None) -> int:
        """Match ``tokens`` against the tree and splice the hit into the
        request's pool table: shared full blocks by reference, a matched
        partial tail by copy-on-write into a fresh block. Evicts unpinned
        cached blocks (policy order) until at least
        ``max(ensure_free, 1-if-COW)`` blocks are free, so the COW
        allocation itself can never fail mid-flight. Pass the ``plan`` this
        admission was sized with (tree unmutated since) to skip re-matching
        and re-walking the tree. Returns the prompt tokens the engine may
        skip at prefill.

        Raises ``PoolExhausted`` — leaving no state behind — if eviction
        cannot reach the free-block target.
        """
        m = plan.match if plan is not None else self._match(tokens)
        target = max(ensure_free, 1 if m.partial is not None else 0)
        # Feasibility first: everything the tree can shed, minus our own
        # matched path (we are about to pin it).
        sheddable = plan.evictable if plan is not None else \
            self._sheddable(m)
        if self.pool.num_free + sheddable < target:
            raise PoolExhausted(
                f"admit req {req_id}: need {target} free "
                f"blocks, have {self.pool.num_free} + {sheddable} evictable")
        # Pin the matched path so eviction cannot take it out from under us.
        held = self._held.setdefault(req_id, [])
        for nd in m.path:
            nd.ref += 1
            self._touch(nd)
            held.append(nd)
        if m.partial is not None:
            m.partial.ref += 1
            self._touch(m.partial)
        try:
            self._ensure_free(target)
        except PoolExhausted:
            for nd in m.path:           # roll the pins back
                nd.ref -= 1
                held.remove(nd)
            if m.partial is not None:
                m.partial.ref -= 1
            if not held:
                self._held.pop(req_id, None)
            raise
        # Splice shared full blocks, then COW the partial tail (cannot
        # fail: the target above reserved its block).
        if m.path:
            self.pool.share(req_id, [nd.block for nd in m.path])
        if m.partial is not None:
            (dst,) = self.pool.alloc(req_id, 1)
            self.pool.copy_block(m.partial.block, dst)
            m.partial.ref -= 1          # copy done; the leaf is free again
        self.stats.lookup_tokens += len(tokens)
        if m.n_tokens:
            self.stats.hits += 1
            self.stats.hit_tokens += m.n_tokens
        else:
            self.stats.misses += 1
        return m.n_tokens

    def _ensure_free(self, target: int) -> None:
        if not self.evict_until_free(target):
            raise PoolExhausted(
                f"prefix cache: cannot evict down to {target} free blocks")

    # -- publication ------------------------------------------------------

    def _promote(self, node: RadixNode, block: int, new_key: Tuple[int, ...]
                 ) -> Optional[RadixNode]:
        """Re-key a child of ``node`` in place: a partial leaf of OURS that
        already owns ``block`` (published before the block filled up) whose
        key is a strict prefix of ``new_key`` — the missing rows have been
        written since (later chunks / generated tokens), so extending the
        key keeps one tree owner per physical block instead of donating a
        duplicate. Returns the promoted node, or None if there is none."""
        for ch in list(node.children.values()):
            if ch.block == block and 0 < len(ch.key) < len(new_key) and \
                    new_key[:len(ch.key)] == ch.key:
                del node.children[ch.key]
                ch.key = new_key
                node.children[new_key] = ch
                return ch
        return None

    def insert(self, req_id: int, tokens: Sequence[int]) -> int:
        """Publish a freshly prefilled request's prompt blocks to the tree
        (full blocks as interior nodes, the partial prompt tail as a leaf)
        and pin its whole path. Chunks already cached keep the incumbent
        node — the request's duplicate block is simply not donated and
        falls back to the free list at release. Returns blocks donated.

        Idempotent under re-insertion of a longer sequence (progressive
        chunked-prefill publishing, generated tokens at finish): a shorter
        partial-tail leaf of the same request is promoted in place rather
        than double-owned, and the walk resumes from this request's
        publish cursor — each call only converts and walks the tokens
        beyond what it already published (callers always pass extensions
        of their own earlier inserts: prefixes of [prompt ‖ reply])."""
        n = len(tokens)
        node, skip = self._cursor.get(req_id, (self.root, 0))
        if skip > n:                     # defensive: never shrink
            node, skip = self.root, 0
        # np fast path: tolist() is C-speed; only the unpublished delta is
        # converted, keeping progressive publishing O(prompt) overall
        tail_toks = tokens[skip:]
        toks = tail_toks.tolist() if isinstance(tail_toks, np.ndarray) \
            else [int(t) for t in tail_toks]
        table = self.pool.blocks_of(req_id)
        held = self._held.setdefault(req_id, [])
        held_ids: Set[int] = {id(nd) for nd in held}
        donated = 0
        n_full = n // self.bs
        skip_full = skip // self.bs      # cursor is always block-aligned
        for i in range(skip_full, n_full):
            chunk = tuple(toks[i * self.bs - skip:(i + 1) * self.bs - skip])
            child = node.children.get(chunk)
            if child is None:
                child = self._promote(node, table[i], chunk)
            if child is None:
                child = RadixNode(chunk, table[i], node, self._tick())
                node.children[chunk] = child
                self.pool.incref(table[i])
                donated += 1
            self._touch(child)
            if id(child) not in held_ids:
                child.ref += 1
                held.append(child)
                held_ids.add(id(child))
            node = child
        self._cursor[req_id] = (node, n_full * self.bs)
        tail = tuple(toks[n_full * self.bs - skip:])
        if tail:
            # any child (full block or partial) whose key extends the tail
            # already serves these rows — donating ours would cache them
            # twice and waste a pool block
            covered = any(len(ch.key) >= len(tail) and
                          ch.key[:len(tail)] == tail
                          for ch in node.children.values())
            if not covered:
                leaf = self._promote(node, table[n_full], tail)
                if leaf is None:
                    leaf = RadixNode(tail, table[n_full], node, self._tick())
                    node.children[tail] = leaf
                    self.pool.incref(table[n_full])
                    donated += 1
                self._touch(leaf)
                if id(leaf) not in held_ids:
                    leaf.ref += 1
                    held.append(leaf)
                    held_ids.add(id(leaf))
                # drop now-redundant shorter partials nobody is using
                # (housekeeping, not memory pressure: stats.evictions
                # deliberately not bumped)
                for ch in list(node.children.values()):
                    if ch is not leaf and 0 < len(ch.key) < len(tail) and \
                            ch.ref == 0 and not ch.children and \
                            tail[:len(ch.key)] == ch.key:
                        self._drop_node(ch, count_eviction=False)
        self.stats.inserts += donated
        return donated

    # -- release ----------------------------------------------------------

    def release(self, req_id: int) -> int:
        """Finish/preempt: unpin the request's path and drop its table
        references. Cached blocks stay in the tree (and become evictable
        once unpinned); blocks only the request owned return to the free
        list. Returns the number of blocks actually freed."""
        for nd in self._held.pop(req_id, []):
            nd.ref -= 1
        self._cursor.pop(req_id, None)
        return self.pool.free(req_id)

    # -- quarantine -------------------------------------------------------

    def purge(self, req_id: int) -> int:
        """Detach from the tree every node owning one of ``req_id``'s table
        blocks, and the node's whole subtree: descendants extend the
        poisoned prefix, so KV computed attending the bad blocks goes too.
        Detached nodes drop their tree reference (the block frees once no
        table holds it); nodes other requests still pin are detached all
        the same, their pins unwinding at release, but no later admission
        can match them. Returns nodes purged."""
        table = set(self.pool._tables.get(req_id, ()))
        if not table:
            return 0
        purged = 0
        # the topmost poisoned nodes, each subtree dropped post-order
        # (an earlier drop may already have taken a descendant's subtree)
        roots = [nd for nd in self._walk() if nd.block in table]
        for nd in roots:
            if nd.parent is None or \
                    nd.parent.children.get(nd.key) is not nd:
                continue             # already detached with an ancestor
            purged += self._drop_subtree(nd)
        self.stats.purged_blocks += purged
        # a publish cursor may now point into a detached subtree: drop it
        # so a later insert republishes from the root
        live = {id(n) for n in self._walk()}
        live.add(id(self.root))
        for rid, (node, _skip) in list(self._cursor.items()):
            if id(node) not in live:
                self._cursor.pop(rid)
        return purged

    def _drop_subtree(self, nd: RadixNode) -> int:
        """Detach ``nd`` and every descendant, dropping each node's tree
        reference on its block (post-order)."""
        n = 0
        for ch in list(nd.children.values()):
            n += self._drop_subtree(ch)
        del nd.parent.children[nd.key]
        self.pool.decref(nd.block)
        return n + 1

    # -- eviction ---------------------------------------------------------

    def _priority(self, nd: RadixNode) -> int:
        return nd.stamp if self.evict_policy == "lru" else nd.seq

    def _drop_node(self, nd: RadixNode, count_eviction: bool = True) -> None:
        del nd.parent.children[nd.key]
        self.pool.decref(nd.block)
        if count_eviction:
            self.stats.evictions += 1

    def _evict_while(self, keep_going) -> int:
        """Shared eviction walk: pop childless unpinned nodes in policy
        order while ``keep_going()`` is true; parents re-enter the one heap
        as their subtree drains (no per-block tree re-walks)."""
        heap: List[Tuple[int, int, RadixNode]] = []
        tiebreak = 0
        for nd in self._walk():
            if not nd.children and nd.ref == 0:
                heap.append((self._priority(nd), tiebreak := tiebreak + 1,
                             nd))
        heapq.heapify(heap)
        evicted = 0
        while heap and keep_going(evicted):
            _, _, nd = heapq.heappop(heap)
            parent = nd.parent
            self._drop_node(nd)
            evicted += 1
            if parent is not self.root and not parent.children and \
                    parent.ref == 0:
                heapq.heappush(heap, (self._priority(parent),
                                      tiebreak := tiebreak + 1, parent))
        return evicted

    def evict(self, n: int) -> int:
        """Evict up to ``n`` cached blocks (childless, unpinned nodes first,
        in policy order). Returns the number of blocks evicted."""
        return self._evict_while(lambda done: done < n)

    def evict_until_free(self, target: int) -> bool:
        """Evict until the pool has ``target`` free blocks (an evicted
        node's block only frees once no request references it, so this may
        pop several nodes per freed block — one heap, no tree re-walks).
        Returns True when the target was reached."""
        self._evict_while(lambda _done: self.pool.num_free < target)
        return self.pool.num_free >= target

    def reset(self) -> int:
        """Drop the entire tree (requires no pinned paths — i.e. no running
        requests). Used by ``ContinuousEngine.warmup`` to flush the
        synthetic workload's cache entries."""
        if any(self._held.values()):     # empty pin lists are hygiene, not
            #                              running work (admit() can leave
            #                              a req's entry behind with no pins)
            raise RuntimeError("reset() with running requests still pinned")
        self._held.clear()
        self._cursor.clear()
        dropped = 0
        for nd in self._walk():
            self.pool.decref(nd.block)
            dropped += 1
        self.root = RadixNode((), 0, None, 0)
        return dropped
