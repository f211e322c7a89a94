"""Pool/radix-tree consistency contract, checkable mid-flight.

The contract (documented in kv_pool.py / radix_cache.py):

    refcount(b) == #request tables containing b + (1 if a tree node owns b)
    a block is on the free list  iff  refcount(b) == 0
    block 0 (the garbage block) is never on the free list or in the tree
    no two tree nodes own one physical block
    node.ref == #running requests pinning the node
    partial-tail nodes (key shorter than block_size) are childless

``check_invariants`` raises ``InvariantViolation`` on the first breach.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.serve.kv_pool import PagedKVCache
from repro_torch.serve.radix_cache import RadixCache


class InvariantViolation(AssertionError):
    """The pool/tree bookkeeping contract was broken."""


def _fail(msg: str) -> None:
    raise InvariantViolation(msg)


def check_invariants(pool: PagedKVCache,
                     cache: Optional[RadixCache] = None) -> None:
    """Assert the full refcount/free-list/tree contract. O(blocks + tree);
    meant for tests and benches, not the serving hot path."""
    N = pool.num_blocks
    free = pool._free
    if len(set(free)) != len(free):
        _fail("duplicate free-list entries")
    if 0 in free:
        _fail("garbage block 0 leaked into the free list")
    table_blocks = [b for t in pool._tables.values() for b in t]
    tree_nodes = cache._walk() if cache is not None else []
    tree_blocks = [nd.block for nd in tree_nodes]
    if len(set(tree_blocks)) != len(tree_blocks):
        _fail("two tree nodes own one physical block")
    if 0 in tree_blocks:
        _fail("garbage block 0 owned by a tree node")
    free_set, tree_set = set(free), set(tree_blocks)
    for b in range(1, N + 1):
        rc = pool.refcount(b)
        expect = table_blocks.count(b) + (1 if b in tree_set else 0)
        if rc != expect:
            _fail(f"block {b}: refcount {rc} != tables+tree {expect}")
        if (b in free_set) != (rc == 0):
            _fail(f"block {b}: rc {rc} but free={b in free_set}")
    if pool.stats.blocks_in_use != N - len(free):
        _fail(f"blocks_in_use {pool.stats.blocks_in_use} != "
              f"{N - len(free)}")
    if cache is not None:
        pins = {}
        for nodes in cache._held.values():
            for nd in nodes:
                pins[id(nd)] = pins.get(id(nd), 0) + 1
        for nd in tree_nodes:
            if nd.ref != pins.get(id(nd), 0):
                _fail(f"node {nd!r}: ref {nd.ref} != pins "
                      f"{pins.get(id(nd), 0)}")
            if 0 < len(nd.key) < cache.bs and nd.children:
                _fail("partial tail node has children")


def leaked_blocks(pool: PagedKVCache,
                  cache: Optional[RadixCache] = None) -> int:
    """Blocks neither free nor tree-owned at quiescence (no request
    tables) — must be 0 (the zero-leak gate). With tables still resident
    this counts every block some live request holds, so call it only
    after the engine drained."""
    cached = cache.cached_blocks if cache is not None else 0
    return pool.num_blocks - pool.num_free - cached
