"""Paged KV cache: a fixed pool of physical blocks + per-request block tables.

The pool owns two device tensors shaped ``(L, num_blocks + 1, Hkv,
block_size, Dh)`` (layer-major inside each block, so one physical block
holds a token span for every layer and the per-request block table is
shared across layers). The serving steps update them **in place**
(``index_put_``) where the JAX package returns new arrays.

**Quantized storage (``kv_dtype="int8"``).** K/V values are stored as
symmetric int8 with one float32 scale per row — per (layer, block, head,
token) — in sibling tensors ``(L, num_blocks + 1, Hkv, block_size)``,
indexed by the same physical block id, so every operation that moves a
block (COW ``copy_block``, sharing, refcounting) carries the scales with
it. Writers quantize rows on scatter; readers dequantize at gather (inside
the CUDA kernels, after the gather in the plain versions) and accumulate
in float32.

**Garbage-block-0 convention.** Physical block 0 is reserved and never
allocated: padding rows of the decode batch, padded table tails and padded
scatter rows all point at block 0, so their writes land somewhere harmless
and their reads are always masked by a length.

Blocks are **reference counted** for the radix prefix cache:

    refcount(b) == (#request tables containing b) + (1 if a tree node owns b)

A block returns to the free list exactly when its refcount reaches zero.
All metadata is host-side Python.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class PoolExhausted(Exception):
    """Raised when an allocation cannot be satisfied; triggers cache
    eviction first and preemption as the last resort."""


@dataclasses.dataclass
class PoolStats:
    num_blocks: int          # usable blocks (excludes the garbage block)
    blocks_in_use: int = 0   # blocks off the free list (refcount >= 1)
    peak_in_use: int = 0
    allocs: int = 0
    frees: int = 0
    # prefix-cache counters
    shared_blocks: int = 0   # blocks with refcount >= 2 right now
    peak_shared: int = 0
    cow_copies: int = 0      # partially-filled tail blocks copied on write

    @property
    def utilization(self) -> float:
        return self.blocks_in_use / max(self.num_blocks, 1)


KV_DTYPES = ("auto", "bf16", "int8")


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int,
                 kv_dtype: str = "auto", *, device):
        from repro_torch.serve.paged_step import check_paged_support
        check_paged_support(cfg)
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                             f"got {kv_dtype!r}")
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        L = cfg.n_layers
        Hkv, Dh = cfg.n_kv_heads, cfg.head_dim_
        dt = self._storage_dtype(cfg, kv_dtype)
        # resolved storage name ("auto" would hide what the pool holds)
        self.kv_dtype = str(dt).replace("torch.", "")
        self.quantized = dt == torch.int8
        # +1: block 0 is the reserved garbage block, never allocated.
        shape = (L, num_blocks + 1, Hkv, block_size, Dh)
        self.k = torch.zeros(shape, dtype=dt, device=device)
        self.v = torch.zeros(shape, dtype=dt, device=device)
        if self.quantized:
            sshape = (L, num_blocks + 1, Hkv, block_size)
            self.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
            self.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
        else:
            self.k_scale = self.v_scale = None
        self._free: List[int] = list(range(1, num_blocks + 1))
        self._tables: Dict[int, List[int]] = {}
        self._ref = np.zeros(num_blocks + 1, np.int32)   # [0] unused
        self.stats = PoolStats(num_blocks)
        # nullable fault-injection hook (serve/faults.py): may raise
        # TransientFault from append_block — BEFORE any state mutates, so
        # the engine's bounded retry re-enters a clean pool
        self.faults = None

    # -- storage sizing ---------------------------------------------------

    @staticmethod
    def _storage_dtype(cfg: ModelConfig, kv_dtype: str) -> torch.dtype:
        if kv_dtype == "int8" or (kv_dtype == "auto" and cfg.opt_int8_kv):
            return torch.int8
        if kv_dtype == "bf16":
            return torch.bfloat16
        return cfg.compute_dtype_

    @staticmethod
    def bytes_per_block(cfg: ModelConfig, block_size: int,
                        kv_dtype: str = "auto") -> int:
        """Device bytes ONE usable block costs across all layers (K + V,
        plus the per-row f32 scales when quantized): the unit the
        equal-memory-budget benchmarks size pools in."""
        L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
        dt = PagedKVCache._storage_dtype(cfg, kv_dtype)
        per = 2 * L * Hkv * block_size * Dh * dt.itemsize
        if dt == torch.int8:
            per += 2 * L * Hkv * block_size * 4        # f32 scales
        return per

    @property
    def pools(self):
        """The pool tensors: (k, v) or (k, v, k_scale, v_scale)."""
        if self.quantized:
            return (self.k, self.v, self.k_scale, self.v_scale)
        return (self.k, self.v)

    @property
    def hbm_bytes(self) -> int:
        """Device bytes held by the pool tensors (incl. block 0)."""
        return sum(t.numel() * t.element_size() for t in self.pools)

    @property
    def token_capacity(self) -> int:
        return self.num_blocks * self.block_size

    # -- refcounts --------------------------------------------------------

    def _incref(self, b: int) -> None:
        self._ref[b] += 1
        if self._ref[b] == 2:
            self.stats.shared_blocks += 1
            self.stats.peak_shared = max(self.stats.peak_shared,
                                         self.stats.shared_blocks)

    def _decref(self, b: int) -> None:
        if self._ref[b] <= 0:
            raise ValueError(f"block {b}: refcount underflow (double free)")
        self._ref[b] -= 1
        if self._ref[b] == 1:
            self.stats.shared_blocks -= 1
        elif self._ref[b] == 0:
            self._free.append(b)
            self.stats.blocks_in_use -= 1
            self.stats.frees += 1

    def incref(self, b: int) -> None:
        """Take a tree-ownership reference on an already-resident block."""
        if self._ref[b] < 1:
            raise ValueError(f"block {b} is not resident; cannot incref")
        self._incref(b)

    def decref(self, b: int) -> None:
        """Drop a tree-ownership reference (eviction / node removal)."""
        self._decref(b)

    def refcount(self, b: int) -> int:
        return int(self._ref[b])

    # -- allocation -------------------------------------------------------

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_shared(self) -> int:
        return self.stats.shared_blocks

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def _take_fresh(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(f"need {n} blocks, {len(self._free)} free")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        self.stats.blocks_in_use += n
        self.stats.allocs += n
        self.stats.peak_in_use = max(self.stats.peak_in_use,
                                     self.stats.blocks_in_use)
        return blocks

    def alloc(self, req_id: int, n: int) -> List[int]:
        """Append ``n`` fresh blocks (refcount 1) to a request's table, in
        logical order after any spliced prefix blocks."""
        blocks = self._take_fresh(n)
        self._tables.setdefault(req_id, []).extend(blocks)
        return blocks

    def share(self, req_id: int, blocks: Sequence[int]) -> None:
        """Splice already-resident blocks (a matched cache prefix) into a
        request's table; each gains one reference."""
        for b in blocks:
            if self._ref[b] < 1:
                raise ValueError(f"block {b} is not resident; cannot share")
            self._incref(b)
        self._tables.setdefault(req_id, []).extend(blocks)

    def append_block(self, req_id: int) -> int:
        """Grow a request's table by one block (decode crossed a boundary)."""
        if self.faults is not None:
            self.faults.on_append_block(req_id)   # may raise TransientFault
        (b,) = self._take_fresh(1)
        self._tables[req_id].append(b)
        return b

    def free(self, req_id: int) -> int:
        """Drop a finished/preempted request's references; returns the
        number of blocks actually freed. Raises ``ValueError`` on an
        unknown ``req_id`` (a double free is a lifecycle bug)."""
        if req_id not in self._tables:
            raise ValueError(
                f"free: request {req_id} has no block table "
                "(double free, or the request was never allocated)")
        blocks = self._tables.pop(req_id)
        before = len(self._free)
        for b in blocks:
            self._decref(b)
        return len(self._free) - before

    # -- device-side COW --------------------------------------------------

    def copy_block(self, src: int, dst: int) -> None:
        """Copy one physical block's K/V (all layers, and the scales of an
        int8 pool) ``src`` → ``dst`` in place: the copy-on-write step when a
        request extends a partially-filled cached tail block. It runs before
        the request writes its first row into ``dst``."""
        for t in self.pools:
            t[:, dst].copy_(t[:, src])
        self.stats.cow_copies += 1

    def corrupt_block(self, b: int) -> None:
        """Fault injection only: silently corrupt one physical block's K/V
        payload in place (sign-flip every row, all layers) — the model the
        kv_corrupt fault uses for a bad DMA/scatter. Metadata (refcounts,
        tables, scales) is untouched: the corruption is invisible to every
        bookkeeping check and only detectable by reading the data back,
        which is what the guard's readback audit does. An int8 code of
        -128 wraps to itself, as in the JAX package."""
        if b == 0:
            raise ValueError("refusing to corrupt the garbage block")
        self.k[:, b].neg_()
        self.v[:, b].neg_()

    # -- views ------------------------------------------------------------

    def blocks_of(self, req_id: int) -> List[int]:
        return self._tables[req_id]

    def n_blocks_of(self, req_id: int) -> int:
        return len(self._tables.get(req_id, ()))

    def table_array(self, req_ids: Sequence[int], width: int) -> np.ndarray:
        """Padded (len(req_ids), width) int32 block table; pad = block 0."""
        out = np.zeros((len(req_ids), width), np.int32)
        for i, rid in enumerate(req_ids):
            blocks = self._tables.get(rid, ())
            out[i, :len(blocks)] = blocks
        return out

    @property
    def utilization(self) -> float:
        return self.stats.utilization
