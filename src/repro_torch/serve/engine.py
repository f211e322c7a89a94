"""Serving engines: static-slot batching over a contiguous KV cache, and
continuous batching over the paged KV pool (dense GQA LMs).

``ServeEngine`` is the JAX package's static-slot engine in PyTorch: one
prefill of the whole batch into a contiguous ``(B, max_len)`` cache
(``models/lm.py::lm_prefill``), then one decode step for every row together
(``lm_decode_step`` → ``kernels/flash_decode`` on the card) until each has
``max_new`` tokens. Tokens stay on the device until the run ends.

``ContinuousEngine`` is the JAX package's continuous-batching engine:
per-request admission from a FIFO (``serve/scheduler.py``), KV in
fixed-size physical blocks of a shared pool (``serve/kv_pool.py``), decode
as ONE fused step over the whole running batch through per-request block
tables (``serve/paged_step.py`` → ``kernels/flash_decode_paged``).
Requests join the decode batch in the step of their prefill and leave the
moment they finish; when the pool runs dry, unreferenced prefix-cache
blocks are evicted first and only then is the youngest request preempted
(recomputed later). A radix-tree prefix cache (on by default) shares
prompt-prefix KV blocks between requests. With ``prefill_chunk > 0`` long
prompts prefill in fixed-size chunks through ``kernels/flash_prefill_paged``,
interleaved with decode steps. ``kv_dtype="int8"`` stores K/V as int8 with
per-row scales.

Both engines run on the CUDA card unless ``device`` names another device;
without a card the default raises. Both cast the matrix weights to the
compute dtype once at load (the same numbers the per-use casts give).

In the continuous engine greedy tokens stay on the device between steps: a
request keeps its batch row from admission to eviction, vacated rows idle
as zombies (length 0, garbage block 0), so step N's sampled (B,) vector is
step N+1's input, and token values reach the host only at ``drain()``.
Temperature sampling uses the base-2 softmax and the engine's
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.softermax import softmax_base2
from repro_torch.models.lm import cast_matrix_params, maybe_cast_params
from repro_torch.models.registry import model_fns
from repro_torch.models.schema import tree_map, unstack_layers
from repro_torch.serve.kv_pool import PagedKVCache, PoolStats
from repro_torch.serve.paged_step import (check_paged_support,
                                          paged_decode_step, paged_prefill,
                                          paged_prefill_chunked,
                                          paged_prefill_suffix,
                                          scatter_prefill,
                                          scatter_prefill_offset,
                                          table_width_bucket)
from repro_torch.serve.radix_cache import CacheStats, RadixCache
from repro_torch.serve.scheduler import PREFILL, Request, Scheduler
from repro_torch.utils.device import resolve_device


def sample_tokens(lg: torch.Tensor, generator: torch.Generator,
                  temperature: float, cfg: ModelConfig) -> torch.Tensor:
    """Greedy or temperature sampling over the softermax distribution."""
    lg = lg[:, :cfg.vocab_size]     # drop the vocab padding
    if temperature <= 0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    p = softmax_base2(lg / temperature, fold_log2e=True)
    return torch.multinomial(p, 1, generator=generator)[:, 0].to(torch.int32)


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray           # (B, max_new)
    steps: int


class ServeEngine:
    """Static-slot batch engine (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        params = tree_map(lambda a: a.to(self.device), params)
        if cfg.opt_bf16_params:
            # the reference's rule: leaves of rank >= 2 of the stacked tree
            # (block norm scales included) cast once at load
            params = unstack_layers(maybe_cast_params(params, cfg),
                                    cfg.n_layers)
        else:
            # the per-use casts of the matrices, done once: per layer, so
            # norm scales stay as they are
            params = unstack_layers(params, cfg.n_layers)
            dt = cfg.compute_dtype_
            params = {**cast_matrix_params(
                {k: v for k, v in params.items() if k != "blocks"}, dt),
                "blocks": [cast_matrix_params(bp, dt)
                           for bp in params["blocks"]]}
        self.params = params
        self.max_len = max_len
        self.fns = model_fns(cfg)

    def _prefill(self, tokens: torch.Tensor):
        return self.fns.prefill(self.params, {"tokens": tokens},
                                self.max_len)

    def _decode(self, tokens1: torch.Tensor, cache):
        return self.fns.decode_step(self.params, tokens1, cache)

    def _sample(self, lg: torch.Tensor, generator: torch.Generator,
                temperature: float) -> torch.Tensor:
        return sample_tokens(lg, generator, temperature, self.cfg)

    def generate(self, prompts: np.ndarray, max_new: int,
                 temperature: float = 0.0, seed: int = 0) -> GenerateResult:
        """prompts: (B, S) int32 full-length prompts. Temperature sampling
        draws from one ``torch.Generator`` seeded with ``seed`` (the
        reference splits a JAX key per step)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tokens = torch.as_tensor(np.asarray(prompts, np.int32),
                                 device=self.device)
        lg, cache = self._prefill(tokens)
        tok = self._sample(lg, gen, temperature)
        out = [tok]
        for _ in range(max_new - 1):
            lg, cache = self._decode(tok, cache)
            tok = self._sample(lg, gen, temperature)
            out.append(tok)
        return GenerateResult(torch.stack(out, 1).cpu().numpy(), max_new)


@dataclasses.dataclass
class EngineMetrics:
    steps: int = 0
    decode_steps: int = 0
    prefills: int = 0
    prefill_chunks: int = 0      # chunked-prefill model steps run
    preemptions: int = 0
    tokens_out: int = 0          # tokens sampled (includes later-discarded)
    tokens_discarded: int = 0    # sampled but thrown away by preemption
    wall_s: float = 0.0          # host time inside step() / run()
    peak_blocks: int = 0
    # prefix-cache counters (zero when the cache is disabled)
    prefill_tokens: int = 0      # prompt tokens actually run through prefill
    prefix_hit_tokens: int = 0   # prompt tokens reused from the radix tree
    cow_copies: int = 0          # partial tail blocks copied on write


class ContinuousEngine:
    """Continuous batching + paged KV serving engine (see module
    docstring)."""

    def __init__(self, cfg: ModelConfig, params, *,
                 block_size: int = 16, num_blocks: int = 128,
                 max_batch: int = 8, max_len: int = 512,
                 max_admit_per_step: int = 2, seed: int = 0,
                 prefix_cache: bool = True, evict_policy: str = "lru",
                 prefill_chunk: int = 0, prefill_budget: int = 0,
                 kv_dtype: Optional[str] = None,
                 kv_tile_blocks: int = 1, decode_split_k: int = 1,
                 device=None):
        check_paged_support(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = unstack_layers(cast_matrix_params(
            tree_map(lambda a: a.to(self.device), params),
            cfg.compute_dtype_), cfg.n_layers)
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.max_admit_per_step = max_admit_per_step
        # chunks are rounded up to a block multiple so chunk boundaries and
        # block boundaries line up; 0 = one-shot prefill
        if prefill_chunk < 0 or prefill_budget < 0:
            raise ValueError("prefill_chunk and prefill_budget must be >= 0")
        self.prefill_chunk = (-(-prefill_chunk // block_size) * block_size
                              if prefill_chunk else 0)
        # total chunk tokens dealt per step across requests (0 = no cap;
        # the oldest prefilling request always advances)
        self.prefill_budget = prefill_budget
        # kernel layout knobs: every setting computes the same attention
        if kv_tile_blocks < 1 or decode_split_k < 1:
            raise ValueError(
                f"kv_tile_blocks and decode_split_k must be >= 1, got "
                f"{kv_tile_blocks}/{decode_split_k}")
        self.kv_tile_blocks = kv_tile_blocks
        self.decode_split_k = decode_split_k
        self.pool = PagedKVCache(cfg, num_blocks, block_size,
                                 kv_dtype=kv_dtype or "auto",
                                 device=self.device)
        self.quantized = self.pool.quantized
        self.prefix_cache = (RadixCache(self.pool, evict_policy)
                             if prefix_cache else None)
        self.sched = Scheduler(self.pool, max_batch, max_len,
                               cache=self.prefix_cache)
        self.nb_max = -(-max_len // block_size)
        self.metrics = EngineMetrics()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._rows: List[Optional[Request]] = [None] * max_batch
        self._vec = torch.zeros((max_batch,), dtype=torch.int32,
                                device=self.device)
        self._pending: List = []     # [(device vector, [(req, epoch, row)])]

    # -- public API -------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int,
               temperature: float = 0.0,
               req_id: Optional[int] = None) -> Request:
        """Enqueue one request; returns its (streaming) Request handle."""
        return self.sched.submit(np.asarray(prompt, np.int32), max_new,
                                 temperature, req_id)

    def warmup(self) -> None:
        """Build the kernels and take the first launches out of serving
        latency: one synthetic request through the real submit/step path,
        then ``reset()``. Call before any request is submitted."""
        if self.sched.has_work():
            raise RuntimeError(
                "warmup() must run before any requests are submitted "
                "(its synthetic workload would consume and discard them)")
        plen = min(self.block_size + 1, self.max_len - 2)
        self.submit(np.ones((plen,), np.int32), 2)
        while self.sched.has_work():
            self.step()
        self.reset()

    def reset(self) -> None:
        """Zero every engine-side aggregate coherently (metrics, pool and
        cache stats, scheduler counters, the finished set) and flush the
        prefix-cache tree. Refuses to run with requests in flight."""
        if self.sched.has_work():
            raise RuntimeError("reset() with requests queued or running")
        self.drain()
        self._rows = [None] * self.max_batch
        self._vec = torch.zeros((self.max_batch,), dtype=torch.int32,
                                device=self.device)
        self._pending.clear()
        self.sched.finished.clear()
        self.sched.tokens_discarded = 0
        self.metrics = EngineMetrics()
        if self.prefix_cache is not None:
            self.prefix_cache.reset()
            self.prefix_cache.stats = CacheStats()
        self.pool.stats = PoolStats(self.pool.num_blocks)

    def step(self) -> Dict[int, List[int]]:
        """Advance one iteration: admit + prefill (one chunk per prefilling
        request when chunked prefill is on), join, one fused decode step,
        evict. Returns {req_id: fresh tokens}; greedy tokens normally stay
        on the device until ``drain()``, except that with a prefix cache a
        step on which a request finishes drains the pipeline (the finished
        request's generated tokens are published to the tree)."""
        t0 = time.monotonic()
        events: Dict[int, List[int]] = {}
        self._sync_rows()
        admitted = self.sched.admit(self.max_admit_per_step)
        if self.prefill_chunk:
            for req in self.sched.chunk_schedule(self.prefill_chunk,
                                                 self.prefill_budget):
                self._do_prefill_chunk(req, events)
        else:
            for req in admitted:
                self._do_prefill(req, events)
        self._drain_if_finishing(events)
        self.sched.evict_finished()                # max_new == 1 requests

        before_discard = self.sched.tokens_discarded
        preempted = self.sched.ensure_decode_blocks()
        self.metrics.preemptions += len(preempted)
        self.metrics.tokens_discarded += \
            self.sched.tokens_discarded - before_discard
        self._sync_rows()
        if any(r.state != PREFILL for r in self.sched.running):
            self._do_decode_step(events)
            self._drain_if_finishing(events)
            self.sched.evict_finished()

        self.metrics.steps += 1
        self.metrics.wall_s += time.monotonic() - t0
        self.metrics.peak_blocks = self.pool.stats.peak_in_use
        self.metrics.cow_copies = self.pool.stats.cow_copies
        return events

    def drain(self) -> Dict[int, List[int]]:
        """Materialize every in-flight sampled-token vector into its
        request's ``tokens`` list. Returns {req_id: fresh tokens}."""
        events: Dict[int, List[int]] = {}
        for vec, rows in self._pending:
            arr = vec.cpu().numpy()              # host <-> device sync
            for req, epoch, row in rows:
                if req.epoch == epoch:           # not preempted since
                    tok = int(arr[row])
                    req.tokens.append(tok)
                    events.setdefault(req.req_id, []).append(tok)
        self._pending.clear()
        return events

    def run(self, on_token: Optional[Callable[[int, List[int]], None]] = None
            ) -> Dict[int, Request]:
        """Drive until every submitted request has finished. With
        ``on_token`` the tokens are drained every step for streaming;
        without it the pipeline drains once at the end. ``metrics.wall_s``
        becomes the true wall time of the drive, final drain included."""
        t0 = time.monotonic()
        w0 = self.metrics.wall_s
        while self.sched.has_work():
            events = self.step()
            if on_token:
                for rid, toks in self.drain().items():
                    events.setdefault(rid, []).extend(toks)
                for rid, toks in events.items():
                    on_token(rid, toks)
        self.drain()
        self.metrics.wall_s = w0 + (time.monotonic() - t0)
        return self.pop_finished()

    def pop_finished(self) -> Dict[int, Request]:
        """Return-and-clear the finished set."""
        done = dict(self.sched.finished)
        self.sched.finished.clear()
        return done

    # -- internals --------------------------------------------------------

    def _sync_rows(self) -> None:
        """Vacate rows whose request left the running set (finished or
        preempted); the row idles as a zombie until reassigned."""
        live = {id(r) for r in self.sched.running}
        for i, r in enumerate(self._rows):
            if r is not None and id(r) not in live:
                self._rows[i] = None

    def _scales(self):
        return {"k_scale": self.pool.k_scale, "v_scale": self.pool.v_scale}

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        """A host array on the engine's device. To the card it goes through
        pinned memory without blocking, so building the next step's inputs
        never waits for the card."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _greedy(self, lg: torch.Tensor) -> torch.Tensor:
        return torch.argmax(lg[:, :self.cfg.vocab_size], dim=-1).to(
            torch.int32)

    def _drain_if_finishing(self, events: Dict[int, List[int]]) -> None:
        """With a prefix cache, finished requests publish their generated
        tokens to the tree, which needs the values: drain on the steps
        where something is about to finish."""
        if self.prefix_cache is None or not self._pending:
            return
        if any(r.done for r in self.sched.running):
            for rid, toks in self.drain().items():
                events.setdefault(rid, []).extend(toks)

    def _prefill_full(self, req: Request):
        """Cold prefill: the whole prompt through ``paged_prefill``, K/V
        written block-aligned into the request's (all-fresh) blocks."""
        bs = self.block_size
        plen = req.prompt_len
        Sp = -(-plen // bs) * bs
        tokens = np.zeros((1, Sp), np.int32)
        tokens[0, :plen] = req.prompt
        lg, ks, vs = paged_prefill(self.params, self._tensor(tokens),
                                   self._tensor([plen - 1]), self.cfg,
                                   kv_quantize=self.quantized)
        scatter_prefill(self.pool.k, self.pool.v, ks, vs,
                        self._tensor(self.pool.blocks_of(req.req_id)),
                        **self._scales())
        return lg

    def _prefill_from_offset(self, req: Request, m: int):
        """Prefix-cache hit: only the uncached suffix (positions ``m..``)
        runs; attention reads the shared prefix blocks out of the pool and
        the suffix rows go to per-row (block, offset) targets — the first
        may sit mid-block after a copy-on-write tail. Pad rows go to
        garbage block 0."""
        bs = self.block_size
        plen = req.prompt_len
        sl = plen - m
        Sp = -(-sl // bs) * bs
        tokens = np.zeros((1, Sp), np.int32)
        tokens[0, :sl] = req.prompt[m:]
        table = np.asarray(self.pool.blocks_of(req.req_id), np.int32)
        nb_p = -(-m // bs)               # prefix blocks incl. the COW tail
        pt = np.zeros((1, self._pow2_bucket(nb_p)), np.int32)
        pt[0, :nb_p] = table[:nb_p]
        pos = m + np.arange(Sp)
        blk = np.zeros((Sp,), np.int32)
        off = np.zeros((Sp,), np.int32)
        blk[:sl] = table[pos[:sl] // bs]
        off[:sl] = pos[:sl] % bs
        lg, ks, vs = paged_prefill_suffix(
            self.params, self._tensor(tokens), m, self._tensor([sl - 1]),
            self.pool.k, self.pool.v, self._tensor(pt), self._tensor([m]),
            self.cfg, **self._scales())
        scatter_prefill_offset(self.pool.k, self.pool.v, ks, vs,
                               self._tensor(blk), self._tensor(off),
                               **self._scales())
        return lg

    def _do_prefill(self, req: Request, events: Dict[int, List[int]]) -> None:
        plen = req.prompt_len
        m = req.n_prefix_hit
        lg = self._prefill_from_offset(req, m) if m > 0 else \
            self._prefill_full(req)
        req.n_prefilled = plen
        self.metrics.prefill_tokens += plen - m
        self.metrics.prefix_hit_tokens += m
        self._join_decode(req, lg, events)

    def _do_prefill_chunk(self, req: Request,
                          events: Dict[int, List[int]]) -> None:
        """Advance one prefilling request by one chunk through the
        flash-prefill step; the final chunk's logits seed decoding."""
        bs = self.block_size
        C = self.prefill_chunk
        m, sl = self.sched.next_chunk(req, C)
        if m == req.n_prefix_hit:        # first chunk of this admission
            self.metrics.prefix_hit_tokens += m
        tokens = np.zeros((1, C), np.int32)
        tokens[0, :sl] = req.prompt[m:m + sl]
        table = np.asarray(self.pool.blocks_of(req.req_id), np.int32)
        cover = -(-(m + sl) // bs)       # blocks holding positions < m+sl
        # chunk tables bucket to multiples of the chunk's own block count:
        # the paged_prefill_chunked table contract
        w = table_width_bucket(cover, chunk_blocks=C // bs)
        pt = np.zeros((1, w), np.int32)
        pt[0, :cover] = table[:cover]
        pos = m + np.arange(C)
        blk = np.zeros((C,), np.int32)   # pad rows -> garbage block 0
        off = np.zeros((C,), np.int32)
        blk[:sl] = table[pos[:sl] // bs]
        off[:sl] = pos[:sl] % bs
        lg = paged_prefill_chunked(
            self.params, self._tensor(tokens), m, self._tensor([sl - 1]),
            self.pool.k, self.pool.v, self._tensor(pt), self._tensor(blk),
            self._tensor(off), self.cfg, kv_tile_blocks=self.kv_tile_blocks,
            **self._scales())
        req.n_prefilled = m + sl
        self.metrics.prefill_tokens += sl
        self.metrics.prefill_chunks += 1
        if req.n_prefilled == req.prompt_len:
            self._join_decode(req, lg, events)
        elif self.prefix_cache is not None:
            # publish completed chunks as they land, so a request admitted
            # while this prompt is still mid-prefill gets the longest hit
            self.prefix_cache.insert(req.req_id,
                                     req.prompt[:req.n_prefilled])

    def _join_decode(self, req: Request, lg: torch.Tensor,
                     events: Dict[int, List[int]]) -> None:
        """Prefill completed: publish the prompt to the prefix cache,
        sample the first token, give the request a stable decode row."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.req_id, req.prompt)
        B = self.max_batch
        row = self._rows.index(None)     # guaranteed: running < max_batch
        self._rows[row] = req
        mask = torch.zeros((B,), dtype=torch.bool, device=self.device)
        mask[row] = True
        if req.temperature <= 0:
            greedy = self._greedy(lg)    # stays on device until drained
            self._pending.append((greedy, [(req, req.epoch, 0)]))
            self._vec = torch.where(mask, greedy.expand(B), self._vec)
        else:
            tok = int(sample_tokens(lg, self._gen, req.temperature,
                                    self.cfg)[0])
            req.tokens.append(tok)
            self._vec = torch.where(mask, torch.full_like(self._vec, tok),
                                    self._vec)
            events.setdefault(req.req_id, []).append(tok)
        req.n_generated = 1
        req.state = "decoding"
        req.t_first_token = time.monotonic()
        self.metrics.prefills += 1
        self.metrics.tokens_out += 1

    def _pow2_bucket(self, need: int) -> int:
        return table_width_bucket(need, nb_max=self.nb_max)

    def _table_width(self, occ) -> int:
        """Decode block-table width covering the longest running request."""
        return self._pow2_bucket(
            max(self.pool.n_blocks_of(r.req_id) for _, r in occ))

    def _do_decode_step(self, events: Dict[int, List[int]]) -> None:
        B = self.max_batch
        occ = [(i, r) for i, r in enumerate(self._rows) if r is not None]
        greedy_only = all(r.temperature <= 0 for _, r in occ)
        if greedy_only:
            tokens1 = self._vec          # previous step's vector, on device
        else:
            for rid, toks in self.drain().items():
                events.setdefault(rid, []).extend(toks)
            t1 = np.zeros((B,), np.int32)
            for i, req in occ:
                t1[i] = req.tokens[-1]
            tokens1 = self._tensor(t1)
        lengths = np.zeros((B,), np.int32)
        for i, req in occ:
            lengths[i] = req.n_cached
        w = self._table_width(occ)
        bt = np.zeros((B, w), np.int32)
        bt[[i for i, _ in occ]] = self.pool.table_array(
            [r.req_id for _, r in occ], w)
        lg = paged_decode_step(self.params, tokens1, self.pool.k,
                               self.pool.v, self._tensor(bt),
                               self._tensor(lengths), self.cfg,
                               kv_tile_blocks=self.kv_tile_blocks,
                               decode_split_k=self.decode_split_k,
                               **self._scales())
        greedy = self._greedy(lg)
        if greedy_only:
            self._vec = greedy
            self._pending.append(
                (greedy, [(r, r.epoch, i) for i, r in occ]))
            for _, req in occ:
                req.n_generated += 1
                req.n_cached += 1
        else:
            toks = self._sample_rows(lg, [
                self._rows[i].temperature if self._rows[i] else 0.0
                for i in range(B)], greedy)
            for i, req in occ:
                tok = int(toks[i])
                req.tokens.append(tok)
                req.n_generated += 1
                req.n_cached += 1
                events.setdefault(req.req_id, []).append(tok)
            self._vec = self._tensor(toks)
        self.metrics.decode_steps += 1
        self.metrics.tokens_out += len(occ)

    def _sample_rows(self, lg: torch.Tensor, temps: List[float],
                     greedy_dev: torch.Tensor) -> np.ndarray:
        """Per-row sampling; greedy rows reuse the argmax."""
        greedy = greedy_dev[:len(temps)].cpu().numpy()
        lg = lg[:len(temps), :self.cfg.vocab_size]
        tv = torch.tensor([max(t, 1e-6) for t in temps],
                          dtype=torch.float32, device=lg.device)
        p = softmax_base2(lg / tv[:, None], fold_log2e=True)
        samp = torch.multinomial(p, 1, generator=self._gen)[:, 0]
        samp = samp.cpu().numpy().astype(np.int32)
        return np.where(np.asarray(temps) > 0, samp, greedy)
