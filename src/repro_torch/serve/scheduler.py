"""Continuous-batching scheduler: FIFO admission, join, eviction, preemption.

Request lifecycle:

    QUEUED --admit--> PREFILL --join--> DECODING --evict--> FINISHED
                          ^                 |
                          '---- preempt ----'

``admit`` pops the FIFO while the pool can hold the prompt's blocks and a
decode slot is free; admitted requests prefill and join the running batch at
the *next* step boundary (continuous batching — no waiting for the batch to
drain). ``ensure_decode_blocks`` grows tables when a sequence crosses a block
boundary; if the pool is exhausted it first evicts unreferenced prefix-cache
blocks, then preempts the *youngest* running request (recompute-on-readmit
policy: its blocks are released, its generated tokens are discarded, and it
rejoins the head of the queue), guaranteeing the oldest requests always make
progress.

With a ``RadixCache`` attached, admission charges a request only for the
*uncached* part of its trajectory — the matched prefix is spliced out of the
tree by reference — and cache-evictable blocks count toward the admission
budget. On finish/preempt the request's prompt blocks are released back to
the tree (they were published to it right after prefill) instead of being
freed outright; on finish the *generated* tokens whose values the engine
has drained are published too, so a follow-up turn that extends the whole
conversation (prompt + reply) readmits as a near-full cache hit.

**Chunked prefill.** When the engine runs with a prefill chunk size, an
admitted request stays in PREFILL across several steps: ``next_chunk``
deals out fixed-size chunks of the uncached prompt remainder (the last one
ragged), the engine computes/scatters one chunk per request per step, and
``prefilling`` lists the requests mid-prefill. Block accounting is
unchanged — admission already allocated the whole prompt's blocks — but
``ensure_decode_blocks`` must not grow tables for requests that are still
prefilling (their ``n_cached`` counts scattered prompt rows, not decode
growth).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, TYPE_CHECKING

import numpy as np

from repro_torch.serve.kv_pool import PagedKVCache, PoolExhausted

if TYPE_CHECKING:   # import cycle: radix_cache uses kv_pool
    from repro_torch.serve.radix_cache import RadixCache

QUEUED, PREFILL, DECODING, FINISHED = "queued", "prefill", "decoding", \
    "finished"


class SubmitError(ValueError):
    """A request was rejected at submission. Subclasses name the reason;
    all stay ``ValueError`` for backward compatibility."""


class EmptyPromptError(SubmitError):
    """Prompt has zero tokens."""


class DuplicateRequestError(SubmitError):
    """The request id is already queued, running, or finished."""


class CapacityExceededError(SubmitError):
    """The trajectory cannot fit this engine: prompt + max_new exceeds
    ``max_len``, or needs more blocks than the whole pool
    (``token_capacity``)."""


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray               # (S,) int32
    max_new: int
    temperature: float = 0.0
    state: str = QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    n_generated: int = 0             # tokens sampled (≥ len(tokens): the
                                     # engine materializes values lazily)
    n_cached: int = 0                # tokens resident in the paged cache
    n_prefix_hit: int = 0            # prompt tokens reused from the radix
                                     # tree at this admission (prefill skips
                                     # them)
    n_prefilled: int = 0             # prompt tokens resident in the pool
                                     # (cache hit + chunks computed so far;
                                     # == prompt_len once prefill completes)
    epoch: int = 0                   # bumped on preemption: stale in-flight
                                     # token vectors are discarded by epoch
    # lifecycle stamps (time.monotonic)
    t_submit: float = 0.0
    t_first_token: float = 0.0      # dispatch of the first token
    t_finish: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.n_generated >= self.max_new

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_submit

    @property
    def latency(self) -> float:
        return self.t_finish - self.t_submit


class Scheduler:
    """Owns the admission queue and the running set; mutates pool metadata.

    The engine calls, per step: ``admit()`` → prefill the returned requests →
    ``ensure_decode_blocks()`` → run the fused decode step over
    ``running``.
    """

    def __init__(self, pool: PagedKVCache, max_batch: int,
                 max_len: int, cache: Optional["RadixCache"] = None):
        self.pool = pool
        self.cache = cache
        self.max_batch = max_batch
        self.max_len = max_len
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_id = 0
        self._reserved: Dict[int, int] = {}   # future growth blocks held
        self.tokens_discarded = 0     # generated tokens thrown away by
        #                               preemption (recomputed on readmit)

    def _outstanding(self) -> int:
        return sum(self._reserved.values())

    # -- submission -------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int,
               temperature: float = 0.0,
               req_id: Optional[int] = None) -> Request:
        """Validate + enqueue. Rejections raise typed ``SubmitError``
        subclasses (all ``ValueError``s) at the front door instead of
        failing late and untyped deep in admission."""
        rid = req_id if req_id is not None else self._next_id
        if isinstance(rid, int):
            self._next_id = max(self._next_id, rid + 1)  # no auto collision
        if max_new < 1:
            raise SubmitError(f"request {rid}: max_new must be >= 1")
        if prompt.ndim != 1:
            raise SubmitError(
                f"request {rid}: prompt must be 1-D, got shape "
                f"{tuple(prompt.shape)}")
        if prompt.shape[0] < 1:
            raise EmptyPromptError(f"request {rid}: empty prompt")
        if rid in self.finished or \
                any(r.req_id == rid for r in self.waiting) or \
                any(r.req_id == rid for r in self.running):
            raise DuplicateRequestError(f"request id {rid} already in use")
        if prompt.shape[0] + max_new > self.max_len:
            raise CapacityExceededError(
                f"request {rid}: prompt {prompt.shape[0]} + max_new "
                f"{max_new} exceeds engine max_len {self.max_len}")
        total = self.pool.blocks_for(prompt.shape[0] + max_new - 1)
        if total > self.pool.num_blocks:
            raise CapacityExceededError(
                f"request {rid}: trajectory needs {total} blocks "
                f"({prompt.shape[0] + max_new - 1} cached tokens) but the "
                f"pool holds {self.pool.num_blocks} blocks "
                f"({self.pool.token_capacity} tokens) — raise num_blocks")
        req = Request(rid, np.asarray(prompt, np.int32), max_new,
                      temperature, t_submit=time.monotonic())
        self.waiting.append(req)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- admission --------------------------------------------------------

    def admit(self, max_n: Optional[int] = None) -> List[Request]:
        """FIFO admission: pop while a slot is free and the pool can hold the
        request's whole trajectory (prompt blocks now + reserved growth for
        its max_new decode tokens). Reserving the trajectory keeps admission
        from over-committing the pool, so preemption is a safety net rather
        than the steady state. ``max_n`` caps admissions per call so prefill
        bursts interleave with decode steps instead of stalling them.

        With a prefix cache, a request is charged only for the blocks its
        matched prefix does NOT cover, and cache-evictable blocks count as
        free (``admit`` evicts them on the spot)."""
        admitted: List[Request] = []
        while self.waiting and len(self.running) < self.max_batch and \
                (max_n is None or len(admitted) < max_n):
            nxt = self.waiting[0]
            plen = nxt.prompt_len
            need = self.pool.blocks_for(plen)
            total = max(need, self.pool.blocks_for(plen + nxt.max_new - 1))
            if self.cache is not None:
                cplan = self.cache.plan(nxt.prompt)
                fresh = total - cplan.n_shared
                budget = self.pool.num_free + cplan.evictable
            else:
                cplan, fresh, budget = None, total, self.pool.num_free
            if budget - self._outstanding() < fresh:
                break        # strict FIFO: don't let short requests overtake
            self.waiting.popleft()
            hit = 0
            if cplan is not None:
                try:
                    hit = self.cache.admit(
                        nxt.req_id, nxt.prompt,
                        ensure_free=fresh + self._outstanding(),
                        plan=cplan)
                except PoolExhausted:     # plan/admit races can't happen in
                    self.waiting.appendleft(nxt)   # this loop; stay safe
                    break
            spliced = self.pool.n_blocks_of(nxt.req_id)   # shared + COW
            if need > spliced:
                self.pool.alloc(nxt.req_id, need - spliced)
            self._reserved[nxt.req_id] = total - need
            nxt.state = PREFILL
            nxt.n_prefix_hit = hit
            nxt.n_prefilled = hit
            nxt.n_cached = plen
            admitted.append(nxt)
            self.running.append(nxt)
        return admitted

    # -- chunked prefill --------------------------------------------------

    @property
    def prefilling(self) -> List[Request]:
        """Running requests still mid-prefill (chunked mode), oldest
        first."""
        return [r for r in self.running if r.state == PREFILL]

    def chunk_schedule(self, chunk_tokens: int,
                       budget: int = 0) -> List[Request]:
        """The prefilling requests to advance this step, oldest first,
        under a total per-step chunk-token ``budget`` (0 = uncapped; the
        engine's ``prefill_budget``). Without a budget every prefilling
        request deals one chunk per step — fine for a few long prompts,
        but a herd of them can make every step mostly prefill. The budget
        caps the *sum* of chunk tokens dealt per step; the oldest
        prefilling request is always scheduled even when its chunk alone
        exceeds the budget, so prefill always makes progress."""
        out: List[Request] = []
        spent = 0
        for req in self.prefilling:
            n = min(chunk_tokens, req.prompt_len - req.n_prefilled)
            if out and budget > 0 and spent + n > budget:
                break
            out.append(req)
            spent += n
        return out

    def next_chunk(self, req: Request, chunk_tokens: int):
        """Deal the next prefill chunk of ``req``: returns ``(start, n)``
        token coordinates into the prompt (``start`` = first uncached,
        not-yet-computed position; ``n <= chunk_tokens``, ragged only for
        the final chunk). The caller computes + scatters the chunk and
        then advances ``req.n_prefilled`` by ``n``. A PREFILL-state
        request always has uncached tokens left (cache hits are capped at
        ``prompt_len - 1`` and completion flips the state), so ``n >= 1``
        — asserted rather than signalled."""
        start = req.n_prefilled
        n = min(chunk_tokens, req.prompt_len - start)
        assert n > 0, f"request {req.req_id}: no prompt left to prefill"
        return start, n

    # -- decode-time block growth / preemption ----------------------------

    def ensure_decode_blocks(self) -> List[Request]:
        """Grow block tables for sequences at a block boundary, preempting
        the youngest running requests when the pool runs dry. Returns the
        requests preempted this step."""
        preempted: List[Request] = []
        for req in list(self.running):   # admission order = oldest first
            if req not in self.running:
                continue                 # already preempted below
            if req.state != DECODING:
                continue                 # mid-chunked-prefill: the prompt's
                #                          blocks were allocated at admission
            bs = self.pool.block_size
            if req.n_cached % bs != 0:
                continue                 # room in the last block
            if self.pool.n_blocks_of(req.req_id) * bs > req.n_cached:
                continue                 # table already covers the next
                #                          token: a retried call after a
                #                          transient fault must not grow a
                #                          request twice (idempotence)
            while True:
                try:
                    self.pool.append_block(req.req_id)
                    held = self._reserved.get(req.req_id, 0)
                    if held:
                        self._reserved[req.req_id] = held - 1
                    break
                except PoolExhausted:
                    # shed unreferenced cached blocks before sacrificing
                    # running work (cheapest memory in the system)
                    if self.cache is not None and \
                            self.cache.evict_until_free(1):
                        continue
                    if len(self.running) == 1:
                        raise RuntimeError(
                            "pool exhausted and nothing to preempt: "
                            "num_blocks too small for a single request")
                    victim = self.running[-1]   # youngest — may be req
                    self._preempt(victim)
                    preempted.append(victim)
                    if victim is req:
                        break            # req itself went back to the queue
        return preempted

    def _release(self, req: Request) -> int:
        """Give a leaving request's blocks back: through the cache when one
        is attached (prompt prefix stays resident in the tree), straight to
        the pool otherwise."""
        if self.cache is not None:
            return self.cache.release(req.req_id)
        return self.pool.free(req.req_id)

    def _preempt(self, req: Request) -> None:
        """Recompute-on-readmit: the request's generated tokens are
        discarded and its stream restarts from the first token after it is
        readmitted (identical for greedy; may differ for sampled requests).
        Streaming consumers observe the restart; a stream-reset event is a
        follow-up for the features that make preemption reachable. With a
        prefix cache the blocks are released to the tree, so readmission
        usually re-prefills only the last partial block."""
        self._release(req)
        self._reserved.pop(req.req_id, None)
        self.running.remove(req)
        req.state = QUEUED
        self.tokens_discarded += req.n_generated
        req.tokens = []                         # recompute on readmission
        req.n_generated = 0
        req.n_cached = 0
        req.n_prefix_hit = 0
        req.n_prefilled = 0
        req.epoch += 1
        self.waiting.appendleft(req)

    # -- completion -------------------------------------------------------

    def evict_finished(self) -> List[Request]:
        done = [r for r in self.running if r.done]
        for req in done:
            self._publish_generated(req)
            self._release(req)
            self._reserved.pop(req.req_id, None)
            self.running.remove(req)
            req.state = FINISHED
            req.t_finish = time.monotonic()
            self.finished[req.req_id] = req
        return done

    def _publish_generated(self, req: Request) -> None:
        """Multi-turn reuse: before a finished request's blocks go back,
        publish its *generated* tokens to the tree too (the prompt was
        already published at prefill). The KV rows for the first
        ``n_cached - prompt_len`` generated tokens are pool-resident (the
        final sampled token was never fed back), so a follow-up prompt that
        extends [prompt ‖ reply] readmits as a near-full cache hit. Needs
        the token *values*: the engine drains the async pipeline before
        evicting finished requests whenever a cache is attached; if values
        are missing anyway (direct scheduler use), only the already-
        published prompt stays cached."""
        if self.cache is None or req.n_cached <= req.prompt_len:
            return
        n_gen_cached = req.n_cached - req.prompt_len
        if len(req.tokens) < n_gen_cached:
            return                       # values not materialized — skip
        self.cache.insert(req.req_id, np.concatenate(
            [req.prompt, np.asarray(req.tokens[:n_gen_cached], np.int32)]))
