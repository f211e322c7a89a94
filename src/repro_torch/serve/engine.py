"""Serving engines: static-slot batching over a contiguous KV cache, and
continuous batching over the paged KV pool (dense and MoE GQA LMs).

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
per-row scales. ``autotune="static" | "per-step"`` chooses the decode
kernel's ``(kv_tile_blocks, split_k)`` grid by the modeled cost
(``serve/autotune.py``) once at construction or in every decode step.
``telemetry=Telemetry(...)`` (``serve/telemetry.py``) attaches the
observability hooks: request traces, the step timeline, the kernel-cost
and planner metrics and the int8 numerics monitor. Every stamp comes from
the engine's clock (the telemetry's unless ``clock`` is given) and is a
host dispatch time: no hook waits for the device, except the numerics
probe, which reads its audit's result.

The resilience layer: ``faults=FaultInjector(...)`` (``serve/faults.py``)
injects the plan's faults step by step, ``guard=EngineGuard(...)``
(``serve/guard.py``) drives the degradation ladder and the readback-audit
quarantine, ``deadline_s``/``ttft_budget_s`` cancel overdue requests,
``cancel()`` ends a request mid-prefill or mid-decode, and transient
faults are retried with bounded backoff. The one device read the layer
adds is the readback audit's max logit delta.

Both engines take prompts alone, so both refuse the encoder-decoder family
(whisper), whose prefill reads audio frames: it is served by composing
``model_fns(cfg).prefill`` and ``decode_step``, as the reference's engine
docstring says.

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
from repro_torch.models.registry import check_decoder_only, model_fns
from repro_torch.models.schema import STACKS, tree_map, unstack_layers
from repro_torch.serve.autotune import (AUTOTUNE_MODES, GridPlanner,
                                       default_candidates)
from repro_torch.serve.faults import FAULT_REQ, FaultInjector, TransientFault
from repro_torch.serve.guard import (EngineGuard, EngineSheddingError,
                                     GuardSignals)
from repro_torch.serve.kernel_costs import (decode_launch_cost,
                                            prefill_launch_cost)
from repro_torch.serve.kv_pool import PagedKVCache, PoolStats
from repro_torch.serve.paged_step import (check_paged_support,
                                          paged_decode_step, paged_prefill,
                                          paged_prefill_chunked,
                                          paged_prefill_suffix,
                                          scatter_prefill,
                                          scatter_prefill_offset,
                                          table_width_bucket)
from repro_torch.serve.radix_cache import CacheStats, RadixCache
from repro_torch.serve.scheduler import (FINISH_CANCELLED, FINISH_DEADLINE,
                                         FINISH_QUARANTINED, PREFILL, Request,
                                         Scheduler)
from repro_torch.serve.telemetry import Telemetry
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
        check_decoder_only(cfg, "ServeEngine")
        self.cfg = cfg
        self.device = resolve_device(device)
        params = tree_map(lambda a: a.to(self.device), params)
        if cfg.opt_bf16_params:
            # the reference's rule: leaves of rank >= 2 of the stacked tree
            # (block norm scales included) cast once at load
            params = unstack_layers(maybe_cast_params(params, cfg))
        else:
            # the per-use casts of the matrices, done once: per layer (norm
            # scales stay as they are), each stack by its own length; the
            # leaves the reference reads in fp32 stay fp32
            dt = cfg.compute_dtype_
            params = {k: [cast_matrix_params(bp, dt) for bp in v]
                      if k in STACKS else cast_matrix_params(v, dt)
                      for k, v in unstack_layers(params).items()}
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
    # pool capacity (constant per engine; int8 pools fit ~2x the tokens of
    # a bf16 pool at equal bytes — see PagedKVCache.bytes_per_block)
    kv_dtype: str = ""           # resolved storage dtype name
    #                              ("float32"/"bfloat16"/"int8")
    pool_token_capacity: int = 0     # num_blocks * block_size
    kv_pool_bytes: int = 0           # device bytes held by the pool tensors
    # prefix-cache counters (zero when the cache is disabled)
    prefill_tokens: int = 0      # prompt tokens actually run through prefill
    prefix_hit_tokens: int = 0   # prompt tokens reused from the radix tree
    cache_evictions: int = 0     # blocks evicted from the tree
    cow_copies: int = 0          # partial tail blocks copied on write
    shared_blocks_peak: int = 0  # peak blocks referenced by >1 owner
    # resilience counters (zero when faults/guard/deadlines are off)
    cancelled: int = 0           # client cancellations honored
    deadline_misses: int = 0     # requests cancelled on deadline/TTFT breach
    quarantined: int = 0         # requests cancelled by the readback audit
    shed: int = 0                # submissions refused while SHEDDING
    faults_injected: int = 0     # injector firings (mirror of the log)
    transient_retries: int = 0   # TransientFaults absorbed by retry
    readback_audits: int = 0     # scatter-readback integrity audits run

    @property
    def tok_per_s(self) -> float:
        """Delivered-token throughput (discarded work doesn't count)."""
        kept = self.tokens_out - self.tokens_discarded
        return kept / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def prefill_savings(self) -> float:
        """Ratio of prompt tokens submitted to prompt tokens computed —
        the prefix cache's prefill-work reduction (1.0 = no reuse)."""
        total = self.prefill_tokens + self.prefix_hit_tokens
        return total / max(self.prefill_tokens, 1)


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
                 autotune: str = "off", autotune_candidates=None,
                 telemetry: Optional[Telemetry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 faults: Optional[FaultInjector] = None,
                 guard: Optional[EngineGuard] = None,
                 deadline_s: Optional[float] = None,
                 ttft_budget_s: Optional[float] = None,
                 step_fault_retries: int = 3,
                 retry_backoff_s: float = 0.005,
                 device=None):
        check_decoder_only(cfg, "ContinuousEngine")
        check_paged_support(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        # observability is opt-in: with telemetry=None every hook site is
        # one None check. An attached Telemetry shares its clock with the
        # engine and the scheduler (unless ``clock`` overrides), so every
        # lifecycle stamp comes from one source
        self.telemetry = telemetry
        self._clock: Callable[[], float] = clock or (
            telemetry.clock if telemetry is not None else time.monotonic)
        self.params = unstack_layers(cast_matrix_params(
            tree_map(lambda a: a.to(self.device), params),
            cfg.compute_dtype_))
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
        if autotune not in AUTOTUNE_MODES:
            raise ValueError(f"autotune must be one of {AUTOTUNE_MODES}, "
                             f"got {autotune!r}")
        self.autotune = autotune
        self.pool = PagedKVCache(cfg, num_blocks, block_size,
                                 kv_dtype=kv_dtype or "auto",
                                 device=self.device)
        self.quantized = self.pool.quantized
        self.prefix_cache = (RadixCache(self.pool, evict_policy)
                             if prefix_cache else None)
        self.sched = Scheduler(self.pool, max_batch, max_len,
                               cache=self.prefix_cache, clock=self._clock)
        self.nb_max = -(-max_len // block_size)
        # resilience layer (serve/faults.py, serve/guard.py): nullable hooks
        # as the telemetry. The engine's deadline defaults apply to every
        # submit() without its own; TransientFaults are absorbed by bounded
        # exponential retry (step_fault_retries attempts from a
        # retry_backoff_s delay, slept through ManualClock.advance when the
        # clock has it, so fault tests stay deterministic)
        self.guard = guard
        self.default_deadline_s = deadline_s
        self.default_ttft_budget_s = ttft_budget_s
        if step_fault_retries < 0 or retry_backoff_s < 0:
            raise ValueError("step_fault_retries and retry_backoff_s "
                             "must be >= 0")
        self.step_fault_retries = step_fault_retries
        self.retry_backoff_s = retry_backoff_s
        self.faults: Optional[FaultInjector] = None
        self._fault_pressure_blocks = 0   # blocks held under FAULT_REQ
        self._step_logit_err = 0.0        # max audited error this step
        if faults is not None:
            self.attach_faults(faults)
        # kernel grid autotuning (serve/autotune.py): "static" ranks the
        # candidate grids once, here, on the worst-case batch (every row at
        # max_len) and rebinds the knobs; "per-step" re-ranks them from
        # each decode step's lengths vector
        self.planner: Optional[GridPlanner] = None
        if autotune != "off":
            self.planner = GridPlanner(
                autotune_candidates
                or default_candidates(kv_tile_blocks, decode_split_k),
                n_q_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, block_size=block_size,
                kv_dtype=self.pool.kv_dtype,
                registry=telemetry.registry if telemetry else None)
            if autotune == "static":
                dec = self.planner.plan_decode(
                    np.full((max_batch,), max_len, np.int64),
                    table_width_bucket(self.nb_max, nb_max=self.nb_max))
                self.kv_tile_blocks = dec.kv_tile_blocks
                self.decode_split_k = dec.split_k
        # memo of the telemetry's decode LaunchCost: every cost term depends
        # on a row only through len // block_size (the kernel attends
        # len + 1), so keying on that vector is exact
        self._cost_cache: Dict[tuple, object] = {}
        self.metrics = self._fresh_metrics()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._rows: List[Optional[Request]] = [None] * max_batch
        self._vec = torch.zeros((max_batch,), dtype=torch.int32,
                                device=self.device)
        self._pending: List = []     # [(device vector, [(req, epoch, row)])]

    # -- public API -------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int,
               temperature: float = 0.0,
               req_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               ttft_budget_s: Optional[float] = None,
               t_submit: Optional[float] = None,
               ttft_observed: bool = False) -> Request:
        """Enqueue one request; returns its (streaming) Request handle.
        ``deadline_s``/``ttft_budget_s`` override the engine defaults
        (None = the engine's; the engine cancels on breach). While the
        guard is SHEDDING this raises ``EngineSheddingError``, the
        degradation ladder's front door (counted in
        ``requests_shed_total``), with the guard's ``retry_after_steps``
        hint. ``t_submit``/``ttft_observed`` are the fleet-failover
        migration stamps (see ``Scheduler.submit``)."""
        if self.guard is not None and not self.guard.submit_allowed():
            self.metrics.shed += 1
            if self.telemetry is not None:
                self.telemetry.on_shed()
            hint = self.guard.retry_after_steps()
            raise EngineSheddingError(
                "engine is shedding load (guard state: "
                f"{self.guard.state}; reason: {self.guard.last_reason}) — "
                f"retry after >= {hint} clean steps",
                retry_after_steps=hint)
        req = self.sched.submit(
            np.asarray(prompt, np.int32), max_new, temperature, req_id,
            deadline_s=(deadline_s if deadline_s is not None
                        else self.default_deadline_s),
            ttft_budget_s=(ttft_budget_s if ttft_budget_s is not None
                           else self.default_ttft_budget_s),
            t_submit=t_submit, ttft_observed=ttft_observed)
        if self.telemetry is not None:
            self.telemetry.on_submit(req)
        return req

    def cancel(self, req_id: int, reason: str = FINISH_CANCELLED) -> bool:
        """Client cancellation: end a queued or running request, freeing its
        blocks and radix pins mid-prefill or mid-decode. Safe against the
        async pipeline (the epoch bump makes any in-flight token vector
        stale for it). Idempotent: False when the id is not queued or
        running."""
        req = self.sched.cancel(req_id, reason)
        if req is None:
            return False
        self._sync_rows()
        self.metrics.cancelled += 1
        if reason == FINISH_DEADLINE:
            self.metrics.deadline_misses += 1
        if self.telemetry is not None:
            self.telemetry.on_cancel(req, reason)
        return True

    def attach_faults(self, faults: Optional[FaultInjector]) -> None:
        """Thread the fault injector through engine, scheduler and pool (one
        nullable hook each). Attach AFTER ``warmup()``: warmup's synthetic
        steps would otherwise consume the plan's step indices."""
        self.faults = faults
        self.sched.faults = faults
        self.pool.faults = faults

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
        cache stats, scheduler counters, the finished set, any attached
        telemetry) and flush the prefix-cache tree, so a run/reset/run
        sequence reports the second run as a fresh engine would. Refuses to
        run with requests in flight."""
        if self.sched.has_work():
            raise RuntimeError("reset() with requests queued or running")
        self.drain()
        self._rows = [None] * self.max_batch
        self._vec = torch.zeros((self.max_batch,), dtype=torch.int32,
                                device=self.device)
        self._pending.clear()
        self._release_pool_pressure()    # injector-held blocks go back
        if self.faults is not None:
            self.faults.reset()
        if self.guard is not None:
            self.guard.reset()
        self.sched.finished.clear()
        self.sched.n_preemptions = 0
        self.sched.tokens_discarded = 0
        self.metrics = self._fresh_metrics()
        if self.prefix_cache is not None:
            self.prefix_cache.reset()
            self.prefix_cache.stats = CacheStats()
        self.pool.stats = PoolStats(self.pool.num_blocks)
        if self.telemetry is not None:
            self.telemetry.reset()

    def step(self) -> Dict[int, List[int]]:
        """Advance one iteration: admit + prefill (one chunk per prefilling
        request when chunked prefill is on), join, one fused decode step,
        evict. Returns {req_id: fresh tokens}; greedy tokens normally stay
        on the device until ``drain()``, except that with a prefix cache a
        step on which a request finishes drains the pipeline (the finished
        request's generated tokens are published to the tree)."""
        tel = self.telemetry
        inj = self.faults
        t0 = self._clock()
        events: Dict[int, List[int]] = {}
        self._step_logit_err = 0.0
        if inj is not None:
            inj.begin_step(self.metrics.steps, telemetry=tel)
            self._apply_fault_front(inj, tel)
        self._enforce_deadlines()
        self._sync_rows()

        max_admit: Optional[int] = self.max_admit_per_step
        budget = self.prefill_budget
        if self.guard is not None:
            max_admit = self.guard.effective_max_admit(
                max_admit if max_admit is not None else self.max_batch)
            budget = self.guard.effective_prefill_budget(budget)
        admitted = self.sched.admit(max_admit)
        if tel is not None:
            for req in admitted:
                tel.on_admit(req)
        if self.prefill_chunk:
            for req in self.sched.chunk_schedule(self.prefill_chunk,
                                                 budget):
                self._do_prefill_chunk(req, events)
        else:
            for req in admitted:
                self._do_prefill(req, events)
        self._drain_if_finishing(events)
        self._evict_finished(tel)                  # max_new == 1 requests

        before_discard = self.sched.tokens_discarded
        preempted = self._with_retry(self.sched.ensure_decode_blocks)
        self.metrics.preemptions += len(preempted)
        self.metrics.tokens_discarded += \
            self.sched.tokens_discarded - before_discard
        if tel is not None:
            for req in preempted:
                tel.on_preempt(req)
        self._sync_rows()
        if any(r.state != PREFILL for r in self.sched.running):
            self._do_decode_step(events)
            self._drain_if_finishing(events)
            self._evict_finished(tel)

        self.metrics.steps += 1
        if inj is not None:
            self.metrics.faults_injected = inj.faults_injected
        dt = self._clock() - t0
        self.metrics.wall_s += dt
        self.metrics.peak_blocks = self.pool.stats.peak_in_use
        self.metrics.shared_blocks_peak = self.pool.stats.peak_shared
        self.metrics.cow_copies = self.pool.stats.cow_copies
        if self.prefix_cache is not None:
            self.metrics.cache_evictions = self.prefix_cache.stats.evictions
        if self.guard is not None:
            self._observe_guard(dt, tel)
        if tel is not None:
            tel.on_step_end(self, t0, dt)
        return events

    def _evict_finished(self, tel: Optional[Telemetry]) -> None:
        for req in self.sched.evict_finished():
            if tel is not None:
                tel.on_finish(req)

    def _sync_rows(self) -> None:
        """Vacate rows whose request left the running set (finished,
        preempted or cancelled); the row idles as a zombie until
        reassigned."""
        live = {id(r) for r in self.sched.running}
        for i, r in enumerate(self._rows):
            if r is not None and id(r) not in live:
                self._rows[i] = None

    # -- resilience internals (faults / guard / deadlines) ----------------

    def _sleep(self, dt: float) -> None:
        """Clock-aware sleep: a ManualClock advances (deterministic tests),
        a real clock sleeps for real (an injected stall costs wall time)."""
        if dt <= 0:
            return
        adv = getattr(self._clock, "advance", None)
        if adv is not None:
            adv(dt)
        else:
            time.sleep(dt)

    def _with_retry(self, fn):
        """Bounded retry-with-backoff around a step phase that can raise
        ``TransientFault``. The wrapped phases are idempotent
        (``ensure_decode_blocks`` skips requests whose table already grew),
        so re-entry after a partial pass is safe."""
        delay = self.retry_backoff_s
        for attempt in range(self.step_fault_retries + 1):
            try:
                return fn()
            except TransientFault:
                if attempt >= self.step_fault_retries:
                    raise
                self.metrics.transient_retries += 1
                if self.telemetry is not None:
                    self.telemetry.on_retry()
                self._sleep(delay)
                delay *= 2

    def _apply_fault_front(self, inj: FaultInjector, tel) -> None:
        """The injections that hit at the top of a step: pool pressure,
        stalls, preemption storms, and the step-level transient fault."""
        # pool pressure: steal free blocks under the FAULT_REQ sentinel so
        # admission back-off, cache eviction and preemption feel REAL
        # scarcity through their normal paths; released when the window
        # closes (target 0)
        want = inj.pool_pressure_target(self.pool.num_blocks)
        if want > self._fault_pressure_blocks:
            take = min(want - self._fault_pressure_blocks,
                       self.pool.num_free)
            if take > 0:
                self.pool.alloc(FAULT_REQ, take)
                self._fault_pressure_blocks += take
        elif want == 0:
            self._release_pool_pressure()
        stall = inj.stall_seconds()
        if stall > 0:
            self._sleep(stall)
        n_storm = inj.preempt_storm_count()
        if n_storm:
            before_discard = self.sched.tokens_discarded
            victims = self.sched.force_preempt(n_storm)
            self.metrics.preemptions += len(victims)
            self.metrics.tokens_discarded += \
                self.sched.tokens_discarded - before_discard
            if victims:
                inj.record("preempt_storm_victims", step=inj.step_idx,
                           req_ids=[v.req_id for v in victims])
            if tel is not None:
                for v in victims:
                    tel.on_preempt(v)
        self._with_retry(inj.check_step_fault)

    def _release_pool_pressure(self) -> None:
        if self._fault_pressure_blocks > 0:
            self.pool.free(FAULT_REQ)
            self._fault_pressure_blocks = 0

    def _enforce_deadlines(self) -> None:
        """Cancel queued/running requests past their deadline or TTFT
        budget (reason "deadline"; counted in deadline_misses_total)."""
        now = self._clock()
        overdue = [r for r in
                   list(self.sched.waiting) + list(self.sched.running)
                   if (r.deadline_s is not None and
                       now - r.t_submit >= r.deadline_s) or
                      (r.ttft_budget_s is not None and
                       r.t_first_token == 0.0 and
                       now - r.t_submit >= r.ttft_budget_s)]
        for req in overdue:
            self.cancel(req.req_id, FINISH_DEADLINE)

    def _observe_guard(self, dt: float, tel) -> None:
        """Assemble this step's ``GuardSignals`` from the live surfaces and
        advance the degradation ladder."""
        now = self._clock()
        waiting = self.sched.waiting
        queue_wait = max((now - r.t_submit for r in waiting), default=0.0)
        spike = self.faults.numerics_spike() if self.faults is not None \
            else 0.0
        err = max(self._step_logit_err, spike)
        if tel is not None and err > 0:
            tel.registry.gauge(
                "numerics_logit_error",
                "latest probe's max |full - int8| logit delta").set(err)
        sig = GuardSignals(pool_util=self.pool.utilization,
                           logit_error=err,
                           queue_wait=queue_wait,
                           queue_depth=len(waiting),
                           step_seconds=dt)
        change = self.guard.observe(sig, step=self.metrics.steps)
        if change is not None and tel is not None:
            tel.on_guard(*change, step=self.metrics.steps)
        elif tel is not None:
            tel.g_guard_state.set(float(self.guard.level))

    def _quarantine(self, req: Request, err: float) -> None:
        """The audited logit error of ``req``'s freshly written KV exceeded
        the quarantine bound: purge every tree node its blocks back (no
        later prefix hit serves poisoned KV) and cancel the request. Runs
        right after join, before any decode step used the bad state."""
        if self.prefix_cache is not None:
            purged = self.prefix_cache.purge(req.req_id)
        else:
            purged = 0
        self.metrics.quarantined += 1
        if self.faults is not None:
            self.faults.record("quarantine", step=self.faults.step_idx,
                               req_id=req.req_id, logit_error=err,
                               purged_nodes=purged)
        self.cancel(req.req_id, FINISH_QUARANTINED)

    def _corrupt_request_blocks(self, req: Request) -> None:
        """kv_corrupt landing site: sign-flip every block ONLY this request
        owns (refcount 1 — shared prefix blocks belong to other owners and
        the tree; the fault models a bad write of THIS request's fresh
        rows)."""
        blocks = [b for b in self.pool.blocks_of(req.req_id)
                  if self.pool.refcount(b) == 1]
        for b in blocks:
            self.pool.corrupt_block(b)
        self.faults.record("kv_corrupt", step=self.faults.step_idx,
                           req_id=req.req_id, blocks=blocks)
        if self.telemetry is not None:
            self.telemetry.on_fault("kv_corrupt_hit", self.faults.step_idx,
                                    req_id=req.req_id)

    def _readback_audit(self, req: Request, lg: torch.Tensor) -> float:
        """Scatter-readback KV-integrity audit: recompute the final prompt
        token's logits READING the just-written blocks out of the pool (a
        1-token suffix prefill through ``paged_prefill_suffix``: a gather
        plus a dense Softermax, no kernel) and compare them with the
        prefill's own final logits. A clean pool agrees to within rounding
        (and int8 error); corrupted blocks give a large delta. Returns the
        max-abs logit delta (0.0 when the prompt is too short to audit);
        its one host read is the layer's only device sync."""
        m = req.prompt_len - 1
        if m < 1:
            return 0.0
        bs = self.block_size
        tokens = np.zeros((1, bs), np.int32)
        tokens[0, 0] = req.prompt[m]
        table = np.asarray(self.pool.blocks_of(req.req_id), np.int32)
        nb_p = -(-m // bs)
        pt = np.zeros((1, self._pow2_bucket(nb_p)), np.int32)
        pt[0, :nb_p] = table[:nb_p]
        # readback only: the recomputed K/V rows are not written
        lg2, _, _ = paged_prefill_suffix(
            self.params, self._tensor(tokens), m, self._tensor([0]),
            self.pool.k, self.pool.v, self._tensor(pt), self._tensor([m]),
            self.cfg, **self._scales())
        V = self.cfg.vocab_size
        err = float(torch.max(torch.abs(lg2[:, :V] - lg[:, :V])))
        self.metrics.readback_audits += 1
        self._step_logit_err = max(self._step_logit_err, err)
        if self.telemetry is not None:
            self.telemetry.on_readback(req, err)
        return err

    def _audit_and_quarantine(self, req: Request, lg: torch.Tensor) -> None:
        """Post-join integrity pass: the readback audit when the guard asks
        for it, quarantine on a bound breach."""
        g = self.guard
        if g is None or not g.config.readback_audit:
            return
        err = self._readback_audit(req, lg)
        if g.should_quarantine(err):
            self._quarantine(req, err)

    def drain(self) -> Dict[int, List[int]]:
        """Materialize every in-flight sampled-token vector into its
        request's ``tokens`` list. Returns {req_id: fresh tokens}."""
        tel = self.telemetry
        n = len(self._pending)
        t = self._clock() if (tel is not None and n) else 0.0
        events: Dict[int, List[int]] = {}
        for vec, rows in self._pending:
            arr = vec.cpu().numpy()              # host <-> device sync
            for req, epoch, row in rows:
                if req.epoch == epoch:           # not preempted since
                    tok = int(arr[row])
                    req.tokens.append(tok)
                    events.setdefault(req.req_id, []).append(tok)
        self._pending.clear()
        if tel is not None and n:
            tel.on_drain(t, self._clock() - t, n)
        return events

    def run(self, on_token: Optional[Callable[[int, List[int]], None]] = None
            ) -> Dict[int, Request]:
        """Drive until every submitted request has finished. With
        ``on_token`` the tokens are drained every step for streaming;
        without it the pipeline drains once at the end. ``metrics.wall_s``
        becomes the true wall time of the drive, final drain included."""
        t0 = self._clock()
        w0 = self.metrics.wall_s
        while self.sched.has_work():
            events = self.step()
            if on_token:
                for rid, toks in self.drain().items():
                    events.setdefault(rid, []).extend(toks)
                for rid, toks in events.items():
                    on_token(rid, toks)
        self.drain()
        self.metrics.wall_s = w0 + (self._clock() - t0)
        return self.pop_finished()

    def pop_finished(self) -> Dict[int, Request]:
        """Return-and-clear the finished set."""
        done = dict(self.sched.finished)
        self.sched.finished.clear()
        return done

    # -- internals --------------------------------------------------------

    def _fresh_metrics(self) -> EngineMetrics:
        """Zeroed counters with the engine-constant pool-capacity fields
        stamped (valid before the first step, kept across reset())."""
        return EngineMetrics(kv_dtype=self.pool.kv_dtype,
                             pool_token_capacity=self.pool.token_capacity,
                             kv_pool_bytes=self.pool.hbm_bytes)

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
        tel = self.telemetry
        t = self._clock() if tel is not None else 0.0
        plen = req.prompt_len
        m = req.n_prefix_hit
        lg = self._prefill_from_offset(req, m) if m > 0 else \
            self._prefill_full(req)
        req.n_prefilled = plen
        self.metrics.prefill_tokens += plen - m
        self.metrics.prefix_hit_tokens += m
        if tel is not None:
            tel.on_prefill(req, "prefill-suffix" if m > 0 else "prefill",
                           plen - m,
                           self._pow2_bucket(-(-plen // self.block_size)),
                           t, self._clock() - t)
        if self.faults is not None and self.faults.take_kv_corrupt():
            self._corrupt_request_blocks(req)      # bad write, post hoc
        self._join_decode(req, lg, events)
        self._probe_numerics(req)
        self._audit_and_quarantine(req, lg)

    def _probe_numerics(self, req: Request) -> None:
        """The telemetry's numerics probe after a join; its logit error
        feeds the guard's signal."""
        if self.telemetry is not None:
            probe = self.telemetry.maybe_numerics_probe(self, req)
            if probe:
                self._step_logit_err = max(
                    self._step_logit_err,
                    float(probe.get("logit_error", 0.0)))

    def _do_prefill_chunk(self, req: Request,
                          events: Dict[int, List[int]]) -> None:
        """Advance one prefilling request by one chunk through the
        flash-prefill step; the final chunk's logits seed decoding."""
        tel = self.telemetry
        t = self._clock() if tel is not None else 0.0
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
        if tel is not None:
            # modeled cost of the chunk's paged-prefill launch (per layer):
            # pos0 = m, one row, real table cover = cover
            cost = prefill_launch_cost(
                C, [m], [cover], w, n_q_heads=self.cfg.n_heads,
                n_kv_heads=self.cfg.n_kv_heads,
                head_dim=self.cfg.head_dim, block_size=self.block_size,
                kv_tile_blocks=self.kv_tile_blocks,
                kv_dtype=self.pool.kv_dtype)
            tel.on_prefill(req, "prefill-chunk", sl, w, t,
                           self._clock() - t, cost=cost,
                           launches=self.cfg.n_layers)
        if req.n_prefilled == req.prompt_len:
            if self.faults is not None and self.faults.take_kv_corrupt():
                self._corrupt_request_blocks(req)  # bad write, post hoc
            self._join_decode(req, lg, events)
            self._probe_numerics(req)
            self._audit_and_quarantine(req, lg)
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
        # dispatch-time stamp (t_finish has the same convention)
        req.t_first_token = self._clock()
        req.t_last_token = req.t_first_token
        self.metrics.prefills += 1
        self.metrics.tokens_out += 1
        if self.telemetry is not None:
            self.telemetry.on_first_token(req)

    def _pow2_bucket(self, need: int) -> int:
        return table_width_bucket(need, nb_max=self.nb_max)

    def _table_width(self, occ) -> int:
        """Decode block-table width covering the longest running request."""
        return self._pow2_bucket(
            max(self.pool.n_blocks_of(r.req_id) for _, r in occ))

    def _do_decode_step(self, events: Dict[int, List[int]]) -> None:
        tel = self.telemetry
        t = self._clock() if tel is not None else 0.0
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
        # the kernel attends lengths+1 on every row (zombies included,
        # masked): plan against what it does
        tile, split = self.kv_tile_blocks, self.decode_split_k
        plan = None
        if self.autotune == "per-step":
            plan = self.planner.plan_decode(lengths + 1, w)
            tile, split = plan.kv_tile_blocks, plan.split_k
        lg = paged_decode_step(self.params, tokens1, self.pool.k,
                               self.pool.v, self._tensor(bt),
                               self._tensor(lengths), self.cfg,
                               kv_tile_blocks=tile, decode_split_k=split,
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
        if tel is not None:
            self._observe_decode(tel, t, occ, lengths, w, tile, split, plan)

    def _observe_decode(self, tel: Telemetry, t: float, occ, lengths, w: int,
                        tile: int, split: int, plan) -> None:
        """The decode step's telemetry: its modeled K1 cost (the plan's, or
        memoized on the host lengths), the timeline slice, the planner's
        measured step and every row's token gap — host work only."""
        now = self._clock()
        if plan is not None:
            cost = plan.cost
        else:
            key = (w, tile, split, (lengths // self.block_size).tobytes())
            cost = self._cost_cache.get(key)
            if cost is None:
                if len(self._cost_cache) >= 4096:
                    self._cost_cache.clear()
                cost = decode_launch_cost(
                    lengths + 1, w, n_q_heads=self.cfg.n_heads,
                    n_kv_heads=self.cfg.n_kv_heads,
                    head_dim=self.cfg.head_dim, block_size=self.block_size,
                    kv_tile_blocks=tile, split_k=split,
                    kv_dtype=self.pool.kv_dtype)
                self._cost_cache[key] = cost
        tel.on_decode_step(rows=len(occ), table_width=w, t_start=t,
                           dur=now - t, split_k=split, kv_tile_blocks=tile,
                           cost=cost, launches=self.cfg.n_layers)
        if plan is not None:
            self.planner.observe_measured(plan, now - t)
        tel.on_decode_tokens([r for _, r in occ], now)

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
