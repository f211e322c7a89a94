"""Serving observability: per-request lifecycle traces, the step timeline,
kernel-cost and planner accounting, and the int8 numerics monitor,
publishing into ``serve/metrics.py`` — the JAX package's
``repro.serve.telemetry`` on the port.

The engine owns at most one ``Telemetry`` (``telemetry=None``, the default,
keeps every hook site at one ``is not None`` check). When attached, the
engine calls the ``on_*`` hooks at the lifecycle points below. Every hook
is host bookkeeping: none launches, waits for or reads device work, so a
stamp is the host's DISPATCH time of the event (TPOT's help string says
so). On the card the engine's step is host-bound, so dispatch stamps sit
close to when the work runs; a stamp is not a device time. The one hook
that reads the device is the numerics probe, which runs its audit and
reads the result to the host, as the reference does.

    submit ──► admit ──► prefill[-chunk|-suffix]* ──► first token ──►
      decode token* ──► finish
                 ▲                                        │
                 └──────────────── preempt ◄──────────────┘

**Per-request tracing** (``RequestTrace``): timestamps of every lifecycle
edge, queue wait (submit→admit), TTFT (submit→first token), TPOT (gaps
between decode tokens), E2E (submit→finish), prefix-hit tokens and
preemptions. Aggregates stream into fixed log-bucket histograms.

**Step timeline** (``StepTimeline``): one Chrome trace-event record per
engine phase (prefill, prefill-chunk, prefill-suffix, decode, drain, step)
with batch rows, table width, the grid knobs and the modeled kernel bytes
and FLOPs in its args. ``save_chrome_trace`` writes the
``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto load.
Engine phases land on tid 0; request instants on tid = req_id + 1.

**Clock injection**: every timestamp comes from ``Telemetry.clock``
(default ``time.monotonic``); ``ManualClock`` makes tests deterministic.

**Online numerics monitor** (``numerics_every > 0`` on an int8 engine):
every Nth completed prefill re-runs a power-of-two prefix of the request's
prompt through ``serve/paged_step.paged_prefill_audit`` — a lockstep
full-precision against int8-fake-quant forward — publishing the live
logit-error gauge, Softermax IntMax overflows against the paper's Q(6,2)
LocalMax format, and K/V rows a static percentile-calibrated int8 scale
would saturate.
"""
from __future__ import annotations

import dataclasses
import json
import operator
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.guard import GUARD_STATES
from repro_torch.serve.metrics import MetricRegistry
from repro_torch.serve.paged_step import paged_prefill_audit

Clock = Callable[[], float]


class ManualClock:
    """Deterministic clock for tests: every reading advances by ``tick``
    (so durations are non-zero and reproducible); ``advance`` jumps."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.t
        self.t += self.tick
        return t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class RequestTrace:
    """Lifecycle record of one request (one line of the trace export)."""

    req_id: int
    prompt_len: int = 0
    max_new: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    n_prefix_hit: int = 0
    n_preemptions: int = 0
    n_tokens: int = 0
    prefill_chunks: int = 0
    # how the request left the engine: "" while live, then "length" /
    # "cancelled" / "deadline" / "quarantined" / "shed" (terminal states)
    finish_reason: str = ""
    # (event name, timestamp) — submit/admit/prefill*/token/preempt/finish;
    # bounded by the request's own lifetime (≤ max_new token events)
    events: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.t_submit if self.t_admit else 0.0

    @property
    def ttft(self) -> float:
        return (self.t_first_token - self.t_submit
                if self.t_first_token else 0.0)

    @property
    def e2e(self) -> float:
        return self.t_finish - self.t_submit if self.t_finish else 0.0

    @property
    def tpot_mean(self) -> float:
        """Mean decode-token gap (dispatch-time convention, like TTFT)."""
        if self.n_tokens <= 1 or not self.t_finish:
            return 0.0
        return (self.t_finish - self.t_first_token) / (self.n_tokens - 1)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["queue_wait"] = self.queue_wait
        d["ttft"] = self.ttft
        d["e2e"] = self.e2e
        d["tpot_mean"] = self.tpot_mean
        return d


class StepTimeline:
    """Chrome trace-event accumulator (bounded; drops are counted)."""

    def __init__(self, t0: float, max_events: int = 200_000):
        self.t0 = t0
        self.max_events = max_events
        self.events: List[Dict] = []
        self.dropped = 0

    def _us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def _push(self, ev: Dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def complete(self, name: str, t_start: float, dur: float,
                 tid: int = 0, **args) -> None:
        self._push({"name": name, "cat": "serve", "ph": "X",
                    "ts": self._us(t_start), "dur": dur * 1e6,
                    "pid": 0, "tid": tid, "args": args})

    def instant(self, name: str, t: float, tid: int = 0, **args) -> None:
        self._push({"name": name, "cat": "serve", "ph": "i",
                    "ts": self._us(t), "s": "t",
                    "pid": 0, "tid": tid, "args": args})

    def to_chrome(self, meta: Optional[Dict] = None) -> Dict:
        """The standard Chrome trace-event JSON object (Perfetto-loadable).
        tid 0 is named "engine"; request tids are req_id + 1 so they never
        collide with it."""
        events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
                   "args": {"name": "engine"}}]
        req_tids = sorted({e["tid"] for e in self.events if e["tid"] != 0})
        for tid in req_tids:
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": f"req {tid - 1}"}})
        events.extend(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": dict(meta or {},
                                  dropped_events=self.dropped)}


class Telemetry:
    """Observability hub one ``ContinuousEngine`` publishes into.

    Parameters
    ----------
    clock : injectable time source (``time.monotonic`` by default).
    timeline : record Chrome trace events per engine phase.
    trace_requests : keep per-request ``RequestTrace`` records (finished
        ones in ``finished_traces``, bounded by ``max_finished_traces``).
    numerics_every : probe every Nth completed prefill with the lockstep
        int8-vs-full-precision audit (0 = off; needs an int8 engine).
    numerics_max_tokens : cap on probed prompt-prefix length (bounds the
        probe's cost; lengths quantize to powers of two by truncation).
    """

    def __init__(self, *, clock: Optional[Clock] = None,
                 timeline: bool = True, trace_requests: bool = True,
                 numerics_every: int = 0, numerics_max_tokens: int = 64,
                 max_timeline_events: int = 200_000,
                 max_finished_traces: int = 10_000):
        if numerics_every < 0:
            raise ValueError("numerics_every must be >= 0")
        self.clock: Clock = clock or time.monotonic
        self.trace_requests = trace_requests
        self.numerics_every = numerics_every
        self.numerics_max_tokens = numerics_max_tokens
        self._timeline_on = timeline
        self._max_timeline_events = max_timeline_events
        self._max_finished = max_finished_traces
        self.registry = MetricRegistry()
        self._build()

    def _build(self) -> None:
        reg = self.registry
        # publish_engine's (Gauge, attrgetter) bindings point into the
        # registry — a reset swaps the metric objects out, so rebind lazily
        self._gauge_bindings = None
        self.timeline = StepTimeline(self.clock(),
                                     self._max_timeline_events) \
            if self._timeline_on else None
        self.traces: Dict[int, RequestTrace] = {}
        self.finished_traces: List[RequestTrace] = []
        h = reg.histogram
        self.h_ttft = h("serve_ttft_seconds",
                        "submit to first sampled token")
        self.h_tpot = h("serve_tpot_seconds",
                        "gap between consecutive decode tokens of one "
                        "request (dispatch-time convention)")
        self.h_e2e = h("serve_e2e_seconds", "submit to finish")
        self.h_queue = h("serve_queue_wait_seconds", "submit to admission")
        self.h_step = h("serve_step_seconds", "one engine step() call")
        c = reg.counter
        self.c_submitted = c("serve_requests_submitted_total",
                             "requests enqueued")
        self.c_finished = c("serve_requests_finished_total",
                            "requests completed")
        self.c_preempted = c("serve_requests_preempted_total",
                             "preemption events (one request can count "
                             "several times)")
        self.c_probes = c("numerics_probes_total",
                          "int8-vs-full-precision audit runs")
        self.c_intmax_overflow = c(
            "numerics_intmax_overflow_rows_total",
            "score rows whose running IntMax exceeds the Q(6,2) LocalMax "
            "format across probed prefills")
        self.c_scale_sat = c(
            "numerics_kv_scale_sat_rows_total",
            "K/V rows whose amax would saturate a static "
            "percentile-calibrated int8 scale across probed prefills")
        # kernel cost observatory: analytic per-launch accounting
        # (serve/kernel_costs.py) published live. Counters aggregate
        # all layers of every launch; histograms sample PER-LAUNCH
        # (= per-layer) values on byte/FLOP-shaped ladders (the default
        # ladder is latency-shaped and would overflow immediately).
        self.c_kernel_dma = c(
            "kernel_dma_bytes_total",
            "modeled gather-DMA bytes moved by the paged kernels "
            "(KV + int8 scale siblings, incl. clamped block-0 waste)")
        self.c_kernel_flops = c(
            "kernel_flops_total",
            "modeled MXU matmul FLOPs executed by the paged kernels")
        self.c_kernel_waste = c(
            "kernel_waste_bytes_total",
            "subset of kernel_dma_bytes_total gathered for table entries "
            "at/past each row's real block cover (pow2 bucketing, tile "
            "padding, dead tail blocks) — pure masked-out DMA")
        self.h_launch_dma = h("kernel_launch_dma_bytes",
                              "gather-DMA bytes of one kernel launch "
                              "(one layer)", lo=1024.0, growth=1.6,
                              n_buckets=64)
        self.h_launch_flops = h("kernel_launch_flops",
                                "MXU FLOPs of one kernel launch "
                                "(one layer)", lo=4096.0, growth=1.6,
                                n_buckets=64)
        # resilience surface: fault injections, terminal-state
        # counters, retry/readback accounting, and the guard ladder gauge
        self.c_faults = c("fault_injected_total",
                          "fault-injector firings (by the engine's "
                          "attached FaultPlan)")
        self.c_cancelled = c("requests_cancelled_total",
                             "requests cancelled (client, deadline, or "
                             "quarantine)")
        self.c_shed = c("requests_shed_total",
                        "submissions refused while the guard sheds load")
        self.c_deadline = c("deadline_misses_total",
                            "requests cancelled on deadline/TTFT breach")
        self.c_quarantined = c("requests_quarantined_total",
                               "requests cancelled by the scatter-readback "
                               "KV-integrity audit")
        self.c_retries = c("step_transient_retries_total",
                           "TransientFaults absorbed by bounded retry")
        self.c_readback = c("readback_audits_total",
                            "scatter-readback KV-integrity audits run")
        self.c_guard_transitions = c("guard_transitions_total",
                                     "degradation-ladder state changes")
        self.g_guard_state = reg.gauge(
            "guard_state",
            "degradation ladder level: 0 healthy, 1 degraded, 2 shedding")

    # -- lifecycle hooks (engine calls these; all host-side, O(1)) --------

    def _trace(self, req) -> Optional[RequestTrace]:
        if not self.trace_requests:
            return None
        tr = self.traces.get(req.req_id)
        if tr is None:
            tr = RequestTrace(req.req_id, prompt_len=req.prompt_len,
                              max_new=req.max_new, t_submit=req.t_submit)
            self.traces[req.req_id] = tr
        return tr

    def _mark(self, req, name: str, t: float) -> None:
        tr = self._trace(req)
        if tr is not None:
            tr.events.append((name, t))
        if self.timeline is not None:
            self.timeline.instant(name, t, tid=req.req_id + 1)

    def on_submit(self, req) -> None:
        self.c_submitted.inc()
        self._mark(req, "submit", req.t_submit)

    def on_admit(self, req) -> None:
        self.h_queue.observe(req.t_admit - req.t_submit)
        tr = self._trace(req)
        if tr is not None:
            tr.t_admit = req.t_admit
            tr.n_prefix_hit = req.n_prefix_hit
        self._mark(req, "readmit" if req.n_preemptions else "admit",
                   req.t_admit)

    def on_prefill(self, req, kind: str, n_tokens: int, table_width: int,
                   t_start: float, dur: float, cost=None,
                   launches: int = 1) -> None:
        """kind: "prefill" (one-shot cold), "prefill-suffix" (cache hit),
        or "prefill-chunk". ``cost`` is the per-launch ``LaunchCost`` when
        the phase ran a paged kernel (chunked prefill); ``launches`` is
        kernel launches in the phase (= model layers)."""
        tr = self._trace(req)
        if tr is not None:
            tr.events.append((kind, t_start))
            if kind == "prefill-chunk":
                tr.prefill_chunks += 1
        extra = self.on_kernel_launch(kind, cost, launches)
        if self.timeline is not None:
            self.timeline.complete(kind, t_start, dur,
                                   req=req.req_id, tokens=n_tokens,
                                   table_width=table_width, **extra)

    def on_first_token(self, req) -> None:
        # observe TTFT once per request: a preempted request's re-delivered
        # first token is not a second TTFT sample (only DECODING requests
        # are ever preempted, so n_preemptions > 0 implies a prior join).
        # A request migrated from a dead replica arrives with
        # ttft_observed=True — its fleet-wide first token already streamed
        # from the old replica, so this replica's registry must not add a
        # second sample (fleet aggregation via MetricRegistry.collect
        # would double-count it)
        tr = self._trace(req)
        first = ((not tr.t_first_token) if tr is not None
                 else (req.n_preemptions == 0)) and \
            not getattr(req, "ttft_observed", False)
        if first:
            self.h_ttft.observe(req.t_first_token - req.t_submit)
        if tr is not None:
            if not tr.t_first_token:
                tr.t_first_token = req.t_first_token
            tr.n_tokens = req.n_generated
        self._mark(req, "first_token", req.t_first_token)

    def on_decode_token(self, req, now: float) -> None:
        self.on_decode_tokens((req,), now)

    def on_decode_tokens(self, reqs, now: float) -> None:
        """Per-token accounting for one decode step, batched: the engine
        calls this once per step with every occupied row's request (the
        hottest hook — once per generated token) so the histogram/trace
        lookups are hoisted out of the per-request loop. Trace event
        lists record lifecycle milestones only — the per-token signal is
        the tpot histogram sample, not an event tuple per token (which
        would dominate hook cost AND allocator churn at serving rates)."""
        observe = self.h_tpot.observe
        traces = self.traces if self.trace_requests else None
        for req in reqs:
            if req.t_last_token > 0:
                observe(now - req.t_last_token)
            req.t_last_token = now
            if traces is not None:
                tr = traces.get(req.req_id)
                if tr is not None:
                    tr.n_tokens = req.n_generated

    def on_decode_step(self, *, rows: int, table_width: int,
                       t_start: float, dur: float, split_k: int,
                       kv_tile_blocks: int, cost=None,
                       launches: int = 1) -> None:
        extra = self.on_kernel_launch("decode", cost, launches)
        if self.timeline is not None:
            self.timeline.complete("decode", t_start, dur, rows=rows,
                                   table_width=table_width,
                                   split_k=split_k,
                                   kv_tile_blocks=kv_tile_blocks, **extra)

    def on_kernel_launch(self, phase: str, cost, launches: int = 1) -> Dict:
        """Account one engine phase's paged-kernel launches from its
        analytic ``LaunchCost`` (``serve/kernel_costs.py``): counters get
        the phase total (cost × launches), per-launch histograms get one
        per-layer sample. Returns the trace args to stamp on the phase's
        timeline slice — Perfetto then shows bytes/FLOPs per phase.
        ``cost=None`` (phase didn't run a paged kernel) is a no-op."""
        if cost is None:
            return {}
        dma = cost.gather_bytes * launches
        flops = cost.flops * launches
        waste = cost.waste_bytes * launches
        self.c_kernel_dma.inc(dma)
        self.c_kernel_flops.inc(flops)
        self.c_kernel_waste.inc(waste)
        self.h_launch_dma.observe(cost.gather_bytes)
        self.h_launch_flops.observe(cost.flops)
        return {"dma_bytes": dma, "flops": flops, "waste_bytes": waste,
                "grid_steps": cost.grid_steps * launches}

    def on_drain(self, t_start: float, dur: float, n_vectors: int) -> None:
        """Host↔device sync: materializing the async token pipeline."""
        if self.timeline is not None:
            self.timeline.complete("drain", t_start, dur,
                                   vectors=n_vectors)

    def on_preempt(self, req) -> None:
        self.c_preempted.inc()
        tr = self._trace(req)
        if tr is not None:
            tr.n_preemptions = req.n_preemptions
        self._mark(req, "preempt", self.clock())

    def on_finish(self, req) -> None:
        self.c_finished.inc()
        self.h_e2e.observe(req.t_finish - req.t_submit)
        self._mark(req, "finish", req.t_finish)
        self._finalize_trace(req, getattr(req, "finish_reason", "length"))

    def _finalize_trace(self, req, reason: str) -> None:
        tr = self.traces.pop(req.req_id, None)
        if tr is not None:
            tr.t_finish = req.t_finish
            tr.n_tokens = req.n_generated
            tr.n_preemptions = req.n_preemptions
            tr.finish_reason = reason
            if len(self.finished_traces) < self._max_finished:
                self.finished_traces.append(tr)

    # -- resilience hooks (faults / cancellation / guard) -----------------

    def on_fault(self, kind: str, step: int, **details) -> None:
        """One injector firing (called when a fault window opens)."""
        self.c_faults.inc()
        if self.timeline is not None:
            self.timeline.instant(f"fault:{kind}", self.clock(),
                                  step=step, **details)

    def on_cancel(self, req, reason: str) -> None:
        """Terminal states that are not natural completion: client cancel,
        deadline/TTFT breach, quarantine. The request's trace finalizes
        with the reason; e2e samples stay completion-only so the latency
        histograms are not polluted by cut-short requests."""
        self.c_cancelled.inc()
        if reason == "deadline":
            self.c_deadline.inc()
        elif reason == "quarantined":
            self.c_quarantined.inc()
        self._mark(req, f"cancel:{reason}", req.t_finish or self.clock())
        self._finalize_trace(req, reason)

    def on_shed(self) -> None:
        self.c_shed.inc()

    def on_retry(self) -> None:
        self.c_retries.inc()

    def on_readback(self, req, err: float) -> None:
        self.c_readback.inc()
        self.registry.gauge(
            "readback_logit_error",
            "latest scatter-readback audit's max logit delta").set(err)

    def on_guard(self, old: str, new: str, reason: str,
                 step: int = -1) -> None:
        """Degradation-ladder transition (the engine calls this only when
        the state actually changed; the steady-state gauge refresh happens
        engine-side)."""
        self.c_guard_transitions.inc()
        self.g_guard_state.set(float(GUARD_STATES.index(new)))
        if self.timeline is not None:
            self.timeline.instant(f"guard:{old}->{new}", self.clock(),
                                  step=step, reason=reason)

    def on_step_end(self, engine, t_start: float, dur: float) -> None:
        self.h_step.observe(dur)
        if self.timeline is not None:
            self.timeline.complete("step", t_start, dur)
        # the gauges mirror cumulative engine structs, so scrape freshness
        # is bounded by the publish cadence, not correctness: refresh on a
        # short cadence plus whenever the engine goes quiescent (the final
        # step of a run always publishes — post-run snapshots are exact)
        if engine.metrics.steps % 4 == 0 or not engine.sched.running:
            self.publish_engine(engine)

    # -- registry publication ---------------------------------------------

    # (exported gauge name, attribute on the mirrored struct) — resolved
    # to bound (Gauge, attrgetter) pairs once per Telemetry instance:
    # publish_engine runs every engine step, and per-step registry name
    # lookups plus rebuilding these tables dominated the hook budget
    _ENGINE_GAUGES = (
        ("serve_steps", "steps"),
        ("serve_decode_steps", "decode_steps"),
        ("serve_prefills", "prefills"),
        ("serve_prefill_chunks", "prefill_chunks"),
        ("serve_preemptions", "preemptions"),
        ("serve_tokens_out", "tokens_out"),
        ("serve_tokens_discarded", "tokens_discarded"),
        ("serve_prefill_tokens", "prefill_tokens"),
        ("serve_prefix_hit_tokens", "prefix_hit_tokens"),
        ("serve_prefill_savings", "prefill_savings"),
        ("serve_wall_seconds", "wall_s"),
        ("serve_kv_pool_bytes", "kv_pool_bytes"),
        ("serve_pool_token_capacity", "pool_token_capacity"))
    _POOL_GAUGES = (
        ("pool_blocks_in_use", "blocks_in_use"),
        ("pool_blocks_peak", "peak_in_use"),
        ("pool_utilization", "utilization"),
        ("pool_allocs", "allocs"),
        ("pool_frees", "frees"),
        ("pool_shared_blocks", "shared_blocks"),
        ("pool_shared_blocks_peak", "peak_shared"),
        ("pool_cow_copies", "cow_copies"))
    _CACHE_GAUGES = (
        ("cache_lookup_tokens", "lookup_tokens"),
        ("cache_hit_tokens", "hit_tokens"),
        ("cache_hit_rate", "hit_rate"),
        ("cache_hits", "hits"),
        ("cache_misses", "misses"),
        ("cache_inserts", "inserts"),
        ("cache_evictions", "evictions"))

    def publish_engine(self, engine) -> None:
        """Mirror ``EngineMetrics`` / ``PoolStats`` / ``CacheStats`` into
        the registry (cumulative-since-reset values exported as gauges —
        the authoritative counters live on the engine structs)."""
        bound = self._gauge_bindings
        if bound is None:
            g = self.registry.gauge
            bound = self._gauge_bindings = tuple(
                tuple((g(n), operator.attrgetter(a)) for n, a in grp)
                for grp in (self._ENGINE_GAUGES, self._POOL_GAUGES,
                            self._CACHE_GAUGES))
        m = engine.metrics
        for gg, get in bound[0]:
            gg.value = float(get(m))
        p = engine.pool.stats
        for gg, get in bound[1]:
            gg.value = float(get(p))
        if engine.prefix_cache is not None:
            s = engine.prefix_cache.stats
            for gg, get in bound[2]:
                gg.value = float(get(s))

    # -- numerics monitor --------------------------------------------------

    def maybe_numerics_probe(self, engine, req) -> Optional[Dict[str, float]]:
        """Every ``numerics_every``-th completed prefill of an int8 engine,
        re-run (a power-of-two prefix of) the request's prompt through the
        lockstep full-precision/int8 audit and publish the live gauges.
        Returns the probe dict when a probe ran (the engine feeds its
        ``logit_error`` into the guard's per-step signal), else None."""
        if self.numerics_every <= 0 or not engine.quantized:
            return None
        # called right after _join_decode bumped prefills: probe the 1st,
        # (1+N)th, (1+2N)th ... completed prefill
        if (engine.metrics.prefills - 1) % self.numerics_every != 0:
            return None
        return self.numerics_probe(engine, req.prompt)

    def numerics_probe(self, engine, prompt) -> Dict[str, float]:
        """Run ``paged_prefill_audit`` eagerly on the engine's device over
        a power-of-two prefix of ``prompt`` (at most
        ``numerics_max_tokens``) and publish the gauges; the audit's
        logit delta and stats reach the host in one read."""
        # power-of-two prefix: bounded probe cost and shape count
        n = min(int(prompt.shape[0]), self.numerics_max_tokens)
        probe_len = 1
        while probe_len * 2 <= n:
            probe_len *= 2
        dev = engine.device
        tokens = torch.as_tensor(
            np.asarray(prompt[:probe_len], np.int32)[None], device=dev)
        last = torch.tensor([probe_len - 1], dtype=torch.int32, device=dev)
        with torch.no_grad():
            lg_ref, lg_q, stats = paged_prefill_audit(
                engine.params, tokens, last, engine.cfg)
        V = engine.cfg.vocab_size
        names = list(stats)
        vals = torch.stack([t.double() for t in (
            torch.max(torch.abs(lg_ref[:, :V] - lg_q[:, :V])),
            *(stats[k] for k in names))]).cpu().tolist()
        err = vals[0]
        out = dict(zip(names, vals[1:]))
        out["logit_error"] = err
        g = self.registry.gauge
        g("numerics_logit_error",
          "latest probe's max |full - int8| logit delta").set(err)
        g("numerics_logit_error_max",
          "largest logit delta seen since reset (the int8 pool's "
          "logit-error bound, live)"
          ).max(err)
        g("numerics_probe_tokens", "prompt prefix length probed"
          ).set(probe_len)
        g("numerics_score_intmax_max",
          "largest running IntMax over probed attention scores").max(
              out["score_intmax_max"])
        g("numerics_kv_amax_max",
          "largest per-row K/V amax seen (static-scale headroom)").max(
              out["kv_amax_max"])
        self.c_probes.inc()
        self.c_intmax_overflow.inc(out["intmax_overflow_rows"])
        self.c_scale_sat.inc(out["kv_scale_sat_rows"])
        return out

    # -- export ------------------------------------------------------------

    def quantiles(self, name: str) -> Dict[str, float]:
        """{"p50": ..., "p90": ..., "p99": ..., "count": ...} of one of
        the telemetry histograms (name without the serve_ prefix is
        accepted: "ttft" → serve_ttft_seconds)."""
        h = self.registry.get(name) or \
            self.registry.get(f"serve_{name}_seconds")
        if h is None:
            raise KeyError(name)
        return {"p50": h.quantile(0.50), "p90": h.quantile(0.90),
                "p99": h.quantile(0.99), "count": h.count,
                "mean": h.mean}

    def save_chrome_trace(self, path: str,
                          meta: Optional[Dict] = None) -> None:
        if self.timeline is None:
            raise RuntimeError("timeline recording is disabled")
        with open(path, "w") as f:
            json.dump(self.timeline.to_chrome(meta), f)
            f.write("\n")

    def save_metrics(self, path: str,
                     extra: Optional[Dict] = None) -> None:
        """``.jsonl`` → append one registry snapshot line (the JSONL
        sink); anything else → Prometheus text exposition."""
        if path.endswith(".jsonl"):
            self.registry.write_jsonl(path, extra)
        else:
            with open(path, "w") as f:
                f.write(self.registry.prometheus_text())

    def reset(self) -> None:
        """Coherent zero of every aggregate (histograms, counters, gauges,
        timeline, traces)."""
        self.registry.reset()
        self._build()
