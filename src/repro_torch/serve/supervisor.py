"""Fleet supervision: per-replica health, step-watchdog heartbeats, and
journaled failover over N ``ContinuousEngine`` replicas — the JAX
package's ``repro.serve.supervisor`` on the port, clock read for clock
read (so a ``ManualClock`` fleet writes the reference's journal).

The supervisor owns the synchronous fleet drive — one ``tick()`` is one
supervision round:

    1. evaluate the fleet fault plan (``replica_crash`` / ``replica_hang``
       via the ``FaultInjector``; a crash kills the replica at the
       tick boundary, a hang makes its device unresponsive);
    2. run the step-watchdog: a serving replica that holds work but has
       not heartbeated for ``hang_grace_ticks`` supervision ticks (or
       ``hang_timeout_s`` wall seconds, when set) is declared hung;
    3. retry pending placements whose backoff expired, and enforce
       deadlines on requests the fleet has not managed to place;
    4. step + drain every serving replica (optionally in parallel
       threads — engines share nothing but read-only params), stamping
       heartbeats;
    5. pump freshly materialized tokens and terminal states into the
       tracker/journal, in replica order (deterministic journals).

**Failover recompute contract.** When a replica dies or hangs, every
request assigned to it is re-placed on a survivor with the prompt
``[prompt ‖ tokens-emitted-so-far]`` and ``max_new`` reduced by the
tokens already streamed. Greedy decode is deterministic and the repo's
engine paths are pinned exactly equal (the greedy-equality tests),
so the survivor's continuation is byte-identical to the unfailed run —
the same recompute mechanism the scheduler already uses for
preemption-readmit, lifted across replicas. The migration stamps
(``t_submit`` override + ``ttft_observed``) keep deadlines, E2E, and the
fleet-wide single TTFT sample measured from the client's original
submit. (In bf16 on the card the survivor's prefill of ``[prompt ‖
emitted]`` rounds otherwise than the decode steps that produced
``emitted``, so a continuation can flip a greedy token where two logits
nearly tie; in float32 on the CPU the streams are equal.)

**Parallel steps on the card.** With ``step_parallel=True`` the replicas
step in a thread pool. Every thread launches on its current stream, the
device's default stream, so all replicas' kernels run in one stream
order: the decode kernels' merge tickets, kept per (device, stream) and
left at 0 by every launch, and the routes their wrappers cache per
geometry are shared safely; the kernels' shared library loads, and
their launch counts are bumped, under a lock. On one stream the threads
overlap no card work and slow the host, so the launcher steps a card
fleet on one thread. Per-replica streams would overlap replicas on the
card; they are a change of the step's timing, not of the fleet, and are
not made here.

A hung replica differs from a crashed one only in its afterlife: its
requests fail over identically, but when the device comes back the
supervisor first cancels the revoked engine requests (reason
``failover`` — freeing their blocks and radix pins, and making any
stale pipeline vector epoch-dead) and then returns the replica, empty,
to the routing pool. A crashed replica's engine is abandoned outright.

Placement failures (whole fleet shedding/full) ride bounded exponential
backoff: the delay starts from the ``EngineSheddingError.retry_after_steps``
hint when one was raised and doubles per consecutive refusal, bounded by
``max_attempts`` before the request resolves ``rejected``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.frontend import (DONE, PENDING, PLACED,
                                        Assignment, RequestTracker,
                                        TrackedRequest)
from repro_torch.serve.guard import EngineSheddingError
from repro_torch.serve.invariants import check_invariants
from repro_torch.serve.journal import Journal, state_digest
from repro_torch.serve.router import Router
from repro_torch.serve.scheduler import (FINISH_DEADLINE,
                                         FINISH_FAILOVER, FINISH_LENGTH,
                                         CapacityExceededError)


def snapshot_path(snapshot_dir: str, replica_idx: int) -> str:
    """Canonical per-replica snapshot file name inside a snapshot dir."""
    return os.path.join(snapshot_dir, f"replica{replica_idx}.snap")

# replica lifecycle (ReplicaHandle.state)
SERVING, HUNG, DEAD = "serving", "hung", "dead"


@dataclasses.dataclass
class ReplicaHandle:
    """One replica as the supervisor sees it: the engine plus fleet-side
    liveness. ``stalled`` mirrors the injected-hang window (the device is
    unresponsive; the drive loop cannot step it) — *detection* is the
    watchdog's job, which only ever looks at heartbeats."""

    idx: int
    engine: object
    state: str = SERVING
    stalled: bool = False
    revoked: List[int] = dataclasses.field(default_factory=list)
    last_beat_tick: int = -1
    last_beat_t: float = 0.0

    @property
    def name(self) -> str:
        return f"r{self.idx}"

    @property
    def accepting(self) -> bool:
        return self.state == SERVING

    def has_work(self) -> bool:
        return self.engine.sched.has_work()


class FleetSupervisor:
    """Owns the replica set, the router, the tracker, and the journal;
    drives supervision ticks (module docstring). Engines must be warmed
    up by the caller before serving (warmup resets engine state)."""

    def __init__(self, engines: List[object],
                 router: Optional[Router] = None,
                 tracker: Optional[RequestTracker] = None,
                 journal: Optional[Journal] = None,
                 faults: Optional[FaultInjector] = None,
                 clock: Optional[Callable[[], float]] = None,
                 hang_grace_ticks: int = 3,
                 hang_timeout_s: Optional[float] = None,
                 max_attempts: int = 8,
                 backoff_cap_ticks: int = 32,
                 check_invariants_each_tick: bool = False,
                 step_parallel: bool = False,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: int = 0):
        if not engines:
            raise ValueError("fleet needs at least one engine replica")
        self.replicas = [ReplicaHandle(i, e) for i, e in enumerate(engines)]
        self.clock = clock or time.monotonic
        self.router = router or Router()
        self.tracker = tracker or RequestTracker(clock=self.clock)
        self.journal = journal
        self.faults = faults
        self.hang_grace_ticks = hang_grace_ticks
        self.hang_timeout_s = hang_timeout_s
        self.max_attempts = max_attempts
        self.backoff_cap_ticks = backoff_cap_ticks
        self.check_invariants_each_tick = check_invariants_each_tick
        self.step_parallel = step_parallel
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.restore_info: List[Dict] = []   # set by resume()
        self.ticks = 0
        self._engine_map: Dict[int, TrackedRequest] = {}
        self._next_engine_rid = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        reg = self.tracker.registry
        self.c_crashed = reg.counter(
            "fleet_replicas_crashed_total", "replicas lost to a crash")
        self.c_hung = reg.counter(
            "fleet_replicas_hung_total",
            "replicas declared hung by the step-watchdog")
        self.g_alive = reg.gauge(
            "fleet_replicas_alive", "replicas currently accepting work")
        self.g_alive.set(len(self.replicas))
        self.c_snapshots = reg.counter(
            "fleet_snapshots_written_total",
            "per-replica durable snapshots written to the snapshot dir")

    # -- front door --------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               ttft_budget_s: Optional[float] = None) -> TrackedRequest:
        """Accept one request fleet-wide: journal it, track it, and try
        to place it immediately (a refused placement parks it in the
        pending queue with backoff — the client's stream is live either
        way)."""
        treq = self.tracker.create(prompt, max_new, temperature,
                                   deadline_s=deadline_s,
                                   ttft_budget_s=ttft_budget_s)
        if self.journal is not None:
            rec = dict(rid=treq.rid, prompt_len=int(treq.prompt.shape[0]),
                       max_new=max_new)
            if self.journal.log_prompts:
                rec["prompt"] = [int(x) for x in treq.prompt]
            self.journal.append("submit", **rec)
        self._try_place(treq, reason="submit")
        return treq

    def has_work(self) -> bool:
        return self.tracker.has_work()

    @property
    def alive(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.state == SERVING]

    # -- placement ---------------------------------------------------------

    def _try_place(self, treq: TrackedRequest, reason: str) -> bool:
        if treq.remaining <= 0:
            # every token already streamed before the failover — nothing
            # left to recompute, the request is simply complete
            self._terminal(treq, FINISH_LENGTH)
            return True
        rprompt = treq.recompute_prompt()
        replica = self.router.place(rprompt, self.replicas)
        hint = 1
        if replica is not None:
            erid = self._next_engine_rid
            self._next_engine_rid += 1
            treq.attempts += 1
            if self.journal is not None:
                self.journal.append(
                    "placement", rid=treq.rid, replica=replica.idx,
                    engine_rid=erid, attempt=treq.attempts - 1,
                    reason=reason, resume_base=len(treq.tokens))
            try:
                handle = replica.engine.submit(
                    rprompt, treq.remaining,
                    temperature=treq.temperature, req_id=erid,
                    deadline_s=treq.deadline_s,
                    ttft_budget_s=(treq.ttft_budget_s if not treq.tokens
                                   else None),
                    t_submit=treq.t_submit,
                    ttft_observed=bool(treq.tokens))
            except EngineSheddingError as e:
                hint = e.retry_after_steps
            except CapacityExceededError:
                # static-config mismatch: no replica will ever take it
                self._terminal(treq, "rejected")
                return False
            else:
                treq.assignment = Assignment(replica.idx, erid, handle,
                                             resume_base=len(treq.tokens))
                treq.state = PLACED
                treq.replicas.append(replica.idx)
                self._engine_map[erid] = treq
                return True
        # refused (fleet full/shedding): bounded exponential backoff,
        # seeded by the shed hint when the guard provided one
        if replica is None:
            treq.attempts += 1
        treq.state = PENDING
        if treq.attempts >= self.max_attempts:
            self._terminal(treq, "rejected")
            return False
        delay = min(self.backoff_cap_ticks,
                    max(hint, 1 << min(treq.attempts, 5)))
        treq.next_retry_tick = self.ticks + delay
        self.tracker.c_retries.inc()
        return False

    def _terminal(self, treq: TrackedRequest, reason: str) -> None:
        if self.journal is not None:
            self.journal.append("terminal", rid=treq.rid, reason=reason,
                                n_tokens=len(treq.tokens))
        self.tracker.on_terminal(treq, reason)

    # -- failure handling --------------------------------------------------

    def _fail(self, replica: ReplicaHandle, why: str) -> None:
        """Crash or hang: take the replica out of rotation and fail its
        in-flight requests over to survivors (recompute contract in the
        module docstring)."""
        replica.state = DEAD if why == "crash" else HUNG
        (self.c_crashed if why == "crash" else self.c_hung).inc()
        self.g_alive.set(len(self.alive))
        if self.journal is not None:
            self.journal.append("replica", replica=replica.idx,
                                event=why, tick=self.ticks)
        for treq in self.tracker.assigned_to(replica.idx):
            asg = treq.assignment
            if why == "hang":
                replica.revoked.append(asg.engine_rid)
            self._engine_map.pop(asg.engine_rid, None)
            treq.assignment = None
            treq.state = PENDING
            treq.n_failovers += 1
            self.tracker.c_failovers.inc()
            self._try_place(treq, reason=why)

    def _resume(self, replica: ReplicaHandle) -> None:
        """A hung replica's device came back: revoke the requests that
        already failed over (their blocks/pins free; stale vectors go
        epoch-dead) and rejoin the routing pool empty."""
        for erid in replica.revoked:
            replica.engine.cancel(erid, reason=FINISH_FAILOVER)
        replica.revoked.clear()
        replica.state = SERVING
        replica.last_beat_tick = self.ticks
        replica.last_beat_t = self.clock()
        self.g_alive.set(len(self.alive))
        if self.journal is not None:
            self.journal.append("replica", replica=replica.idx,
                                event="resume", tick=self.ticks)

    # -- the supervision tick ---------------------------------------------

    def tick(self) -> None:
        t = self.ticks
        # 1. fleet fault plan
        if self.faults is not None:
            self.faults.begin_step(t)
            for idx in self.faults.take_replica_crashes():
                r = self.replicas[idx]
                if r.state != DEAD:
                    self._fail(r, "crash")
            stalled = self.faults.replica_hang_targets()
        else:
            stalled = set()
        for r in self.replicas:
            r.stalled = r.idx in stalled and r.state != DEAD
            if r.state == HUNG and not r.stalled:
                self._resume(r)
        # 2. step-watchdog: heartbeats only (the injected stall above is
        # the *cause*; this is the generic detector)
        now = self.clock()
        for r in self.replicas:
            if r.state != SERVING or not r.has_work():
                continue
            stale_ticks = t - max(r.last_beat_tick, 0)
            stale_s = now - r.last_beat_t if r.last_beat_t else 0.0
            if stale_ticks > self.hang_grace_ticks or \
                    (self.hang_timeout_s is not None and
                     stale_s > self.hang_timeout_s):
                self._fail(r, "hang")
        # 3. pending queue: deadlines first, then expired backoffs
        for treq in self.tracker.live():
            if treq.state != PENDING:
                continue
            if (treq.deadline_s is not None and
                    now - treq.t_submit >= treq.deadline_s) or \
                    (treq.ttft_budget_s is not None and not treq.tokens and
                     now - treq.t_submit >= treq.ttft_budget_s):
                self._terminal(treq, FINISH_DEADLINE)
            elif t >= treq.next_retry_tick:
                self._try_place(treq, reason="retry")
        # 4. step + drain serving replicas (heartbeat on success; an
        # unhandled engine exception is an organic crash)
        active = [r for r in self.replicas
                  if r.state == SERVING and not r.stalled]
        stepping = [r for r in active if r.has_work()]
        if self.step_parallel and len(stepping) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=len(self.replicas))
            errs = list(self._pool.map(self._step_one, stepping))
        else:
            errs = [self._step_one(r) for r in stepping]
        for r, err in zip(stepping, errs):
            if err is not None:
                self._fail(r, "crash")
        beat_t = self.clock()
        for r in active:
            if r.state != SERVING:
                continue                 # crashed while stepping
            r.last_beat_tick = t
            r.last_beat_t = beat_t
        # 5. pump tokens + terminal states (replica order: deterministic
        # journal), then 6. invariants on every surviving pool
        for r in self.replicas:
            if r.state == SERVING and not r.stalled:
                self._pump(r)
        if self.check_invariants_each_tick:
            for r in self.replicas:
                if r.state == SERVING:
                    check_invariants(r.engine.pool, r.engine.prefix_cache)
        # 7. periodic durability: snapshot every replica + anchor the
        # journal AFTER the pump, so the snapshot and the journaled
        # streams describe the same instant
        if (self.snapshot_dir and self.snapshot_every > 0 and
                (t + 1) % self.snapshot_every == 0):
            self.save_snapshots()
        self.ticks += 1

    @staticmethod
    def _step_one(replica: ReplicaHandle) -> Optional[Exception]:
        try:
            replica.engine.step()
            replica.engine.drain()
        except Exception as e:          # noqa: BLE001 — any engine death
            return e                    # is a replica crash
        return None

    def _pump(self, replica: ReplicaHandle) -> None:
        """Publish this replica's freshly materialized tokens and terminal
        states to the journal + tracker. Token progress is read from the
        engine Request handles by POSITION (fleet position = resume_base +
        engine index), so an engine-internal preemption-recompute — which
        resets the handle's token list and regenerates the identical
        greedy prefix — never re-streams tokens the client already has."""
        for treq in self.tracker.assigned_to(replica.idx):
            asg = treq.assignment
            have = len(treq.tokens)
            total = asg.resume_base + len(asg.handle.tokens)
            if total > have:
                new = [int(x) for x in
                       asg.handle.tokens[have - asg.resume_base:]]
                if self.journal is not None:
                    self.journal.append("token", rid=treq.rid,
                                        replica=replica.idx, pos=have,
                                        toks=new)
                self.tracker.on_tokens(treq, new)
        for erid, req in replica.engine.pop_finished().items():
            treq = self._engine_map.pop(erid, None)
            if treq is None or req.finish_reason == FINISH_FAILOVER:
                continue                 # revoked after failover, or not ours
            if treq.state == DONE:
                continue
            self._terminal(treq, req.finish_reason)

    # -- durability --------------------------------------------------------

    def save_snapshots(self) -> List[Dict]:
        """Write an atomic snapshot of every serving replica to the
        snapshot dir, then append a snapshot-anchor record to the journal
        (replay cost from the anchor on is bounded by the suffix).
        Stalled/hung replicas are skipped — their device state is
        unreadable; their requests fail over anyway."""
        from repro_torch.serve.snapshot import write_snapshot

        if not self.snapshot_dir:
            raise ValueError("supervisor has no snapshot_dir")
        os.makedirs(self.snapshot_dir, exist_ok=True)
        infos = []
        for r in self.replicas:
            if r.state != SERVING or r.stalled:
                continue
            infos.append(write_snapshot(
                r.engine, snapshot_path(self.snapshot_dir, r.idx)))
            self.c_snapshots.inc()
        if self.journal is not None:
            self.journal.anchor(tick=self.ticks,
                                replicas=[i["path"] for i in infos])
        return infos

    @classmethod
    def resume(cls, engine_factory: Callable[[], object], n_replicas: int,
               journal_path: str,
               snapshot_dir: Optional[str] = None,
               journal: Optional[Journal] = None,
               **kwargs) -> "FleetSupervisor":
        """Rebuild a fleet after process death: snapshot + journal-suffix
        recovery.

        Per replica, the recovery ladder is: read + apply + fsck the
        snapshot (warm start — the radix tree and pools survive, so
        shared prefixes re-hit instead of re-prefilling); on checksum,
        fingerprint, or invariant failure fall back to a cold engine from
        the factory.  The journal is then the authoritative request
        record: it is loaded with ``strict=False`` (a crash-torn tail
        drops only the unsynced suffix, counted in
        ``journal_tail_lost_total``), replayed from its last anchor, and
        every journaled request is adopted — terminal ones resolve
        immediately with their journaled streams; in-flight ones resubmit
        through the recompute contract (``[prompt ‖ emitted]``,
        position-based dedup), which regenerates the byte-identical
        remainder because greedy decode is deterministic.

        ``journal`` is the NEW journal for the resumed process; its first
        record is a seeding anchor embedding the recovered state, so the
        new journal replays standalone.  Requires the prior journal to
        have logged prompts (``log_prompts=True``) if any request was
        still in flight.
        """
        from repro_torch.serve.snapshot import requeue_inflight, restore_engine

        old = Journal.load(journal_path, strict=False)
        st = old.replay(from_anchor=True)

        engines, restore_info = [], []
        for i in range(n_replicas):
            spath = (snapshot_path(snapshot_dir, i)
                     if snapshot_dir else None)
            engine, _specs, info = restore_engine(engine_factory, spath)
            if info["mode"] == "warm":
                # journal is authoritative for request state: drop the
                # snapshot's queues (publishing their generated KV into
                # the radix tree first — that's the warm-restart payoff)
                # and let the adoption path below resubmit
                requeue_inflight(engine)
            engines.append(engine)
            restore_info.append(dict(info, replica=i))

        sup = cls(engines, journal=journal,
                  snapshot_dir=snapshot_dir, **kwargs)
        sup.restore_info = restore_info
        if old.tail_lost:
            sup.tracker.c_tail_lost.inc(old.tail_lost)
        if sup.journal is not None:
            # seeding anchor: the new journal replays standalone
            sup.journal.append("snapshot", digest=state_digest(st),
                               resumed_from=journal_path,
                               tail_lost=old.tail_lost)

        for rid in sorted(st.requests):
            r = st.requests[rid]
            if not r.finish_reason and r.prompt is None:
                raise ValueError(
                    f"request {rid} was in flight but the journal did not "
                    f"log prompts; resume needs Journal(log_prompts=True)")
            treq = sup.tracker.adopt(
                rid, np.asarray(r.prompt if r.prompt is not None else [],
                                np.int32),
                r.max_new, r.tokens, finish_reason=r.finish_reason,
                n_failovers=r.n_failovers)
            if not r.finish_reason:
                sup._try_place(treq, reason="restore")
        return sup

    # -- drive + observability --------------------------------------------

    def run_until_drained(self, max_ticks: int = 100_000) -> None:
        while self.tracker.has_work():
            if self.ticks >= max_ticks:
                raise RuntimeError(
                    f"fleet did not drain within {max_ticks} ticks")
            self.tick()

    def collect_metrics(self, prefix: str = ""):
        """Fleet-aggregated registry: every replica's telemetry registry
        (dead replicas included — their history is still truth) folded
        with the tracker's fleet registry via MetricRegistry.collect."""
        from repro_torch.serve.metrics import MetricRegistry
        regs = [r.engine.telemetry.registry for r in self.replicas
                if r.engine.telemetry is not None]
        regs.append(self.tracker.registry)
        return MetricRegistry().collect(*regs, prefix=prefix)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self.journal is not None:
            self.journal.close()
