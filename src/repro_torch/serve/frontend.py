"""Asyncio front end for the replica fleet: per-request token streams,
typed terminal results, and the fleet-level request tracker — the JAX
package's ``repro.serve.frontend`` on the port (host code only).

Shape follows the async-engine pattern ColossalAI popularized (an
``AsyncStream`` per request fed by a background engine loop, owned by a
``RequestTracker``), adapted to this repo's synchronous, deterministic
engines: the tracker itself is plain synchronous state (so the fleet is
drivable tick-by-tick from tests and benches with a ManualClock), and
``AsyncFrontend`` is the thin asyncio skin that drives supervision ticks
cooperatively and lets clients ``async for`` tokens.

The tracker is also where cross-replica migration is made right: the
FLEET lifecycle stamps (``t_submit``, ``t_first_token``, ``t_finish``)
belong to the tracked request, not to any replica's telemetry, so TTFT is
observed exactly once fleet-wide and E2E always measures from the client's
original submit — no matter how many replicas a request visited.
Per-replica telemetry keeps its own (engine-local) view; the engine-side
half is the ``ttft_observed`` migration stamp threaded through submit.
"""
from __future__ import annotations

import asyncio
import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.serve.metrics import MetricRegistry
from repro_torch.serve.scheduler import FINISH_LENGTH, Request

# fleet-level request states
PENDING, PLACED, DONE = "pending", "placed", "done"


@dataclasses.dataclass
class RequestResult:
    """Typed terminal result of one fleet request (what ``AsyncStream``
    resolves to). ``finish_reason`` uses the scheduler's FINISH_* values
    plus "rejected" (the fleet gave up placing it)."""

    req_id: int
    tokens: List[int]
    finish_reason: str
    n_failovers: int = 0
    replicas: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_finish: float = 0.0

    @property
    def ok(self) -> bool:
        return self.finish_reason == FINISH_LENGTH

    @property
    def e2e(self) -> float:
        return self.t_finish - self.t_submit


class AsyncStream:
    """Per-request token stream. The supervisor feeds it synchronously
    (``put``/``close``); clients consume either asynchronously
    (``async for token in stream`` then ``stream.result()``) or
    synchronously (``drain_nowait``/``result`` after the fleet drains).
    Single-loop discipline: produced and consumed on the same thread (the
    asyncio loop), so a deque + wakeup event suffices — no locking."""

    def __init__(self, req_id: int):
        self.req_id = req_id
        self._buf: Deque[int] = deque()
        self._result: Optional[RequestResult] = None
        self._event: Optional[asyncio.Event] = None   # lazy: created in
        #                                               async context only

    # -- producer side (tracker/supervisor) --------------------------------

    def put(self, tokens: List[int]) -> None:
        self._buf.extend(tokens)
        self._wake()

    def close(self, result: RequestResult) -> None:
        self._result = result
        self._wake()

    def _wake(self) -> None:
        if self._event is not None:
            self._event.set()

    # -- consumer side -----------------------------------------------------

    @property
    def finished(self) -> bool:
        return self._result is not None

    def result(self) -> Optional[RequestResult]:
        return self._result

    def drain_nowait(self) -> List[int]:
        out = list(self._buf)
        self._buf.clear()
        return out

    def __aiter__(self) -> "AsyncStream":
        return self

    async def __anext__(self) -> int:
        while True:
            if self._buf:
                return self._buf.popleft()
            if self._result is not None:
                raise StopAsyncIteration
            if self._event is None:
                self._event = asyncio.Event()
            self._event.clear()
            await self._event.wait()


@dataclasses.dataclass
class Assignment:
    """Where a tracked request currently runs: the replica index, the
    engine-side request id/handle, and ``resume_base`` — how many fleet
    tokens had already streamed when this placement's recompute prompt
    was built (engine token i is fleet position ``resume_base + i``)."""

    replica: int
    engine_rid: int
    handle: Request
    resume_base: int


@dataclasses.dataclass
class TrackedRequest:
    """Fleet-side state of one request: the authoritative client stream
    (``tokens``), the fleet lifecycle stamps, and the current placement."""

    rid: int
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    ttft_budget_s: Optional[float] = None
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    stream: AsyncStream = None
    state: str = PENDING
    assignment: Optional[Assignment] = None
    attempts: int = 0                 # placements tried (incl. rejected)
    n_failovers: int = 0
    replicas: List[int] = dataclasses.field(default_factory=list)
    next_retry_tick: int = 0          # pending-queue backoff gate
    result: Optional[RequestResult] = None

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.tokens)

    def recompute_prompt(self) -> np.ndarray:
        """The failover prompt ``[prompt ‖ tokens-emitted-so-far]``:
        greedy decode is deterministic, so a survivor prefilling this and
        generating ``remaining`` tokens continues the stream byte-
        identically to the unfailed run."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


class RequestTracker:
    """Owns every fleet request: streams, fleet lifecycle stamps, and the
    fleet-level metric registry (``fleet_*`` names, so they coexist with
    per-replica ``serve_*`` metrics inside one collected registry)."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        import time
        self.clock = clock or time.monotonic
        self.requests: Dict[int, TrackedRequest] = {}
        self.registry = MetricRegistry()
        r = self.registry
        self.c_submitted = r.counter(
            "fleet_requests_submitted_total", "requests accepted fleet-wide")
        self.c_completed = r.counter(
            "fleet_requests_completed_total", "requests finished (length)")
        self.c_failed = r.counter(
            "fleet_requests_failed_total",
            "requests with a non-length terminal (deadline/cancel/...)")
        self.c_failovers = r.counter(
            "fleet_failovers_total",
            "request re-placements caused by replica crash/hang")
        self.c_retries = r.counter(
            "fleet_placement_retries_total",
            "placement retries after a shed or a full fleet")
        self.c_tokens = r.counter(
            "fleet_tokens_streamed_total", "tokens delivered to clients")
        self.h_ttft = r.histogram(
            "fleet_ttft_seconds",
            "submit -> first token, fleet-wide (observed once per request "
            "regardless of migrations)")
        self.h_e2e = r.histogram(
            "fleet_e2e_seconds",
            "submit -> finish from the ORIGINAL submit (completions only)")
        self.c_recovered = r.counter(
            "fleet_requests_recovered_total",
            "requests adopted from a prior process's journal at resume")
        self.c_tail_lost = r.counter(
            "journal_tail_lost_total",
            "journal records dropped during crash recovery (torn tail)")
        self._next_rid = 0

    # -- lifecycle ---------------------------------------------------------

    def create(self, prompt: np.ndarray, max_new: int,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               ttft_budget_s: Optional[float] = None) -> TrackedRequest:
        rid = self._next_rid
        self._next_rid += 1
        treq = TrackedRequest(rid, np.asarray(prompt, np.int32), max_new,
                              temperature, deadline_s=deadline_s,
                              ttft_budget_s=ttft_budget_s,
                              t_submit=self.clock(),
                              stream=AsyncStream(rid))
        self.requests[rid] = treq
        self.c_submitted.inc()
        return treq

    def adopt(self, rid: int, prompt: np.ndarray, max_new: int,
              tokens: List[int], finish_reason: str = "",
              n_failovers: int = 0,
              temperature: float = 0.0) -> TrackedRequest:
        """Re-create a request from a prior process's journal, keeping its
        rid.  Terminal requests (``finish_reason`` set) are resolved
        immediately with the journaled stream; in-flight ones carry their
        already-streamed tokens (``t_first_token`` pre-stamped so TTFT is
        never observed twice — monotonic stamps don't survive process
        death, so cross-process latency is not re-measured) and are ready
        for placement through the failover path."""
        if rid in self.requests:
            raise ValueError(f"request {rid} already tracked")
        treq = TrackedRequest(rid, np.asarray(prompt, np.int32), max_new,
                              temperature, t_submit=self.clock(),
                              stream=AsyncStream(rid))
        treq.tokens = list(tokens)
        treq.n_failovers = n_failovers
        if treq.tokens:
            treq.t_first_token = treq.t_submit  # suppress double TTFT
            treq.stream.put(list(treq.tokens))
        self.requests[rid] = treq
        self._next_rid = max(self._next_rid, rid + 1)
        self.c_recovered.inc()
        if finish_reason:
            treq.state = DONE
            treq.t_finish = self.clock()
            treq.result = RequestResult(
                rid, list(treq.tokens), finish_reason,
                n_failovers=n_failovers, replicas=[],
                t_submit=treq.t_submit, t_finish=treq.t_finish)
            treq.stream.close(treq.result)
        return treq

    def on_tokens(self, treq: TrackedRequest, tokens: List[int]) -> None:
        """Append freshly streamed tokens; the FIRST ever token (across
        all placements) stamps fleet TTFT exactly once."""
        if not tokens:
            return
        if not treq.t_first_token:
            treq.t_first_token = self.clock()
            self.h_ttft.observe(treq.t_first_token - treq.t_submit)
        treq.tokens.extend(tokens)
        self.c_tokens.inc(len(tokens))
        treq.stream.put(tokens)

    def on_terminal(self, treq: TrackedRequest, reason: str) -> None:
        """Resolve the request with its typed terminal result. E2E is
        observed from the ORIGINAL submit, completions only (matching the
        per-replica telemetry convention)."""
        if treq.state == DONE:
            return
        treq.state = DONE
        treq.assignment = None
        treq.t_finish = self.clock()
        if reason == FINISH_LENGTH:
            self.c_completed.inc()
            self.h_e2e.observe(treq.t_finish - treq.t_submit)
        else:
            self.c_failed.inc()
        treq.result = RequestResult(
            treq.rid, list(treq.tokens), reason,
            n_failovers=treq.n_failovers, replicas=list(treq.replicas),
            t_submit=treq.t_submit, t_finish=treq.t_finish)
        treq.stream.close(treq.result)

    # -- queries -----------------------------------------------------------

    def live(self) -> List[TrackedRequest]:
        return [t for t in self.requests.values() if t.state != DONE]

    def assigned_to(self, replica: int) -> List[TrackedRequest]:
        return [t for t in self.requests.values()
                if t.assignment is not None
                and t.assignment.replica == replica]

    def has_work(self) -> bool:
        return any(t.state != DONE for t in self.requests.values())


class AsyncFrontend:
    """The asyncio skin over a FleetSupervisor: ``submit`` returns the
    request's ``AsyncStream``; one ``run()`` task drives supervision
    ticks cooperatively (yielding to consumers between ticks) until the
    fleet drains and the front-end is closed."""

    def __init__(self, supervisor):
        self.supervisor = supervisor
        self._closed = False

    async def submit(self, prompt: np.ndarray, max_new: int,
                     temperature: float = 0.0,
                     deadline_s: Optional[float] = None,
                     ttft_budget_s: Optional[float] = None) -> AsyncStream:
        treq = self.supervisor.submit(
            prompt, max_new, temperature, deadline_s=deadline_s,
            ttft_budget_s=ttft_budget_s)
        return treq.stream

    def close(self) -> None:
        """No more submissions: run() exits once in-flight work drains."""
        self._closed = True

    async def run(self, max_ticks: int = 100_000) -> None:
        ticks = 0
        while not (self._closed and not self.supervisor.has_work()):
            if self.supervisor.has_work():
                self.supervisor.tick()
                ticks += 1
                if ticks > max_ticks:
                    raise RuntimeError(
                        f"fleet did not drain within {max_ticks} ticks")
            await asyncio.sleep(0)

    async def run_until_drained(self, max_ticks: int = 100_000) -> None:
        self.close()
        await self.run(max_ticks=max_ticks)
