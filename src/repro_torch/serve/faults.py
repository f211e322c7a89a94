"""Deterministic, seedable fault injection for the continuous serving engine.

Resilience work needs *reproducible* failure: a fault plan is a list of
``FaultSpec`` entries — each naming a fault kind and either a fixed step
window (``step``/``duration``) or a per-step probability (``prob``) — plus
one seed. ``FaultInjector`` evaluates the plan at every engine step with an
RNG derived from ``(seed, step, spec index)``, so the same plan replays the
same faults bit-for-bit regardless of wall time or host state, and a replay
artifact (``save_log``) records exactly what fired where.

The JAX package's ``repro.serve.faults`` on the port: host code only, so
the same plan makes the same decisions, and the same log, in both
packages. The injector threads through the serving stack behind ONE
nullable hook per component, the pattern of the engine's telemetry
(``faults=None`` keeps every hot path at a single ``is not None`` check):

* ``ContinuousEngine.step()``  — drives ``begin_step``; applies pool
  pressure (steals free blocks under the sentinel request id ``FAULT_REQ``
  so the *real* eviction/preemption machinery feels the squeeze), stalls
  for slow/hung steps, forces preemption storms, raises transient step
  faults (retried with backoff), corrupts the KV scatter of a completing
  prefill, and feeds injected numerics spikes to the guard.
* ``Scheduler.admit()``        — returns empty while an admission stall is
  active.
* ``PagedKVCache.append_block`` — raises ``TransientFault`` while a
  ``step_fault`` window is active (the engine's retry-with-backoff path;
  the hook fires *before* any pool state mutates, so a retry is safe).

Fault taxonomy (``FAULT_KINDS``):

``pool_pressure``   steal ``magnitude`` (fraction of the pool) free blocks
                    for ``duration`` steps — exercises cache eviction,
                    admission back-off and preemption under real scarcity.
``admit_stall``     scheduler admits nothing for ``duration`` steps.
``slow_step``       stall ``magnitude`` seconds at step start.
``hung_step``       like slow_step but sized to trip the guard's
                    step-time watchdog.
``preempt_storm``   force-preempt the ``magnitude`` youngest decoding
                    requests at step start.
``step_fault``      the next ``duration`` block-growth attempts raise
                    ``TransientFault`` (bounded retry-with-backoff).
``kv_corrupt``      corrupt the exclusively-owned KV blocks of the next
                    prefill that completes while the window is active
                    (silent data corruption; the guard's scatter-readback
                    audit is what catches it).
``numerics_spike``  inject a logit-error reading of ``magnitude`` into the
                    guard signal for ``duration`` steps.

Fleet kinds (part of the plan format; consumed per fleet tick by the
fleet supervisor, which the port does not have yet; ``magnitude`` names
the victim replica index):

``replica_crash``   the replica dies at the window's opening tick: its
                    engine is abandoned and every in-flight request is
                    re-placed on a survivor.
``replica_hang``    the replica's device stops responding for ``duration``
                    ticks: the supervisor's step-watchdog declares it hung
                    after the heartbeat grace, fails its requests over,
                    and readmits the replica (empty) once it resumes.

All decisions happen in ``begin_step``; the per-site hooks only consume
them. Everything is host-side; the only device work a fault can cause is
the ``kv_corrupt`` block rewrite, performed by the engine.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

# Sentinel request id the injector's stolen pool-pressure blocks are
# allocated under. Negative so it can never collide with a real request.
FAULT_REQ = -1

# Engine-level kinds are consumed inside ContinuousEngine.step(); fleet
# kinds are consumed by the FleetSupervisor's per-tick poll (the engine
# never sees them — a whole replica crashing or hanging is not something
# the replica itself can observe).
ENGINE_FAULT_KINDS = ("pool_pressure", "admit_stall", "slow_step",
                      "hung_step", "preempt_storm", "step_fault",
                      "kv_corrupt", "numerics_spike")
FLEET_FAULT_KINDS = ("replica_crash", "replica_hang")
FAULT_KINDS = ENGINE_FAULT_KINDS + FLEET_FAULT_KINDS


class TransientFault(RuntimeError):
    """A recoverable injected failure: the operation is expected to
    succeed if retried (the engine wraps the affected sites in bounded
    retry-with-backoff). Deliberately NOT a ``PoolExhausted`` subclass —
    exhaustion handling (evict/preempt) is the wrong response to a
    transient glitch."""


@dataclasses.dataclass
class FaultSpec:
    """One fault source. Fires at step ``step`` (for ``duration`` steps)
    when ``step`` is set; otherwise fires each step with probability
    ``prob`` (windows of ``duration`` steps, non-overlapping per spec).
    ``magnitude`` is kind-specific: pool fraction (pool_pressure), seconds
    (slow/hung_step), request count (preempt_storm), injected logit error
    (numerics_spike); unused otherwise."""

    kind: str
    step: Optional[int] = None
    prob: float = 0.0
    duration: int = 1
    magnitude: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.step is None and self.prob <= 0.0:
            raise ValueError(f"{self.kind}: need step index or prob > 0")
        if self.duration < 1:
            raise ValueError(f"{self.kind}: duration must be >= 1")


@dataclasses.dataclass
class FaultPlan:
    """A seed plus the fault specs. JSON round-trips for --fault-plan
    files and the CI replay artifact."""

    seed: int = 0
    specs: List[FaultSpec] = dataclasses.field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "specs": [dataclasses.asdict(s)
                                     for s in self.specs]},
                          indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(seed=int(d.get("seed", 0)),
                   specs=[FaultSpec(**s) for s in d.get("specs", [])])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def canned_plan(seed: int = 7) -> FaultPlan:
    """The reference fault plan the resilience benchmark and the CI chaos
    smoke run: one of every ENGINE kind, step-indexed so the guarded and
    the unguarded runs face the *identical* storm (fleet kinds live in
    ``canned_fleet_plan`` — an engine cannot injure its own replica)."""
    return FaultPlan(seed=seed, specs=[
        FaultSpec("kv_corrupt", step=2, duration=2),
        FaultSpec("admit_stall", step=5, duration=2),
        FaultSpec("pool_pressure", step=8, duration=3, magnitude=0.5),
        FaultSpec("step_fault", step=12, duration=2),
        FaultSpec("slow_step", step=14, duration=1, magnitude=0.005),
        FaultSpec("preempt_storm", step=17, duration=1, magnitude=2),
        FaultSpec("numerics_spike", step=20, duration=2, magnitude=0.75),
        FaultSpec("hung_step", step=24, duration=1, magnitude=0.02),
    ])


def canned_fleet_plan(seed: int = 11, crash_tick: int = 10,
                      crash_replica: int = 0,
                      hang_tick: Optional[int] = 22, hang_ticks: int = 4,
                      hang_replica: int = 1) -> FaultPlan:
    """The reference FLEET fault plan (fleet bench + CI fleet chaos
    smoke): replica ``crash_replica`` dies at tick ``crash_tick``;
    optionally replica ``hang_replica`` goes unresponsive for
    ``hang_ticks`` ticks starting at ``hang_tick`` (None disables the
    hang). Tick indices are fleet supervision ticks, not engine steps."""
    specs = [FaultSpec("replica_crash", step=crash_tick,
                       magnitude=crash_replica)]
    if hang_tick is not None:
        specs.append(FaultSpec("replica_hang", step=hang_tick,
                               duration=hang_ticks,
                               magnitude=hang_replica))
    return FaultPlan(seed=seed, specs=specs)


class FaultInjector:
    """Evaluates a ``FaultPlan`` step by step. Deterministic: every
    probabilistic decision draws from an RNG seeded with
    ``(plan.seed, step, spec index)``, so two runs over the same plan and
    step sequence inject identically. ``log`` records every injection
    (the replay artifact); the engine appends per-fault details (e.g. the
    req_id/blocks a kv_corrupt hit)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.log: List[Dict] = []
        self.faults_injected = 0
        self.reset()

    def reset(self) -> None:
        """Forget all window/consumption state (new serving run)."""
        self.step_idx = -1
        self._fired: Dict[str, FaultSpec] = {}
        # spec index -> first step of the currently-active window
        self._windows: Dict[int, int] = {}
        self._step_fault_raises = 0   # TransientFaults left to raise
        self._kv_corrupt_armed = False
        self._crash_pending: List[int] = []   # replica idx, until consumed
        self._hung_replicas: set = set()      # replica idx, this tick
        self.log.clear()
        self.faults_injected = 0

    # -- per-step evaluation ----------------------------------------------

    def _active(self, idx: int, spec: FaultSpec, step: int) -> bool:
        """Is ``spec`` active at ``step``? Fixed-step specs are active on
        [step, step+duration); probabilistic specs open a ``duration``-step
        window when their per-step coin lands (windows don't overlap)."""
        if spec.step is not None:
            return spec.step <= step < spec.step + spec.duration
        w0 = self._windows.get(idx)
        if w0 is not None and step < w0 + spec.duration:
            return True
        rng = np.random.default_rng(
            (self.plan.seed, step, idx))          # deterministic per-site
        if rng.random() < spec.prob:
            self._windows[idx] = step
            return True
        return False

    def begin_step(self, step: int, telemetry=None) -> None:
        """Evaluate every spec for this step; called by the engine at the
        top of ``step()``. New firings are logged and counted (and
        reported to telemetry's ``fault_injected_total`` when attached)."""
        self.step_idx = step
        self._fired: Dict[str, FaultSpec] = {}
        self._hung_replicas = set()
        for idx, spec in enumerate(self.plan.specs):
            if not self._active(idx, spec, step):
                continue
            self._fired[spec.kind] = spec
            if spec.kind == "replica_hang":
                self._hung_replicas.add(int(spec.magnitude))
            opening = (spec.step == step if spec.step is not None
                       else self._windows.get(idx) == step)
            if opening:
                if spec.kind == "step_fault":
                    self._step_fault_raises = spec.duration
                if spec.kind == "kv_corrupt":
                    self._kv_corrupt_armed = True
                if spec.kind == "replica_crash":
                    self._crash_pending.append(int(spec.magnitude))
                self.record(spec.kind, step=step,
                            duration=spec.duration,
                            magnitude=spec.magnitude)
                if telemetry is not None:
                    telemetry.on_fault(spec.kind, step,
                                       magnitude=spec.magnitude)

    def record(self, kind: str, **details) -> None:
        """Append one replay-log entry (the engine adds per-fault details
        like kv_corrupt victims through this too)."""
        self.log.append(dict(kind=kind, **details))
        self.faults_injected += 1

    # -- consumption hooks (engine / scheduler / pool) --------------------

    def pool_pressure_target(self, num_blocks: int) -> int:
        """Blocks the injector wants held hostage right now (0 = release
        any currently held)."""
        spec = self._fired.get("pool_pressure")
        if spec is None:
            return 0
        return max(1, int(spec.magnitude * num_blocks))

    def admission_stalled(self) -> bool:
        return "admit_stall" in self._fired

    def stall_seconds(self) -> float:
        s = self._fired.get("slow_step")
        h = self._fired.get("hung_step")
        return (s.magnitude if s else 0.0) + (h.magnitude if h else 0.0)

    def hung(self) -> bool:
        return "hung_step" in self._fired

    def preempt_storm_count(self) -> int:
        spec = self._fired.get("preempt_storm")
        return int(spec.magnitude) if spec is not None else 0

    def check_step_fault(self) -> None:
        """Raise ``TransientFault`` while raises remain in the active
        step_fault window; each call consumes one raise, so bounded retry
        eventually succeeds."""
        if self._step_fault_raises > 0 and "step_fault" in self._fired:
            self._step_fault_raises -= 1
            raise TransientFault(
                f"injected step fault at step {self.step_idx} "
                f"({self._step_fault_raises} raises left)")

    def on_append_block(self, req_id: int) -> None:
        """PagedKVCache.append_block hook: same transient-fault budget as
        the step-level probe, surfaced at the block-growth site (fires
        BEFORE the pool mutates, so the engine's retry is safe)."""
        self.check_step_fault()

    def take_kv_corrupt(self) -> bool:
        """True exactly once per kv_corrupt window: the engine corrupts
        the prefill that completes next."""
        if self._kv_corrupt_armed and "kv_corrupt" in self._fired:
            self._kv_corrupt_armed = False
            return True
        return False

    def numerics_spike(self) -> float:
        spec = self._fired.get("numerics_spike")
        return spec.magnitude if spec is not None else 0.0

    # -- consumption hooks (fleet supervisor) -----------------------------

    def take_replica_crashes(self) -> List[int]:
        """Replica indices whose crash window opened since the last call
        (consumed once: a replica only dies one time)."""
        out, self._crash_pending = self._crash_pending, []
        return out

    def replica_hang_targets(self) -> "set":
        """Replica indices whose device is unresponsive this tick (the
        supervisor's drive loop skips stepping them; detection is the
        step-watchdog's job, not this hook's)."""
        return set(self._hung_replicas)

    # -- replay artifact ---------------------------------------------------

    def save_log(self, path: str) -> None:
        """Write the replay artifact: the plan plus every injection that
        fired, as one JSON document."""
        with open(path, "w") as f:
            json.dump({"plan": json.loads(self.plan.to_json()),
                       "injections": self.log}, f, indent=2)
            f.write("\n")

    def corrupted_req_ids(self) -> List[int]:
        """Request ids whose KV the engine corrupted (from the log)."""
        return [e["req_id"] for e in self.log
                if e["kind"] == "kv_corrupt" and "req_id" in e]
