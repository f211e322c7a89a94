"""Graceful-degradation ladder for the continuous serving engine.

``EngineGuard`` is a three-state machine driven once per engine step by a
``GuardSignals`` snapshot assembled from the engine's observability
signals (pool utilization, audited logit error, queue wait, step-time
watchdog):

    HEALTHY ──signals degrade──► DEGRADED ──signals degrade──► SHEDDING
        ▲                            │  ▲                          │
        └──── recover_steps clean ───┘  └──── recover_steps clean ─┘

* **HEALTHY** — no intervention.
* **DEGRADED** — the engine shrinks its per-step prefill budget and
  admission cap (``prefill_budget_factor`` / ``max_admit_factor``), easing
  pool and step-time pressure while existing requests keep full service.
* **SHEDDING** — new submissions are refused (``EngineSheddingError``,
  counted in ``requests_shed_total``) and admission pauses entirely;
  running requests drain, freeing the resources that tripped the ladder.

Escalation is immediate (the observed severity wins the step); recovery is
hysteretic — the guard steps DOWN one level only after ``recover_steps``
consecutive observations strictly below the current level, so a flapping
signal can't oscillate the engine.

**Quarantine** is the per-request arm of the same policy: a request whose
audited logit error exceeds ``quarantine_error`` (the engine's
scatter-readback audit compares re-read pool KV against the just-computed
prefill logits — silent KV corruption shows up as a huge delta, ordinary
int8 quantization error stays under the int8 pool's logit-error bound)
is cancelled and its published radix-tree nodes purged, so poisoned KV can
never serve a later prefix hit. See ``ContinuousEngine._quarantine`` /
``RadixCache.purge``.

All host-side, O(1) per step; the guard owns no engine state — the engine
*asks* it for effective knob values, keeping policy and mechanism apart.
The JAX package's ``repro.serve.guard`` on the port: the same signals give
the same states and knobs in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

HEALTHY, DEGRADED, SHEDDING = "healthy", "degraded", "shedding"
GUARD_STATES = (HEALTHY, DEGRADED, SHEDDING)


class EngineSheddingError(RuntimeError):
    """submit() refused: the guard is in SHEDDING state. Back off and
    retry; the guard recovers automatically once signals clear.
    ``retry_after_steps`` is the machine-readable hint: the number
    of clean engine steps still required before the guard can step down
    out of SHEDDING and the front door reopens — a router/front-end should
    wait at least that many steps before re-offering work."""

    def __init__(self, msg: str, retry_after_steps: int = 1):
        super().__init__(msg)
        self.retry_after_steps = retry_after_steps


@dataclasses.dataclass
class GuardConfig:
    """Thresholds and knobs of the degradation ladder. The defaults suit
    the reduced-config CPU benches; production tunes them per deployment.
    A ``None`` threshold disables that signal."""

    # pool utilization (0..1) above which the ladder escalates
    pool_util_degraded: float = 0.88
    pool_util_shedding: float = 0.97
    # audited logit error (readback audit / numerics probe / injected
    # spike) above which the step counts as degraded
    logit_error_degraded: float = 0.25
    # per-request quarantine bound: cancel + purge when a request's own
    # readback audit exceeds this (>> the reduced models' int8 bound of
    # 0.1, << any real corruption). At full width bf16 logits reach a few
    # hundred, so the clean audit delta is larger: set it per deployment
    quarantine_error: float = 0.5
    # queue wait (seconds, oldest waiting request) thresholds
    queue_wait_degraded: Optional[float] = None
    queue_wait_shedding: Optional[float] = None
    # step-time watchdog: a step slower than this counts as hung
    step_time_hung_s: Optional[float] = None
    # consecutive clean observations required to step DOWN one level
    recover_steps: int = 3
    # knob shrink factors applied while DEGRADED or worse
    prefill_budget_factor: float = 0.5
    max_admit_factor: float = 0.5
    # run the scatter-readback KV-integrity audit after each completed
    # prefill (the quarantine detector; costs one 1-token suffix prefill)
    readback_audit: bool = True


@dataclasses.dataclass
class GuardSignals:
    """One step's health snapshot, assembled by the engine."""

    pool_util: float = 0.0
    logit_error: float = 0.0     # max audited/injected error this step
    queue_wait: float = 0.0      # oldest waiting request's wait (seconds)
    queue_depth: int = 0
    step_seconds: float = 0.0


_LEVEL = {HEALTHY: 0, DEGRADED: 1, SHEDDING: 2}
_STATE = {v: k for k, v in _LEVEL.items()}


class EngineGuard:
    """The HEALTHY → DEGRADED → SHEDDING state machine (module docstring).

    ``observe(signals, step)`` returns the ``(old, new, reason)``
    transition when one happened, else None. ``transitions`` keeps the
    full history for the bench/replay artifact."""

    def __init__(self, config: Optional[GuardConfig] = None):
        self.config = config or GuardConfig()
        self.state = HEALTHY
        self._clean_streak = 0
        self.transitions: List[Tuple[int, str, str, str]] = []
        self.last_reason = ""

    @property
    def level(self) -> int:
        return _LEVEL[self.state]

    # -- severity ----------------------------------------------------------

    def _severity(self, s: GuardSignals) -> Tuple[int, str]:
        """Map one signal snapshot to the ladder level it demands."""
        c = self.config
        if s.pool_util >= c.pool_util_shedding:
            return 2, f"pool_util {s.pool_util:.2f}"
        if c.queue_wait_shedding is not None and \
                s.queue_wait >= c.queue_wait_shedding:
            return 2, f"queue_wait {s.queue_wait:.3f}s"
        if s.pool_util >= c.pool_util_degraded:
            return 1, f"pool_util {s.pool_util:.2f}"
        if s.logit_error >= c.logit_error_degraded:
            return 1, f"logit_error {s.logit_error:.3f}"
        if c.queue_wait_degraded is not None and \
                s.queue_wait >= c.queue_wait_degraded:
            return 1, f"queue_wait {s.queue_wait:.3f}s"
        if c.step_time_hung_s is not None and \
                s.step_seconds >= c.step_time_hung_s:
            return 1, f"step_seconds {s.step_seconds:.3f}"
        return 0, ""

    def observe(self, signals: GuardSignals,
                step: int = -1) -> Optional[Tuple[str, str, str]]:
        """Feed one step's signals; escalate immediately, recover one
        level after ``recover_steps`` consecutive cleaner observations."""
        sev, reason = self._severity(signals)
        old = self.state
        if sev > self.level:
            self.state = _STATE[sev]
            self._clean_streak = 0
        elif sev < self.level:
            self._clean_streak += 1
            if self._clean_streak >= self.config.recover_steps:
                self.state = _STATE[self.level - 1]
                self._clean_streak = 0
                reason = f"recovered after {self.config.recover_steps} " \
                         f"clean steps"
        else:
            self._clean_streak = 0
        if self.state != old:
            self.last_reason = reason
            self.transitions.append((step, old, self.state, reason))
            return old, self.state, reason
        return None

    # -- policy queries (the engine asks; the guard never mutates it) -----

    def admit_allowed(self) -> bool:
        return self.state != SHEDDING

    def submit_allowed(self) -> bool:
        return self.state != SHEDDING

    def retry_after_steps(self) -> int:
        """Clean steps still needed before the current level can step down
        one rung (the ``recover_steps`` hysteresis minus the clean streak
        already banked). This is the ``EngineSheddingError`` backoff hint:
        while SHEDDING, submissions cannot succeed sooner."""
        return max(1, self.config.recover_steps - self._clean_streak)

    def effective_max_admit(self, base: int) -> int:
        if self.state == SHEDDING:
            return 0
        if self.state == DEGRADED:
            return max(1, int(base * self.config.max_admit_factor))
        return base

    def effective_prefill_budget(self, base: int) -> int:
        """Shrink the per-step prefill token budget while degraded. A base
        of 0 means "uncapped" — degraded mode still returns 0 (there is no
        number to shrink; the admission cap is the lever then)."""
        if base and self.state != HEALTHY:
            return max(1, int(base * self.config.prefill_budget_factor))
        return base

    def should_quarantine(self, logit_error: float) -> bool:
        return logit_error >= self.config.quarantine_error

    def reset(self) -> None:
        self.state = HEALTHY
        self._clean_streak = 0
        self.transitions.clear()
        self.last_reason = ""
