"""Replica placement for the fleet front end — the JAX package's
``repro.serve.router`` on the port (host code only, so the same replica
states give the same decisions in both packages).

Two policies:

``affinity`` (default) — radix-cache prefix affinity: each candidate
replica is scored by ``engine.prefix_cache.lookup(prompt)``, the longest
already-cached prefix its radix tree can serve (a read-only walk; no pins,
no side effects). The replica with the longest hit wins: prefill skips
those tokens and the shared-prefix blocks are reused copy-on-write, so
tenant traffic colocates. Ties (including the cold all-zeros case) fall
back to load (fewest queued + running requests), then to the largest
evictable budget (free blocks plus evictable cached blocks — the headroom
a new trajectory can claim).

``round-robin`` — rotate over accepting replicas; the bench baseline
affinity is gated against.

Health gating applies to both policies, from the replica's ``EngineGuard``
plus the supervisor's liveness view: dead or hung replicas are skipped,
SHEDDING replicas are skipped (their front door raises
``EngineSheddingError`` anyway), and DEGRADED replicas are demoted — a
healthy replica always wins over a degraded one whatever the affinity.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serve.guard import DEGRADED, SHEDDING

ROUTING_POLICIES = ("affinity", "round-robin")


@dataclasses.dataclass
class PlacementDecision:
    """One routing decision (kept for forensics and tests)."""

    replica: int
    policy: str
    affinity_tokens: int = 0
    load: int = 0
    budget: int = 0
    demoted: bool = False      # placed on a DEGRADED replica


class Router:
    """Stateless scoring over the live replica set (the one mutable bit is
    the round-robin cursor). ``place`` returns the chosen replica handle or
    None when no replica is accepting."""

    def __init__(self, policy: str = "affinity"):
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"expected one of {ROUTING_POLICIES}")
        self.policy = policy
        self.decisions: List[PlacementDecision] = []
        self._rr_next = 0

    # -- scoring -----------------------------------------------------------

    @staticmethod
    def _accepting(replica) -> bool:
        if not replica.accepting:
            return False
        guard = replica.engine.guard
        return guard is None or guard.state != SHEDDING

    @staticmethod
    def _health_rank(replica) -> int:
        guard = replica.engine.guard
        return 1 if (guard is not None and guard.state == DEGRADED) else 0

    @staticmethod
    def _affinity(replica, prompt: np.ndarray) -> int:
        cache = replica.engine.prefix_cache
        return cache.lookup(prompt) if cache is not None else 0

    @staticmethod
    def _load(replica) -> int:
        sched = replica.engine.sched
        return len(sched.waiting) + len(sched.running)

    @staticmethod
    def _budget(replica) -> int:
        eng = replica.engine
        free = eng.pool.num_free
        if eng.prefix_cache is not None:
            free += eng.prefix_cache.evictable_blocks()
        return free

    def place(self, prompt: np.ndarray, replicas) -> Optional[object]:
        """Choose a replica for ``prompt`` among ``replicas`` (a list of
        supervisor ``ReplicaHandle``s). Returns the handle, or None when
        the whole fleet is refusing work (the caller backs off and
        retries)."""
        cands = [r for r in replicas if self._accepting(r)]
        if not cands:
            return None
        if self.policy == "round-robin":
            order = sorted(cands, key=lambda r: (
                (r.idx - self._rr_next) % (max(r.idx for r in cands) + 1),
                r.idx))
            best = order[0]
            self._rr_next = best.idx + 1
            self.decisions.append(PlacementDecision(
                best.idx, self.policy, load=self._load(best),
                demoted=self._health_rank(best) > 0))
            return best
        scored = sorted(
            cands,
            key=lambda r: (self._health_rank(r),
                           -self._affinity(r, prompt),
                           self._load(r),
                           -self._budget(r),
                           r.idx))
        best = scored[0]
        self.decisions.append(PlacementDecision(
            best.idx, self.policy,
            affinity_tokens=self._affinity(best, prompt),
            load=self._load(best), budget=self._budget(best),
            demoted=self._health_rank(best) > 0))
        return best
