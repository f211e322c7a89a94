"""Grid planning for the paged decode kernel (K1).

``GridPlanner`` ranks a fixed candidate set of ``(kv_tile_blocks,
split_k)`` grids by the latency proxy ``estimate_seconds ∘
decode_launch_cost`` (``serve/kernel_costs.py``) on the actual batch
state — the lengths vector the kernel is about to attend and the bucketed
table width — and returns the argmin. Bigger kv tiles amortize per-step
overhead but round short rows' compute up to the tile and pad the table;
split-K shortens the long row's serial walk but multiplies padding and
merge work; which wins shifts with the batch.

The candidate set is closed at construction, and the knobs are layout,
not math: every choice computes the same attention (split-K reassociates
fp sums), so planning never changes what a request is served, up to that
rounding. The planner is pure host arithmetic and never touches a device.

Decisions are observable: with a metric registry (``serve/metrics.py``,
the engine passes its telemetry's) every decision lands in choice
counters, grid gauges and a predicted-seconds histogram, and
``observe_measured`` records the engine's measured decode step beside
the prediction. On the card that measurement is the host's dispatch time
of the whole eager decode step, not K1's device time, so the ratio
``autotune_pred_over_measured`` reads ~1e-3 there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.kernel_costs import (DEFAULT_COST_PARAMS, CostParams,
                                            LaunchCost, decode_launch_cost,
                                            estimate_seconds)

AUTOTUNE_MODES = ("off", "static", "per-step")


@dataclasses.dataclass(frozen=True)
class GridDecision:
    """One planning outcome: the chosen grid, its modeled cost, and the
    ranking it won (``considered`` is ``((tile, split, seconds), ...)`` in
    candidate order)."""

    kv_tile_blocks: int
    split_k: int
    predicted_s: float
    cost: LaunchCost
    considered: Tuple[Tuple[int, int, float], ...]


def default_candidates(kv_tile_blocks: int,
                       split_k: int) -> Tuple[Tuple[int, int], ...]:
    """The candidate grids implied by the engine's static knobs: every
    combination of {1, kv_tile_blocks} × {1, split_k}, deduped."""
    cands = {(1, 1), (kv_tile_blocks, 1), (1, split_k),
             (kv_tile_blocks, split_k)}
    return tuple(sorted(cands))


class GridPlanner:
    """Ranks decode grid candidates by modeled step latency. Costs depend
    on the lengths only through the per-row block counts
    (``ceil(len/BS)``), so decisions are memoized on ``(table_width,
    sorted block counts)``."""

    def __init__(self, candidates: Sequence[Tuple[int, int]], *,
                 n_q_heads: int, n_kv_heads: int, head_dim: int,
                 block_size: int, kv_dtype: str = "float32",
                 cost_params: Optional[CostParams] = None,
                 registry=None, max_decisions: int = 4096):
        cands = sorted({(int(t), int(s)) for t, s in candidates})
        if not cands or any(t < 1 or s < 1 for t, s in cands):
            raise ValueError(f"bad candidate grid set: {candidates!r}")
        self.candidates: Tuple[Tuple[int, int], ...] = tuple(cands)
        self.n_q_heads = n_q_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.block_size = block_size
        self.kv_dtype = kv_dtype
        self.cost_params = cost_params or DEFAULT_COST_PARAMS
        self.registry = registry
        self.decisions: List[Dict] = []      # bounded in-memory trail
        self.max_decisions = max_decisions
        self._cache: Dict[Tuple, GridDecision] = {}

    def rank(self, lengths: Sequence[int],
             table_width: int) -> GridDecision:
        """Model every candidate on this batch state; argmin latency.
        Ties break toward fewer grid steps, then candidate order."""
        scored = []
        for (t, s) in self.candidates:
            c = decode_launch_cost(
                lengths, table_width, n_q_heads=self.n_q_heads,
                n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                block_size=self.block_size, kv_tile_blocks=t, split_k=s,
                kv_dtype=self.kv_dtype)
            scored.append((estimate_seconds(c, self.cost_params), c, t, s))
        best_s, best_c, bt, bs = min(
            scored, key=lambda x: (x[0], x[1].grid_steps))
        return GridDecision(
            kv_tile_blocks=bt, split_k=bs, predicted_s=best_s, cost=best_c,
            considered=tuple((t, s, sec) for sec, _, t, s in scored))

    def plan_decode(self, lengths: Sequence[int],
                    table_width: int) -> GridDecision:
        """Memoized ``rank`` + telemetry recording — the engine's per-step
        entry point. ``lengths`` must be what the kernel will attend."""
        BS = self.block_size
        key = (table_width,
               tuple(sorted(-(-int(ln) // BS) for ln in lengths)))
        dec = self._cache.get(key)
        if dec is None:
            if len(self._cache) >= self.max_decisions:
                self._cache.clear()
            dec = self._cache[key] = self.rank(lengths, table_width)
        self._record(dec, table_width)
        return dec

    # -- observability ----------------------------------------------------

    def _record(self, dec: GridDecision, table_width: int) -> None:
        if len(self.decisions) < self.max_decisions:
            self.decisions.append({
                "table_width": table_width,
                "kv_tile_blocks": dec.kv_tile_blocks,
                "split_k": dec.split_k,
                "predicted_s": dec.predicted_s,
                "gather_bytes": dec.cost.gather_bytes,
                "waste_bytes": dec.cost.waste_bytes,
                "flops": dec.cost.flops})
        reg = self.registry
        if reg is None:
            return
        reg.counter("autotune_decisions_total",
                    "grid planning decisions made").inc()
        reg.counter(
            f"autotune_choice_t{dec.kv_tile_blocks}_s{dec.split_k}_total",
            "decisions that picked this (kv_tile_blocks, split_k)").inc()
        reg.gauge("autotune_kv_tile_blocks",
                  "kv_tile_blocks of the latest decision"
                  ).set(dec.kv_tile_blocks)
        reg.gauge("autotune_split_k",
                  "split_k of the latest decision").set(dec.split_k)
        reg.histogram("autotune_predicted_step_seconds",
                      "modeled decode step latency of the chosen grid"
                      ).observe(dec.predicted_s)

    def observe_measured(self, dec: GridDecision, measured_s: float) -> None:
        """Close the predicted-vs-measured loop for one planned step."""
        reg = self.registry
        if reg is None or measured_s <= 0:
            return
        reg.histogram("autotune_measured_step_seconds",
                      "measured decode step latency under planned grids"
                      ).observe(measured_s)
        reg.gauge("autotune_pred_over_measured",
                  "latest predicted/measured step-latency ratio (a "
                  "calibration signal, not a correctness one: the argmin "
                  "is scale-free)").set(dec.predicted_s / measured_s)

    def summary(self) -> Dict[str, int]:
        """Decision counts per chosen grid, e.g. ``{"t4_s2": 37, ...}``."""
        out: Dict[str, int] = {}
        for d in self.decisions:
            k = f"t{d['kv_tile_blocks']}_s{d['split_k']}"
            out[k] = out.get(k, 0) + 1
        return out
