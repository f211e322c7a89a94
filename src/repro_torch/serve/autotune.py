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
The reference's metric-registry hooks (decision counters, predicted and
measured step-time histograms) are not ported yet: ``registry`` must be
None.
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
        if registry is not None:
            raise NotImplementedError(
                "GridPlanner: the metric registry (serving telemetry) is "
                "not ported yet; pass registry=None")
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
        """Memoized ``rank``, recorded in ``decisions`` — the engine's
        per-step entry point. ``lengths`` must be what the kernel will
        attend."""
        BS = self.block_size
        key = (table_width,
               tuple(sorted(-(-int(ln) // BS) for ln in lengths)))
        dec = self._cache.get(key)
        if dec is None:
            if len(self._cache) >= self.max_decisions:
                self._cache.clear()
            dec = self._cache[key] = self.rank(lengths, table_width)
        if len(self.decisions) < self.max_decisions:
            self.decisions.append({
                "table_width": table_width,
                "kv_tile_blocks": dec.kv_tile_blocks,
                "split_k": dec.split_k,
                "predicted_s": dec.predicted_s,
                "gather_bytes": dec.cost.gather_bytes,
                "waste_bytes": dec.cost.waste_bytes,
                "flops": dec.cost.flops})
        return dec

    def observe_measured(self, dec: GridDecision, measured_s: float) -> None:
        """Predicted-against-measured step latency goes to the metric
        registry, which is not ported: nothing to record without it."""

    def summary(self) -> Dict[str, int]:
        """Decision counts per chosen grid, e.g. ``{"t4_s2": 37, ...}``."""
        out: Dict[str, int] = {}
        for d in self.decisions:
            k = f"t{d['kv_tile_blocks']}_s{d['split_k']}"
            out[k] = out.get(k, 0) + 1
        return out
