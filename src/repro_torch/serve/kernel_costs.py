"""Analytic per-launch cost model of the paged kernels (K1 decode, K2
prefill) — the grid planner's objective.

Closed-form accounting of what one ``flash_decode_paged`` /
``flash_prefill_paged`` launch moves and computes, as a pure function of
the launch geometry ``(lengths, table_width, heads, block_size,
kv_tile_blocks, split_k, kv_dtype)``. Nothing here touches a device. The
numbers derive from the same ``split_layout`` geometry as the kernel
wrappers and are pinned against the measuring oracles
(``flash_decode_paged.ref.decode_gather_oracle``,
``flash_prefill_paged.ref.prefill_gather_oracle``), which run the gathers
and count bytes.

The model describes the TPU kernels' dataflow, formula for formula, so
the planner makes the reference's decisions:

* **Gather bytes.** The TPU kernels' index maps DMA one pool block per
  (tile slot, grid step) unconditionally, over the table padded to
  ``Wp = S * spl * T`` blocks, so a decode launch moves ``B * Hkv * Wp``
  K-blocks and as many V-blocks (``BS * D * itemsize`` bytes each, plus
  ``BS * 4`` per block for an int8 pool's scales, K and V). Prefill
  re-streams the walk once per query tile. The CUDA port of K1 reads no
  row past a length, so on the card these bytes overstate what short rows
  cost; how far the model's ranking holds there is measured, not assumed.
* **Waste bytes.** Entries at or past a row's block cover
  ``ceil(len / BS)`` (pow2 bucketing, tile padding, dead tail blocks).
* **FLOPs.** Per computed kv tile (``k_start < len``) the QK and AV dots
  each run their full tile: ``2 * G * D * (T * BS)`` apiece per KV head.
* **Working set, grid steps, lanes**, for the latency proxy.

``estimate_seconds`` turns a ``LaunchCost`` into a scalar latency under a
``CostParams`` machine model; the planner consumes only its argmin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

from repro_torch.kernels.flash_decode_paged.ref import split_layout

# storage itemsizes by resolved pool dtype name
KV_ITEMSIZE: Dict[str, int] = {"float32": 4, "bfloat16": 2,
                               "float16": 2, "int8": 1}
SCALE_BYTES = 4          # f32 per-row scale siblings of an int8 pool
ACC_BYTES = 4            # kernels accumulate in f32


def _itemsize(kv_dtype: str) -> int:
    try:
        return KV_ITEMSIZE[kv_dtype]
    except KeyError:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                         f"expected one of {sorted(KV_ITEMSIZE)}")


@dataclasses.dataclass(frozen=True)
class LaunchCost:
    """Per-launch (= per-layer) cost of one paged kernel invocation.
    Extensive fields are for ONE launch; ``scaled(n_layers)`` accounts a
    whole model step."""

    kind: str                # "decode" | "prefill"
    grid_steps: int          # total grid iterations of the launch
    lanes: int               # parallel grid extent (B*Hkv*S / B*Hkv*nq)
    steps_per_lane: int      # sequential kv iterations per lane (spl / nk)
    gather_bytes: int        # KV (+scale) bytes the gather moves
    waste_bytes: int         # the part of gather_bytes that is masked junk
    io_bytes: int            # non-gather operand traffic (q in, out/partials)
    flops: int               # matmul FLOPs executed (QK + AV)
    merge_flops: int         # second-stage softermax_merge work (split-K)
    tile_bytes: int          # KV (+scale) bytes of ONE kv tile
    vmem_bytes: int          # per-step working set (tiles + scratch)

    @property
    def useful_bytes(self) -> int:
        return self.gather_bytes - self.waste_bytes

    def scaled(self, n: int) -> "LaunchCost":
        """The extensive fields times ``n``; per-step sizes unchanged."""
        return dataclasses.replace(
            self, grid_steps=self.grid_steps * n,
            gather_bytes=self.gather_bytes * n,
            waste_bytes=self.waste_bytes * n, io_bytes=self.io_bytes * n,
            flops=self.flops * n, merge_flops=self.merge_flops * n)

    def to_dict(self) -> Dict[str, int]:
        d = dataclasses.asdict(self)
        d["useful_bytes"] = self.useful_bytes
        return d


def _block_bytes(block_size: int, head_dim: int, kv_dtype: str) -> int:
    """Bytes one gathered pool block moves: K + V values, plus the f32
    scale rows of an int8 pool."""
    b = 2 * block_size * head_dim * _itemsize(kv_dtype)
    if kv_dtype == "int8":
        b += 2 * block_size * SCALE_BYTES
    return b


def decode_launch_cost(lengths: Sequence[int], table_width: int, *,
                       n_q_heads: int, n_kv_heads: int, head_dim: int,
                       block_size: int, kv_tile_blocks: int = 1,
                       split_k: int = 1,
                       kv_dtype: str = "float32") -> LaunchCost:
    """Cost of one ``flash_decode_paged`` launch (one layer); ``lengths``
    are what the kernel attends (``new_len``), ``table_width`` the width
    passed to it."""
    B = len(lengths)
    W, BS, D = table_width, block_size, head_dim
    Hq, Hkv = n_q_heads, n_kv_heads
    G = Hq // Hkv
    T, S, spl, Wp = split_layout(W, kv_tile_blocks, split_k)
    bb = _block_bytes(BS, D, kv_dtype)

    gather = B * Hkv * Wp * bb
    useful_blocks = sum(min(-(-int(ln) // BS), Wp) for ln in lengths)
    waste = (B * Wp - useful_blocks) * Hkv * bb

    # computed kv tiles per row: tile jj runs iff jj*T*BS < len
    tiles = sum(min(-(-int(ln) // (T * BS)), S * spl) for ln in lengths)
    flops = tiles * Hkv * 4 * G * D * T * BS          # QK + AV full tiles
    merge = B * Hq * D * 8 * S if S > 1 else 0        # split merge stage

    q_in = B * Hq * D * ACC_BYTES
    part_out = B * Hkv * S * (G * D + 2 * G) * ACC_BYTES
    vmem = (G * D * ACC_BYTES                         # q tile (f32)
            + T * bb                                  # K+V (+scale) tiles
            + (G * D + 2 * G) * ACC_BYTES             # acc/m/d scratch
            + (G * D + 2 * G) * ACC_BYTES)            # partial outputs
    return LaunchCost(kind="decode", grid_steps=B * Hkv * S * spl,
                      lanes=B * Hkv * S, steps_per_lane=spl,
                      gather_bytes=gather, waste_bytes=waste,
                      io_bytes=q_in + part_out, flops=flops,
                      merge_flops=merge, tile_bytes=T * bb,
                      vmem_bytes=vmem)


def prefill_launch_cost(q_len: int, q_pos0: Sequence[int],
                        cover_blocks: Sequence[int], table_width: int, *,
                        n_q_heads: int, n_kv_heads: int, head_dim: int,
                        block_size: int, kv_tile_blocks: int = 1,
                        block_q: int = 128,
                        kv_dtype: str = "float32") -> LaunchCost:
    """Cost of one ``flash_prefill_paged`` launch (one layer): ``q_len``
    the chunk length as passed (padding included), ``q_pos0`` (B,) each
    row's first position, ``cover_blocks`` (B,) each row's REAL table
    entries. The kv walk re-streams once per query tile; tiles wholly
    above the causal diagonal compute nothing."""
    B = len(q_pos0)
    if len(cover_blocks) != B:
        raise ValueError("q_pos0 and cover_blocks must align per row")
    W, BS, D = table_width, block_size, head_dim
    Hq, Hkv = n_q_heads, n_kv_heads
    G = Hq // Hkv
    T, _, nk, Wp = split_layout(W, kv_tile_blocks, 1)
    BQ = min(block_q, q_len)
    Sqp = -(-q_len // BQ) * BQ
    nq = Sqp // BQ
    bb = _block_bytes(BS, D, kv_dtype)

    gather = B * Hkv * nq * Wp * bb
    waste = sum(Hkv * nq * (Wp - min(int(c), Wp)) * bb
                for c in cover_blocks)

    flops = 0
    for p0 in q_pos0:
        for i in range(nq):
            q_end = int(p0) + i * BQ + BQ - 1
            ct = min(q_end // (T * BS) + 1, nk)        # diagonal check
            flops += ct * Hkv * 4 * G * BQ * D * T * BS
    q_in = B * Hq * Sqp * D * ACC_BYTES
    out = B * Hq * Sqp * D * ACC_BYTES
    vmem = (G * BQ * D * ACC_BYTES + T * bb
            + (G * BQ * D + 2 * G * BQ) * ACC_BYTES
            + G * BQ * D * ACC_BYTES)
    return LaunchCost(kind="prefill", grid_steps=B * Hkv * nq * nk,
                      lanes=B * Hkv * nq, steps_per_lane=nk,
                      gather_bytes=gather, waste_bytes=waste,
                      io_bytes=q_in + out, flops=flops, merge_flops=0,
                      tile_bytes=T * bb, vmem_bytes=vmem)


# ---------------------------------------------------------------------------
# Latency proxy (the planner's objective)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Machine model of ``estimate_seconds``. The defaults are the
    reference's TPU-shaped planning weights (memory ~0.8 TB/s, matmul
    ~20 f32 TFLOP/s, 2 parallel cores), not measurements of any device;
    H100 values are to be fitted from card measurements. ``cores`` is how
    many lanes run at once (what makes split-K pay for its padding)."""

    hbm_bytes_per_s: float = 8.0e11
    flops_per_s: float = 2.0e13
    grid_step_overhead_s: float = 2e-6   # per sequential grid iteration
    launch_overhead_s: float = 1e-5
    cores: int = 2                       # parallel lanes executed at once


DEFAULT_COST_PARAMS = CostParams()


def estimate_seconds(cost: LaunchCost,
                     params: CostParams = DEFAULT_COST_PARAMS) -> float:
    """Scalar latency proxy of one launch: launch overhead, the sequential
    grid-iteration wall (lanes spread over ``cores``, each walking its
    ``steps_per_lane`` kv steps), the larger of streaming and compute, and
    the split merge. Monotone in every extensive cost."""
    wall_steps = math.ceil(cost.lanes / params.cores) * cost.steps_per_lane
    t_overhead = (params.launch_overhead_s
                  + wall_steps * params.grid_step_overhead_s)
    t_stream = max((cost.gather_bytes + cost.io_bytes)
                   / params.hbm_bytes_per_s,
                   cost.flops / params.flops_per_s)
    t_merge = cost.merge_flops / params.flops_per_s
    return t_overhead + t_stream + t_merge
