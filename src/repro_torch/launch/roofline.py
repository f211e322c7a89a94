"""Roofline terms of a step, in seconds, against one chip's published rates.

    compute    = analytic FLOPs per chip / peak FLOP/s   (HLO FLOPs if none)
    memory     = bytes per chip / HBM bandwidth
    collective = collective bytes per chip / link bandwidth

The counterpart of the JAX package's ``launch/roofline.py``. Its TPU rates
stay here under their names (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``) as
the ``TPU_V5E`` entry, the default of ``Roofline``, so a ``Roofline`` built
from a reference dry-run artifact gives the reference's terms. ``H100_SXM``
is the port's card, from NVIDIA's data sheet; build a ``Roofline`` with
``chip=H100_SXM`` to read a step against it.

MODEL_FLOPS uses 6·N·D (train) or 2·N·D (inference), with N = *active*
params for MoE; MODEL_FLOPS over the analytic FLOPs shows how much of the
work is attention or recurrence beyond the parameter matmuls.

The bytes and collective terms come from a step's per-chip program: the
reference reads XLA's optimized HLO (``collective_bytes``, kept here as it
is so the port reads the same text the same way) and its cost analysis;
the port's dry run records its own step (``from_record``). Both turn a
collective into wire bytes by one ring model, ``_wire_bytes``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

PEAK_FLOPS = 197e12        # bf16 per chip (TPU v5e-class)
HBM_BW = 819e9             # bytes/s per chip
LINK_BW = 50e9             # bytes/s per ICI link


@dataclasses.dataclass(frozen=True)
class Chip:
    """One accelerator's published rates."""
    name: str
    peak_flops: float                      # bf16 dense FLOP/s
    hbm_bw: float                          # device memory, bytes/s
    link_bw: float                         # one link, bytes/s each way
    peak_flops_f32: Optional[float] = None  # fp32 dense FLOP/s

    def peak(self, dtype: str = "bfloat16") -> float:
        """The dense peak of ``dtype`` ("bfloat16" or "float32")."""
        rate = {"bfloat16": self.peak_flops,
                "float32": self.peak_flops_f32}[dtype]
        if rate is None:
            raise ValueError(f"{self.name}: no {dtype} peak")
        return rate


TPU_V5E = Chip("TPU v5e", PEAK_FLOPS, HBM_BW, LINK_BW)
# NVIDIA H100 SXM5 data sheet: dense tensor-core bf16 (no sparsity), fp32
# on the CUDA cores, HBM3, one NVLink 4 direction of 900 GB/s in all
H100_SXM = Chip("H100 SXM", 989e12, 3.35e12, 450e9, peak_flops_f32=67e12)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
# "%name = <output types> <kind>(" — operands are %refs in optimized HLO, so
# sizes come from the OUTPUT shape(s) + the replica group size.
_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\]\S*)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")
_GROUP_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*(?:\(.*)?\{\s*$")
_WHILE_RE = re.compile(r"\bwhile\(")
_BODY_REF_RE = re.compile(r"body=%?([\w\.\-]+)")
_BRANCH_REF_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_CALLS_REF_RE = re.compile(r"\bcalls=%?([\w\.\-]+)")
_TRIP_RE = re.compile(r'known_trip_count[^0-9]*(\d+)')



def shape_bytes(dtype: str, dims: str) -> int:
    """Bytes of an array of HLO type ``dtype`` and comma-separated
    ``dims`` (unknown types count 4 bytes an element)."""
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _out_bytes(shape_str: str) -> int:
    return sum(shape_bytes(m.group(1), m.group(2))
               for m in _SHAPE_RE.finditer(shape_str))


def _wire_bytes(kind: str, out_b: int, group: int) -> float:
    """Ring-model bytes on the wire per chip for one execution."""
    n = max(group, 2)
    if kind == "all-gather":
        return out_b * (n - 1) / n
    if kind == "all-reduce":
        return out_b * 2 * (n - 1) / n
    if kind == "reduce-scatter":
        return out_b * (n - 1)          # out is the scattered shard
    if kind == "all-to-all":
        return out_b * (n - 1) / n
    return float(out_b)                  # collective-permute


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-chip collective wire bytes by kind, from optimized HLO text.

    Computation-graph aware: collectives inside ``while`` bodies (lax.scan
    over layers / KV chunks) are multiplied by the loop's known_trip_count;
    conditional branches and async wrapper computations count once.
    """
    # 1. split into computations
    comps: Dict[str, list] = {}
    cur = None
    for line in hlo_text.splitlines():
        h = _HEADER_RE.match(line.strip()) if line and not line.startswith(" ") else None
        if h and line.rstrip().endswith("{"):
            cur = h.group(1)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)

    own: Dict[str, Dict[str, float]] = {}
    children: Dict[str, list] = {}
    for name, lines in comps.items():
        acc = {k: 0.0 for k in _COLLECTIVES}
        kids = []
        for line in lines:
            m = _COLL_RE.search(line)
            if m and m.group(3) != "-done":   # count start, skip done
                out_b = _out_bytes(m.group(1))
                g = _GROUP_RE.search(line)
                group = int(g.group(2)) if g else 2
                acc[m.group(2)] += _wire_bytes(m.group(2), out_b, group)
            if _WHILE_RE.search(line):
                b = _BODY_REF_RE.search(line)
                t = _TRIP_RE.search(line)
                trip = int(t.group(1)) if t else 1
                if b:
                    kids.append((b.group(1), trip))
            for br in _BRANCH_REF_RE.finditer(line):
                for ref in br.group(1).split(","):
                    kids.append((ref.strip().lstrip("%"), 1))
            c = _CALLS_REF_RE.search(line)
            if c:
                kids.append((c.group(1), 1))
        own[name] = acc
        children[name] = kids

    memo: Dict[str, Dict[str, float]] = {}

    def total(name: str, stack=()) -> Dict[str, float]:
        if name in memo:
            return memo[name]
        if name not in own or name in stack:
            return {k: 0.0 for k in _COLLECTIVES}
        acc = dict(own[name])
        for kid, mult in children[name]:
            sub = total(kid, stack + (name,))
            for k in _COLLECTIVES:
                acc[k] += sub[k] * mult
        memo[name] = acc
        return acc

    entry = None
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            h = _HEADER_RE.match(line.strip())
            if h:
                entry = h.group(1)
            break
    if entry is None or entry not in own:
        # fall back: sum everything once
        out = {k: 0.0 for k in _COLLECTIVES}
        for acc in own.values():
            for k in _COLLECTIVES:
                out[k] += acc[k]
        return out
    return total(entry)


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float         # HLO cost_analysis (cross-check only)
    bytes_per_chip: float
    collective_per_chip: float
    chips: int
    model_flops: float            # global useful FLOPs (6ND / 2ND)
    collective_breakdown: Dict[str, float]
    analytic_flops: float = 0.0   # launch/analytic.py first-principles count
    chip: Chip = TPU_V5E          # the rates the terms divide by

    @property
    def compute_s(self) -> float:
        """Analytic FLOPs are primary (see launch/analytic.py);
        HLO flops retained as a cross-check."""
        if self.analytic_flops > 0:
            return self.analytic_flops / self.chips / self.chip.peak_flops
        return self.flops_per_chip / self.chip.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_per_chip / self.chip.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """6ND-useful over total structural FLOPs — exposes how much compute
        is attention/recurrence beyond the parameter matmuls."""
        total = (self.analytic_flops if self.analytic_flops > 0
                 else self.flops_per_chip * self.chips)
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at the
        dominant-term bound: (useful compute time) / (bound time)."""
        useful_s = self.model_flops / (self.chips * self.chip.peak_flops)
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> Dict:
        """The reference's keys; the chip is the caller's to record."""
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_per_chip": self.collective_per_chip,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "analytic_flops": self.analytic_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_breakdown": self.collective_breakdown,
        }


def from_record(record, chips: int, model_flops: float,
                analytic_flops: float = 0.0, chip: Chip = H100_SXM
                ) -> Roofline:
    """The ``Roofline`` of a dry-run step record (``launch/dryrun.py``'s
    ``StepRecord``: per-rank ``flops``, ``bytes_accessed`` and the wire
    bytes of each collective kind), at ``chip``'s rates; the counterpart
    of the reference's ``from_compiled``."""
    coll = {k: float(record.collective_bytes.get(k, 0.0))
            for k in _COLLECTIVES}
    return Roofline(
        flops_per_chip=float(record.flops),
        bytes_per_chip=float(record.bytes_accessed),
        collective_per_chip=float(sum(coll.values())),
        chips=chips,
        model_flops=model_flops,
        collective_breakdown=coll,
        analytic_flops=analytic_flops,
        chip=chip,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS helpers
# ---------------------------------------------------------------------------


def active_params(cfg) -> int:
    """Active parameter count (MoE: top_k of n_experts + shared)."""
    from repro_torch.models.registry import model_fns
    from repro_torch.models.schema import num_params
    total = num_params(model_fns(cfg).schema)
    if cfg.moe.n_experts:
        m = cfg.moe
        L = cfg.n_layers - m.first_dense
        per_expert = 3 * cfg.d_model * m.d_expert
        expert_total = L * m.n_experts * per_expert
        expert_active = L * m.top_k * per_expert
        total = total - expert_total + expert_active
    return int(total)


def model_flops(cfg, shape, n_params: Optional[int] = None) -> float:
    """6·N·D train; 2·N·D inference (D = tokens processed per step)."""
    n = n_params if n_params is not None else active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
