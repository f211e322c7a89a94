"""Multi-pod dry run of the port: is the distribution config coherent, and
what does one step cost each rank?

The counterpart of the JAX package's ``repro.launch.dryrun``. For every
(architecture x input shape x mesh) cell:

  1. stand this process in for the 256 (16x16) or 512 (2x16x16) ranks of
     the production mesh (``launch.mesh.fake_process_group``: a ``fake``
     process group, rank 0, on the ``cpu`` mesh device);
  2. pick the rule table as the reference does and place parameters,
     optimizer state, batch and cache on DTensors by the logical-axis
     rules (``parallel/sharding.py``), every tensor a ``FakeTensor``:
     shapes and dtypes, no memory, no arithmetic;
  3. run one step (``make_train_step`` with AdamW, ``prefill`` or
     ``decode_step``) through the same code the card runs, under
     ``Recorder``, which sees each rank-local operation;
  4. write the step record and its roofline into
     ``artifacts/dryrun/<mesh>/<arch>__<shape>.json``.

The port has no compiler and no HLO, so its record stands in for XLA's
``memory_analysis`` and ``cost_analysis`` (per rank, rank 0's shards):

* ``argument_size_in_bytes`` / ``output_size_in_bytes``: the local shards
  of what the step takes (parameters, AdamW state, batch, cache) and of
  what it returns;
* ``peak_live_bytes``: the highest sum of live storage over the step,
  arguments included (not XLA's ``temp_size_in_bytes``);
* ``bytes accessed``: each operation's operands plus outputs, unfused (as
  eager runs); a view moves nothing. A kernel wrapper counts once, as its
  operands plus outputs (``kernels/observe.py``), as XLA counts a Pallas
  custom call; ``flops`` are the matrix products' (2·M·N·K), a
  cross-check, as the reference keeps HLO FLOPs;
* collectives by the reference's five kinds: DTensor's own, the explicit
  ``c10d`` ones (the vocab-parallel loss and embedding, the int8
  all-reduce, the expert-parallel all-to-all) and ring attention's p2p
  shifts (``collective-permute``), each turned into wire bytes by
  ``roofline._wire_bytes`` at its group's size.

The report keeps the reference's keys (``lower_s`` is the placement's
wall time, ``compile_s`` the recorded step's: nothing is compiled), names
its ``chip`` (``roofline`` is computed at ``H100_SXM``; ``--chip tpu_v5e``
gives the reference's rates) and adds ``rules``, ``collective_counts``,
``kernel_calls`` and ``custom_call_moves``: the per-rank bytes each of the
port's custom calls (``kernels/dtensor.py::run_local``) gathers where
GSPMD keeps the operand sharded.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--subprocess]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import Counter, defaultdict
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (ALL_SHAPES, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.kernels.observe import observing
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.models.registry import (GRID_ARCHS, cell_supported,
                                         get_config, input_specs, model_fns)
from repro_torch.models.schema import tree_map
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                           SEQ_PARALLEL_RULES, SERVE_RULES,
                                           placed_scope, placed_zeros,
                                           sharding_context)
from repro_torch.train.step import make_train_step
from repro_torch.utils.logging import get_logger

log = get_logger("dryrun")

SHAPES: Dict[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}
CHIPS = {"h100_sxm": rf.H100_SXM, "tpu_v5e": rf.TPU_V5E}

# the wire kind of each collective operation, by (namespace, name)
_KINDS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
}
# operations that move no bytes: allocations, aliases, metadata
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_unsafe_view", "lift_fresh",
             "lift_fresh_copy", "wait_tensor", "recv_", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "device"}
_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and dataclasses (the
    AdamW state)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _group_size(args) -> int:
    """The group size of a collective's arguments: a c10d op's
    ``ProcessGroup``, a functional collective's group name (it follows
    its reduce op), else its ``group_size``."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
    for a in reversed(args):
        if isinstance(a, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(a).size()
    for a in args:
        if isinstance(a, int) and not isinstance(a, bool):
            return a
    raise ValueError("a collective without a group")


@dataclasses.dataclass
class StepRecord:
    """One step's per-rank costs (rank 0's shards); see the module
    docstring."""
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_live_bytes: int = 0
    bytes_accessed: float = 0.0
    flops: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in rf._COLLECTIVES})
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=Counter)
    # (kind, output bytes, group size) of every collective, in order
    collectives: list = dataclasses.field(default_factory=list)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=Counter)
    custom_call_moves: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    unclassified: Dict[str, int] = dataclasses.field(default_factory=Counter)


class Recorder(FakeTensorMode):
    """A ``FakeTensorMode`` that writes what each rank-local operation
    costs into a ``StepRecord``.

    An operation is counted where this mode handles it at its outermost
    level (``_depth`` 1): DTensor runs its sharding propagation inside a
    nested entry of the same mode, and a decomposition re-enters it too;
    neither is the rank's work. An operation on DTensors is left to
    DTensor, whose local operations then come here. Kernel calls run
    paused and count once (``kernel_call``)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.rec = StepRecord()
        self._depth = 0
        self._paused = 0
        self._live: Dict[int, list] = {}
        self._live_bytes = 0
        self.recording = False

    def __enter__(self):
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        return super().__exit__(*exc)

    # -- live storage --------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live while any tensor seen on it is."""
        key = t.untyped_storage()._cdata
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self._live_bytes += ent[0]
            self.rec.peak_live_bytes = max(self.rec.peak_live_bytes,
                                           self._live_bytes)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self._live_bytes -= ent[0]
            del self._live[key]

    # -- operations ----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is not NotImplemented and self.recording
                and self._depth == 1 and not self._paused):
            self._note(func, args, kwargs or {}, out)
        return out

    def _note(self, func, args, kwargs, out) -> None:
        ns, name = func._schema.name.split("::")
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        kind = _KINDS.get(name) if ns in ("c10d", "_c10d_functional") \
            else None
        group = _group_size(list(args) + list(kwargs.values())) \
            if kind is not None else 0
        if group > 1:                  # a group of one rank moves nothing
            # the output: a functional collective returns it; a c10d one
            # takes it first (in place for all_reduce and send)
            moved = outs[:1] if ns == "_c10d_functional" else \
                _tensors(args[0])
            out_b = sum(_nbytes(t) for t in moved)
            self.rec.collective_bytes[kind] += rf._wire_bytes(kind, out_b,
                                                              group)
            self.rec.collective_counts[kind] += 1
            self.rec.collectives.append((kind, out_b, group))
        elif kind is None and ns in ("c10d", "_c10d_functional") \
                and name not in _NO_BYTES:
            self.rec.unclassified[name] += 1
        if name in _MATMULS:
            a, b = ins[-2], ins[-1]
            self.rec.flops += 2.0 * math.prod(a.shape) * b.shape[-1]
        if not (func.is_view or name in _NO_BYTES):
            self.rec.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self.track(t)

    def kernel_call(self, name, fn, args, like=None):
        """Kernel ``name``'s plain version as one call: its operands plus
        outputs, and its backward likewise where a gradient is wanted.
        With ``like`` only the outputs are made: what the kernel computes
        is not this record's business, and fake arithmetic costs host
        time."""
        ins = _tensors(args)
        if like is not None:
            fn = like
        if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
            return _Observed.apply(self, name, fn, like is not None, *args)
        with self.paused():
            out = fn(*args)
        self._note_call(name, ins, _tensors(out))
        return out

    def _note_call(self, name, ins, outs) -> None:
        if not self.recording:
            return
        self.rec.kernel_calls[name] += 1
        self.rec.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self.track(t)

    def redistribution(self, where, before, after) -> None:
        if self.recording and not self._paused:
            grew = _nbytes(_local(after)) - _nbytes(_local(before))
            if grew > 0:
                self.rec.custom_call_moves[where] += grew

    def record(self, fn, *args):
        """``fn(*args)`` recorded into a fresh ``StepRecord``, with
        kernel calls observed: (the record, the result). Enter the mode
        first, and make ``args`` under it."""
        self.rec, self.recording = StepRecord(), True
        self.rec.peak_live_bytes = self._live_bytes   # what is held already
        try:
            with observing(self):
                out = fn(*args)
        finally:
            self.recording = False
        return self.rec, out

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1


class _Observed(torch.autograd.Function):
    """A plain version run as one call whose backward is one call too."""

    @staticmethod
    def forward(ctx, rec, name, fn, shapes_only, *args):
        ins = [a.detach().requires_grad_(a.requires_grad)
               if isinstance(a, torch.Tensor) else a for a in args]
        with rec.paused(), torch.enable_grad():
            out = fn(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.rec, ctx.name, ctx.ins, ctx.outs = rec, name, ins, outs
        ctx.shapes_only = shapes_only
        rec._note_call(name, _tensors(ins), list(outs))
        res = tuple(o.detach() for o in outs)
        return res if isinstance(out, tuple) else res[0]

    @staticmethod
    def backward(ctx, *gs):
        wrt = [a for a in ctx.ins
               if isinstance(a, torch.Tensor) and a.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, gs)
                 if g is not None and o.requires_grad]
        with ctx.rec.paused():
            grads = iter(map(torch.empty_like, wrt) if ctx.shapes_only
                         else torch.autograd.grad(
                             [o for o, _ in pairs], wrt,
                             [g for _, g in pairs], allow_unused=True))
        out = [next(grads) if isinstance(a, torch.Tensor) and
               a.requires_grad else None for a in ctx.ins]
        ctx.rec._note_call(ctx.name + "_bwd",
                           _tensors(ctx.ins) + [g for _, g in pairs],
                           [t for t in out if t is not None])
        return (None, None, None, None, *out)


def select_rules(cfg: ModelConfig, shape: ShapeConfig, model: int):
    """The rule table of a cell, exactly as the reference's ``lower_cell``
    picks it (``model``: the mesh's model axis size). Returns (name,
    rules)."""
    if shape.global_batch < 8:
        return "LONG_CONTEXT_RULES", LONG_CONTEXT_RULES
    if (cfg.opt_seq_parallel and shape.kind in ("train", "prefill")
            and shape.seq_len % model == 0
            and cfg.family in ("dense", "moe")):
        return "SEQ_PARALLEL_RULES", SEQ_PARALLEL_RULES
    if cfg.opt_serve_resident and shape.kind == "decode":
        return "SERVE_RULES", SERVE_RULES
    return "DEFAULT_RULES", DEFAULT_RULES


def _placed(meta: torch.Tensor, logical):
    """A fake DTensor of ``meta``'s shape and dtype placed by its logical
    axes under the ambient mesh and rules."""
    return placed_zeros(meta.shape, meta.dtype, logical)


def _batch_logical(a):
    return ("batch", "seq", *(None,) * (a.dim() - 2))[:a.dim()]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor it holds), or ``t``."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _local_bytes(tree) -> int:
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def record_step(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                tc: Optional[TrainConfig] = None):
    """One step of ``cfg`` at ``shape`` on ``mesh`` under ``rules``, every
    leaf placed, under ``Recorder``. Returns (``StepRecord``, placement
    seconds, step seconds)."""
    # the card's route: kernel wrappers (K5) where a CUDA tensor takes them
    cfg = cfg.replace(interpret_kernels=True)
    fns = model_fns(cfg)
    mode = Recorder()
    with mode, sharding_context(mesh, rules):
        t0 = time.time()
        abstract = fns.abstract()
        if shape.kind == "decode" and cfg.opt_bf16_params:
            # serving holds the matrix params pre-cast (dryrun.py:156-164)
            abstract = tree_map(lambda a: torch.empty(
                a.shape, dtype=cfg.compute_dtype_ if a.dim() >= 2
                else a.dtype, device="meta"), abstract)
        params = tree_map(_placed, abstract, fns.specs)
        specs = input_specs(cfg, shape)
        if shape.kind == "train":
            opt = adamw.AdamWState(
                m=tree_map(torch.zeros_like, params),
                v=tree_map(torch.zeros_like, params),
                # a literal: its value is known to the host-side schedule
                step=torch.tensor(0, dtype=torch.int32))
            batch = {k: _placed(a, _batch_logical(a))
                     for k, a in specs.items()}
            args = (params, opt, batch)
            step = make_train_step(fns.loss, tc or TrainConfig(
                microbatches=1))
        elif shape.kind == "prefill":
            batch = {k: _placed(a, _batch_logical(a))
                     for k, a in specs.items()}
            args = (params, batch)
            step = torch.no_grad()(
                lambda p, b: fns.prefill(p, b, shape.seq_len))
        else:
            logical = fns.cache_logical()
            cache = {k: _placed(a, logical[k])
                     for k, a in specs["cache"].items()}
            tok = _placed(specs["tokens1"], ("batch",))
            args = (params, tok, cache)
            step = torch.no_grad()(fns.decode_step)
        t_lower = time.time() - t0
        for t in _tensors(args):
            mode.track(_local(t))
        t0 = time.time()
        with placed_scope():
            rec, out = mode.record(step, *args)
        t_step = time.time() - t0
        rec.argument_bytes = _local_bytes(args)
        rec.output_bytes = _local_bytes(out)
    return rec, t_lower, t_step


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               cfg_override=None, rules_override=None,
               chip: rf.Chip = rf.H100_SXM):
    """Place and record one cell. Returns (``StepRecord``, report dict in
    the reference's format). Runs on the initialized process group, else
    on a fake one of the mesh's size for the call."""
    cfg: ModelConfig = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    group = contextlib.nullcontext() if dist.is_initialized() else \
        fake_process_group(512 if multi_pod else 256)
    with group:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        chips = mesh.size()
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        if rules_override is not None:
            rules_name, rules = "override", rules_override
        else:
            rules_name, rules = select_rules(cfg, shape, sizes["model"])
        rec, t_lower, t_step = record_step(cfg, shape, mesh, rules)

    from repro_torch.launch.analytic import analytic_flops
    roof = rf.from_record(rec, chips, rf.model_flops(cfg, shape),
                          analytic_flops=analytic_flops(cfg, shape),
                          chip=chip)
    report = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "chip": chip.name,
        "rules": rules_name,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_step, 1),
        "memory_analysis": {
            "argument_size_in_bytes": float(rec.argument_bytes),
            "output_size_in_bytes": float(rec.output_bytes),
            "peak_live_bytes": float(rec.peak_live_bytes)},
        "cost_analysis": {"flops": rec.flops,
                          "bytes accessed": rec.bytes_accessed},
        "roofline": roof.to_dict(),
        "collective_counts": dict(rec.collective_counts),
        "kernel_calls": dict(rec.kernel_calls),
        "custom_call_moves": dict(rec.custom_call_moves),
    }
    if rec.unclassified:
        report["unclassified_collectives"] = dict(rec.unclassified)
    return rec, report


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             optimized: bool = False, chip: rf.Chip = rf.H100_SXM) -> Dict:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    skip = cell_supported(arch, SHAPES[shape_name])
    path = os.path.join(out_dir, mesh_tag)
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"{arch}__{shape_name}.json")
    if skip:
        report = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                  "skipped": skip}
        with open(fname, "w") as f:
            json.dump(report, f, indent=1)
        log.info("SKIP %s %s: %s", arch, shape_name, skip)
        return report
    log.info("recording %s × %s on %s%s ...", arch, shape_name, mesh_tag,
             " [optimized]" if optimized else "")
    cfg = get_config(arch).with_opts(True) if optimized else None
    _, report = lower_cell(arch, shape_name, multi_pod=multi_pod,
                           cfg_override=cfg, chip=chip)
    report["optimized"] = optimized
    print(f"--- {arch} × {shape_name} × {mesh_tag} ---")
    print("memory_analysis:", report["memory_analysis"])
    print("cost_analysis:", report["cost_analysis"])
    print("roofline:", {k: report["roofline"][k] for k in
                        ("compute_s", "memory_s", "collective_s",
                         "dominant", "roofline_fraction")})
    with open(fname, "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(GRID_ARCHS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell for the chosen mesh")
    ap.add_argument("--subprocess", action="store_true",
                    help="isolate each cell in a child process")
    ap.add_argument("--optimized", action="store_true",
                    help="enable the beyond-paper perf optimizations "
                         "(cfg.with_opts); default is the §Roofline baseline")
    ap.add_argument("--chip", choices=list(CHIPS), default="h100_sxm",
                    help="the rates of the report's roofline")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in GRID_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    t_all = time.time()
    for arch, shape in cells:
        if args.subprocess:
            import subprocess
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out,
                   "--chip", args.chip]
            if args.multi_pod:
                cmd.append("--multi-pod")
            if args.optimized:
                cmd.append("--optimized")
            if subprocess.run(cmd, env={**os.environ}).returncode != 0:
                failures.append((arch, shape))
            continue
        try:
            run_cell(arch, shape, args.multi_pod, args.out,
                     optimized=args.optimized, chip=CHIPS[args.chip])
        except Exception:
            traceback.print_exc()
            failures.append((arch, shape))
    log.info("%d cells in %.1f s", len(cells), time.time() - t_all)
    if failures:
        log.error("FAILED cells: %s", failures)
        return 1
    log.info("all %d cells OK", len(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
