"""Per-step grid planning against the best static grid on a mixed
short/long-context decode trajectory — the JAX package's
``benchmarks/autotune_bench.py`` on the port.

A fused decode batch where ONE long-context request stretches the shared
table width while short requests come and go. While the long request is
live, wide-table steps favor big kv tiles and split-K; once it finishes
the width bucket collapses and the same grid is padding for the short
rows, so the step-optimal grid changes mid-trajectory.

Both sides are scored with the analytic cost model
(``serve/kernel_costs.py``, the model the engine's planner uses):

* **static**   — every candidate grid held for the whole trajectory; the
  best one (least total modeled step latency) is the baseline;
* **per-step** — ``GridPlanner`` re-ranks the candidates each step.

Per-step <= best static holds by construction (the ``>= 1.0`` gate checks
the machinery; both totals are correctly rounded sums, so the gate holds
in floating point too); full mode gates a strict win on the mixed
workload. The numbers are modeled seconds under the reference's machine
model (``measurement_mode: analytic-cost-model``), not card times. The
engine check gates what must hold everywhere: greedy streams identical at
every autotune mode, bf16 and int8 pools.

Full mode writes ``BENCH_torch_autotune.json``. Prints
``autotune_bench,...`` CSV lines, the last one the static/per-step
modeled ratio.

    PYTHONPATH=src python -m repro_torch.benchmarks.autotune_bench
    PYTHONPATH=src python -m repro_torch.benchmarks.autotune_bench \\
        --device cpu --smoke
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def trajectory(args):
    """Engine-faithful batch states: per decode step, the lengths vector
    the kernel attends (zombie rows = 1) and the pow2-bucketed table width
    covering the live rows. One long request (finishes mid-run) and
    staggered short ones."""
    from repro_torch.serve.paged_step import table_width_bucket

    BS = args.block_size
    rng = np.random.default_rng(args.seed)
    reqs = [(args.long_blocks * BS, args.long_steps)]   # (start_len, n_new)
    for _ in range(args.requests - 1):
        reqs.append((int(rng.integers(BS, args.short_blocks_max * BS + 1)),
                     int(rng.integers(args.short_steps_min,
                                      args.short_steps_max + 1))))
    steps = []
    for t in range(max(n for _, n in reqs)):
        live = [(s + t) for s, n in reqs if t < n]
        if not live:
            break
        lens = np.ones((args.requests,), np.int64)      # zombies attend 1
        i = 0
        for s, n in reqs:
            if t < n:
                lens[i] = s + t + 1                     # kernel's new_len
            i += 1
        need = max(-(-ln // BS) for ln in live) + 1     # next-token block
        steps.append((lens, table_width_bucket(need)))
    return steps


def candidates(args):
    return [tuple(map(int, c.split("x"))) for c in args.candidates.split(",")]


def cost_params(args):
    """The machine model, pinned at the reference's balanced operating
    point: ``cores`` exposes split-K parallelism against tile padding, and
    ``flops_per_s`` sits where tile-rounding compute is comparable to
    per-step overhead, so planning has a decision to make."""
    from repro_torch.serve.kernel_costs import CostParams
    return CostParams(cores=args.cores, flops_per_s=args.flops_per_s)


def model_costs(args, steps):
    from repro_torch.serve.autotune import GridPlanner
    from repro_torch.serve.kernel_costs import (decode_launch_cost,
                                                estimate_seconds)

    params = cost_params(args)
    cands = candidates(args)
    shape = dict(n_q_heads=args.hq, n_kv_heads=args.hkv,
                 head_dim=args.head_dim, block_size=args.block_size,
                 kv_dtype=args.kv_dtype)

    # every total is a correctly rounded sum (math.fsum), so a per-step
    # argmin that never loses at a step never loses in total either: two
    # different float summations (a running += against Python's
    # compensated sum()) can differ by an ulp the wrong way
    static_s = {c: [] for c in cands}
    for lens, w in steps:
        for (ti, sp) in cands:
            c = decode_launch_cost(lens, w, kv_tile_blocks=ti, split_k=sp,
                                   **shape)
            static_s[(ti, sp)].append(estimate_seconds(c, params))
    static_tot = {c: math.fsum(v) for c, v in static_s.items()}
    best_static, best_tot = min(static_tot.items(), key=lambda kv: kv[1])

    planner = GridPlanner(cands, cost_params=params, **shape)
    t0 = time.perf_counter()
    per_step = [planner.plan_decode(lens, w) for lens, w in steps]
    plan_us = (time.perf_counter() - t0) / len(steps) * 1e6
    per_tot = math.fsum(d.predicted_s for d in per_step)
    return (best_static, best_tot, per_tot, static_tot, planner.summary(),
            plan_us)


def engine_equality(args, rng, device):
    """Greedy streams identical at every autotune mode (off / static /
    per-step), bf16 and int8 pools."""
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine

    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (13, 41, 7)]

    def serve(**kw):
        eng = ContinuousEngine(cfg, params, block_size=8, num_blocks=64,
                               max_batch=4, max_len=96, kv_tile_blocks=2,
                               decode_split_k=2, device=device, **kw)
        hs = [eng.submit(p, 6) for p in prompts]
        res = eng.run()
        return [res[h.req_id].tokens for h in hs], eng

    decided = 0
    for kd in ({}, {"kv_dtype": "int8"}):
        off, _ = serve(**kd)
        stat, _ = serve(autotune="static", **kd)
        step, es = serve(autotune="per-step", **kd)
        assert off == stat == step, \
            f"{kd or 'bf16'}: greedy streams diverged across autotune modes"
        decided += sum(es.planner.summary().values())
    assert decided > 0, "per-step planner made no decisions"
    return True


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device of the engine check (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--hq", type=int, default=8)
    ap.add_argument("--hkv", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--long-blocks", type=int, default=44,
                    help="resident blocks of the long request at step 0")
    ap.add_argument("--long-steps", type=int, default=48,
                    help="decode steps the long request stays live; after "
                         "it finishes the width bucket collapses — the "
                         "regime shift per-step planning exploits")
    ap.add_argument("--short-blocks-max", type=int, default=6)
    ap.add_argument("--short-steps-min", type=int, default=24)
    ap.add_argument("--short-steps-max", type=int, default=96)
    ap.add_argument("--candidates", default="1x1,4x1,8x1,1x4,4x2,4x4",
                    help="comma-separated TILExSPLIT grid candidates")
    ap.add_argument("--cores", type=int, default=8,
                    help="CostParams.cores for the machine model")
    ap.add_argument("--flops-per-s", type=float, default=5e10,
                    help="CostParams.flops_per_s — see cost_params for "
                         "why the default sits at the balanced "
                         "overhead-vs-compute operating point")
    ap.add_argument("--kv-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_torch_autotune.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast mode (gates per-step >= static and "
                         "engine greedy equality)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = 4
        args.long_blocks, args.long_steps = 12, 10
        args.short_steps_min, args.short_steps_max = 6, 20
        args.candidates = "1x1,2x1,2x2"
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    steps = trajectory(args)
    print(f"autotune_bench,workload,requests,{args.requests},steps,"
          f"{len(steps)},long_blocks,{args.long_blocks},candidates,"
          f"{args.candidates.replace(',', '+')}")

    (best_static, best_tot, per_tot, static_tot, decisions,
     plan_us) = model_costs(args, steps)
    ratio = best_tot / per_tot
    for (ti, sp), tot in sorted(static_tot.items()):
        print(f"autotune_bench,static,t{ti}_s{sp},modeled_s,{tot:.6f}")
    print(f"autotune_bench,per_step,modeled_s,{per_tot:.6f},"
          f"plan_us_per_step,{plan_us:.1f}")
    print(f"autotune_bench,decisions,{json.dumps(decisions)}")

    assert ratio >= 1.0, (
        f"per-step planning lost to a fixed grid under its own model "
        f"({ratio:.4f}x) — the argmin is broken")

    engine_equality(args, rng, device)
    print("autotune_bench,engine,greedy_equal,1")
    print(f"autotune_bench,ratio_best_static_over_per_step,{ratio:.4f}")

    if not args.smoke:
        assert ratio > 1.0, (
            "per-step planning only TIED the best static grid on the "
            "mixed-length workload — the regime shift should force "
            "different step-optimal grids")
        assert len(decisions) > 1, (
            f"planner picked one grid for the whole mixed trajectory "
            f"({decisions}) — no per-step signal")
        from repro_torch.benchmarks.provenance import provenance
        record = {
            "bench": "autotune",
            "provenance": provenance(mode="analytic-cost-model"),
            "workload": {
                "requests": args.requests, "hq": args.hq, "hkv": args.hkv,
                "head_dim": args.head_dim, "block_size": args.block_size,
                "long_blocks": args.long_blocks,
                "long_steps": args.long_steps,
                "short_blocks_max": args.short_blocks_max,
                "decode_steps": len(steps), "arch": args.arch,
                "reduced": True},
            "machine_model": {"cores": args.cores,
                              "flops_per_s": args.flops_per_s,
                              "kv_dtype": args.kv_dtype},
            "candidates": sorted(f"t{t}_s{s}" for t, s in static_tot),
            "static_modeled_s": {f"t{t}_s{s}": v
                                 for (t, s), v in sorted(static_tot.items())},
            "best_static": f"t{best_static[0]}_s{best_static[1]}",
            "per_step_modeled_s": per_tot,
            "planning_us_per_step": plan_us,
            "decisions": decisions,
            "ratio_best_static_over_per_step": ratio,
            "greedy_equal": True,
            "engine_device": device.type,
        }
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        print(f"autotune_bench,wrote,{args.out}")
    return ratio


if __name__ == "__main__":
    main()
