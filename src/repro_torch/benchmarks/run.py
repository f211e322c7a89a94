"""Benchmark harness: one entry per paper table and figure, the serving
benches and the roofline report, in the JAX package's order
(``benchmarks/run.py``) on the port.

Prints ``name,...`` CSV lines. ``--fast`` runs each bench at its smoke
scale and skips the Table III finetuning proxy; ``--device`` (default the
CUDA card; ``cpu`` runs every kernel's plain version) goes to every bench
that runs a model. The roofline sections read the port's dry-run artifacts
(``artifacts/dryrun`` and, where present, ``artifacts/dryrun_opt``:
``python -m repro_torch.launch.dryrun --all [--optimized --out
artifacts/dryrun_opt]``) and print nothing without them.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --fast
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = ["--device", args.device]
    small = (lambda flag: [flag] if args.fast else [])

    from repro_torch.benchmarks import (fig1_breakdown, fig5_sweep,
                                        roofline_report,
                                        table1_bitwidth_ablation,
                                        table3_accuracy, table4_efficiency)
    from repro_torch.benchmarks.provenance import provenance

    print("# provenance:",
          json.dumps(provenance(mode="smoke" if args.fast else "measured"),
                     sort_keys=True))

    t0 = time.time()
    print("# Table IV — unit/PE area+energy (analytical 7nm model vs paper)")
    table4_efficiency.main()

    print("# Fig 5 — PE energy vs sequence length (model + measured)")
    fig5_sweep.main(dev)

    print("# Fig 1 — softmax runtime fraction vs sequence length (measured)")
    fig1_breakdown.main(dev)

    print("# Table I ablation — accuracy vs bitwidths (beyond-paper)")
    table1_bitwidth_ablation.main(dev)

    print("# Table III — softermax-aware finetuning accuracy proxy")
    if args.fast:
        print("table3,skipped(fast)")
    else:
        table3_accuracy.main(dev)

    print("# Serving throughput — continuous batching (paged KV) vs static")
    from repro_torch.benchmarks import serve_throughput
    serve_throughput.main(small("--fast") + dev)

    print("# Prefix cache — radix-tree prompt reuse on the paged pool")
    from repro_torch.benchmarks import prefix_cache_bench
    prefix_cache_bench.main(small("--smoke") + dev)

    print("# Chunked prefill — flash-prefill kernel vs dense one-shot")
    from repro_torch.benchmarks import prefill_paged_bench
    prefill_paged_bench.main(small("--smoke") + dev)

    print("# Int8 KV pool — equal-HBM capacity + throughput vs bf16")
    from repro_torch.benchmarks import kv_int8_bench
    kv_int8_bench.main(small("--smoke") + dev)

    print("# Paged decode — grouped/tiled/split kernel vs per-head walk")
    from repro_torch.benchmarks import decode_paged_bench
    decode_paged_bench.main(small("--smoke") + dev)

    print("# Autotune — per-step grid planning vs best static schedule")
    from repro_torch.benchmarks import autotune_bench
    autotune_bench.main(small("--smoke") + dev)

    print("# Resilience — guarded engine under the canned fault plan")
    from repro_torch.benchmarks import resilience_bench
    resilience_bench.main(small("--smoke") + dev)

    print("# Fleet — multi-replica scaling, affinity routing, failover")
    from repro_torch.benchmarks import fleet_bench
    fleet_bench.main(small("--smoke") + dev)

    print("# Restore — SIGKILL mid-workload, snapshot warm restart")
    from repro_torch.benchmarks import restore_bench
    restore_bench.main(small("--smoke") + dev)

    print("# Roofline (baseline sharding) — from dry-run artifacts")
    roofline_report.main()

    if os.path.isdir("artifacts/dryrun_opt"):
        print("# Roofline (optimized: --optimized sweep, §Perf)")
        os.environ["DRYRUN_ART"] = "artifacts/dryrun_opt"
        importlib.reload(roofline_report)
        roofline_report.main()
        os.environ.pop("DRYRUN_ART")
        importlib.reload(roofline_report)

        print("# Perf comparison (baseline vs optimized, §Perf)")
        from repro_torch.benchmarks import perf_compare
        for mesh in ("16x16", "2x16x16"):
            if os.path.isdir(os.path.join("artifacts/dryrun", mesh)):
                perf_compare.main(mesh)

    print(f"# total_bench_s,{time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
