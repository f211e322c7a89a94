"""Baseline against optimized roofline bounds over the grid of cells.

The counterpart of the reference's ``benchmarks/perf_compare.py``: reads
dry-run artifacts of the baseline placement (``artifacts/dryrun``) and of
``--optimized`` (``artifacts/dryrun_opt``), in the JAX package's format,
and prints each cell's bound time (its largest roofline term) and speedup.
Run ``python -m repro_torch.benchmarks.perf_compare [mesh]``.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np

from repro_torch.benchmarks.roofline_report import _upgrade

BASE = "artifacts/dryrun"
OPT = "artifacts/dryrun_opt"


def _load(root, mesh):
    out = {}
    for p in glob.glob(os.path.join(root, mesh, "*.json")):
        with open(p) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"])] = r
    return out


def _bound(r):
    # recomputed with analytic flops (the upgrade of roofline_report)
    rf = _upgrade(r)["roofline"]
    return max(rf["compute_s"], rf["memory_s"], rf["collective_s"]), rf


def main(mesh="16x16"):
    base = _load(BASE, mesh)
    opt = _load(OPT, mesh)
    print(f"# perf_compare mesh={mesh}: bound seconds (max roofline term), "
          "baseline vs optimized")
    rows = []
    for key in sorted(base):
        b, o = base[key], opt.get(key)
        if b.get("skipped") or o is None or o.get("skipped"):
            continue
        tb, rb = _bound(b)
        to, ro = _bound(o)
        rows.append((key, tb, to, tb / to if to else float("inf"),
                     rb["roofline_fraction"], ro["roofline_fraction"]))
    for (arch, shape), tb, to, sp, fb, fo in rows:
        print(f"perf,{mesh},{arch},{shape},bound={tb:.4g}->{to:.4g}s,"
              f"speedup={sp:.2f}x,frac={fb:.4f}->{fo:.4f}")
    sps = [r[3] for r in rows]
    print(f"# geomean speedup over {len(rows)} cells: "
          f"{float(np.exp(np.mean(np.log(sps)))):.2f}x")
    print("# note: long_500k 'regressions' are the CPU backend's bf16->f32 "
          "dot legalization re-converting weights per step (EXPERIMENTS.md "
          "§Roofline methodology); on TPU bf16 weight reads HALVE that term.")


if __name__ == "__main__":
    import sys
    main(sys.argv[1] if len(sys.argv) > 1 else "16x16")
