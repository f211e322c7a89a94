"""Provenance-aware bench regression gate over the port's benches: fresh
smoke runs against committed baselines, same measurement mode only.

The counterpart of the JAX package's ``benchmarks/bench_trajectory.py``,
with the same record and check semantics. Its baselines are the port's
own, ``BENCH_torch_trajectory.json`` (repo root): one entry per bench,
recorded at SMOKE scale with an explicit ``(measurement_mode, scale)``
stamp by ``--record``. ``--check`` reruns every bench at the recorded
scale and fails on a >10% regression (``--threshold``) **only when the
fresh run's mode and scale match the baseline's**; a mismatch is reported,
not gated. Timing entries get up to ``--retries`` reruns before a
regression verdict sticks; deterministic entries (modeled ratios, tick and
token counts) get none. The port's committed full ``BENCH_torch_*.json``
headlines are cross-referenced into the report, never gated.

The port's modes: ``cuda`` (the compiled kernels on the card, the
default) or ``cpu-plain`` (``--device cpu``: every kernel wrapper takes its
plain version); the analytic, tick and token-count entries keep the
reference's mode names.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_trajectory --record
    PYTHONPATH=src python -m repro_torch.benchmarks.bench_trajectory --check \\
        --report trajectory_report.json
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BASELINE = "BENCH_torch_trajectory.json"


def _entries(device: str):
    """Each bench at smoke scale on ``device`` (returns its headline
    float), the measurement mode of that number, whether it is wall clock
    ("timing") or derived from counts and models ("deterministic"), and
    the committed full record to cross-reference, (file, key), if any."""
    from repro_torch.benchmarks import (autotune_bench, decode_paged_bench,
                                        fleet_bench, kv_int8_bench,
                                        prefill_paged_bench,
                                        prefix_cache_bench, resilience_bench,
                                        restore_bench, serve_throughput)
    dev = ["--device", device]
    measured = "cuda" if device.startswith("cuda") else "cpu-plain"
    return {
        "decode_paged": {
            "run": lambda: decode_paged_bench.main(["--smoke"] + dev),
            "metric": "ratio_per_head_over_grouped",
            "mode": measured, "kind": "timing",
            "full": ("BENCH_torch_decode.json",
                     "ratio_per_head_over_grouped")},
        "prefill_paged": {
            "run": lambda: prefill_paged_bench.main(["--smoke"] + dev),
            "metric": "ratio_dense_over_chunked",
            "mode": measured, "kind": "timing",
            "full": ("BENCH_torch_prefill.json",
                     "ratio_dense_over_chunked")},
        "kv_int8": {
            "run": lambda: kv_int8_bench.main(["--smoke"] + dev),
            "metric": "tok_s_ratio_int8_over_bf16",
            "mode": measured, "kind": "timing",
            "full": ("BENCH_torch_kv_int8.json",
                     "tok_s_ratio_int8_over_bf16")},
        "prefix_cache": {
            "run": lambda: prefix_cache_bench.main(["--smoke"] + dev),
            "metric": "ratio_cached_over_cold",
            "mode": measured, "kind": "timing", "full": None},
        "serve_throughput": {
            # the ratio alone: its telemetry overhead gate is a bench of
            # its own (serve_throughput without --no-overhead-check)
            "run": lambda: serve_throughput.main(
                ["--fast", "--no-overhead-check"] + dev),
            "metric": "tok_s_ratio_paged_over_static",
            "mode": measured, "kind": "timing", "full": None},
        "autotune": {
            "run": lambda: autotune_bench.main(["--smoke"] + dev),
            "metric": "ratio_best_static_over_per_step",
            "mode": "analytic-cost-model", "kind": "deterministic",
            "full": ("BENCH_torch_autotune.json",
                     "ratio_best_static_over_per_step")},
        "resilience": {
            "run": lambda: resilience_bench.main(["--smoke"] + dev),
            "metric": "tok_s_ratio_guarded_over_fault_free",
            "mode": measured, "kind": "timing",
            "full": ("BENCH_torch_resilience.json",
                     "tok_s_ratio_guarded_over_fault_free")},
        "fleet": {
            # tokens per supervision tick: deterministic tick counts
            "run": lambda: fleet_bench.main(["--smoke"] + dev),
            "metric": "scaling_ratio_fleet_over_single",
            "mode": "tick-model", "kind": "deterministic",
            "full": ("BENCH_torch_fleet.json",
                     "scaling_ratio_fleet_over_single")},
        "restore": {
            # prefill tokens a cold restart recomputes per token of the
            # warm restart: deterministic token counts
            "run": lambda: restore_bench.main(["--smoke"] + dev),
            "metric": "cold_over_warm_prefill_tokens",
            "mode": "token-count", "kind": "deterministic",
            "full": ("BENCH_torch_restore.json",
                     "cold_over_warm_prefill_tokens")},
    }


def _run_entry(name, ent):
    print(f"# bench_trajectory: running {name} (smoke)")
    return float(ent["run"]())


def record(args) -> int:
    from repro_torch.benchmarks.provenance import provenance
    # --only re-records a subset in place: the other entries keep theirs
    entries = {}
    if args.only and os.path.exists(args.baseline):
        with open(args.baseline) as f:
            entries = json.load(f).get("entries", {})
    for name, ent in _entries(args.device).items():
        if args.only and name not in args.only:
            continue
        entries[name] = {
            "metric": ent["metric"], "value": round(_run_entry(name, ent), 4),
            "measurement_mode": ent["mode"], "scale": "smoke",
            "kind": ent["kind"], "direction": "higher"}
    rec = {"bench": "trajectory-baselines",
           "provenance": provenance(mode="smoke"), "entries": entries}
    with open(args.baseline, "w") as f:
        json.dump(rec, f, indent=2)
        f.write("\n")
    print(f"bench_trajectory,recorded,{len(entries)},{args.baseline}")
    return 0


def check(args) -> int:
    if not os.path.exists(args.baseline):
        print(f"bench_trajectory,error,no baseline {args.baseline} "
              f"(run --record and commit it)")
        return 2
    with open(args.baseline) as f:
        base = json.load(f)
    report = {"baseline": args.baseline,
              "baseline_provenance": base.get("provenance", {}),
              "threshold": args.threshold, "entries": {},
              "full_records": {}}
    failures = []
    entries = _entries(args.device)
    for name, ent in entries.items():
        if args.only and name not in args.only:
            continue
        b = base.get("entries", {}).get(name)
        fresh_mode = ent["mode"]
        row = {"metric": ent["metric"], "kind": ent["kind"],
               "fresh_mode": fresh_mode, "scale": "smoke"}
        if b is None:
            # no recorded baseline: report-only until the next --record
            row.update(status="no-baseline",
                       fresh=round(_run_entry(name, ent), 4))
            report["entries"][name] = row
            continue
        row["baseline"] = b["value"]
        row["baseline_mode"] = b["measurement_mode"]
        if b["measurement_mode"] != fresh_mode or b.get("scale") != "smoke":
            # another instrument: surface, do not gate
            row.update(status="mode-mismatch-not-gated",
                       fresh=round(_run_entry(name, ent), 4))
            report["entries"][name] = row
            continue
        tries = 1 + (args.retries if ent["kind"] == "timing" else 0)
        best = -float("inf")
        for i in range(tries):
            best = max(best, _run_entry(name, ent))
            reg = (b["value"] - best) / b["value"] if b["value"] else 0.0
            if reg <= args.threshold:
                break
            if i + 1 < tries:
                print(f"# bench_trajectory: {name} regressed "
                      f"{reg * 100:.1f}% — retrying ({i + 1}/{tries - 1})")
        reg = (b["value"] - best) / b["value"] if b["value"] else 0.0
        row.update(fresh=round(best, 4), regression=round(reg, 4),
                   status="ok" if reg <= args.threshold else "REGRESSED")
        if reg > args.threshold:
            failures.append(
                f"{name}: {ent['metric']} {best:.4f} vs baseline "
                f"{b['value']:.4f} (-{reg * 100:.1f}%, mode {fresh_mode})")
        report["entries"][name] = row

    # the committed full-workload records: never gated (another scale)
    for name, ent in entries.items():
        if not ent["full"]:
            continue
        path, key = ent["full"]
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            report["full_records"][name] = {
                "file": path, "metric": key, "value": rec.get(key),
                "measurement_mode": rec.get("provenance", {}).get(
                    "measurement_mode"), "scale": "full", "gated": False}

    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"bench_trajectory,report,{args.report}")
    for name, row in report["entries"].items():
        print(f"bench_trajectory,{name},{row['metric']},"
              f"fresh,{row.get('fresh', 'n/a')},baseline,"
              f"{row.get('baseline', 'n/a')},status,{row['status']}")
    if failures:
        print("bench_trajectory,FAIL," + "; ".join(failures))
        return 1
    print("bench_trajectory,ok,no same-mode regressions "
          f"> {args.threshold * 100:.0f}%")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--record", action="store_true",
                   help="run every bench at smoke scale and (re)write the "
                        "baseline store")
    g.add_argument("--check", action="store_true",
                   help="rerun at the recorded scale and fail on same-mode "
                        "regressions beyond --threshold")
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="--check: write the full comparison (with the "
                         "non-gated full-record cross-reference) as JSON")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="max tolerated same-mode fractional regression")
    ap.add_argument("--retries", type=int, default=2,
                    help="extra reruns granted to TIMING benches before a "
                         "regression verdict sticks (deterministic "
                         "benches get none)")
    ap.add_argument("--only", nargs="*", default=None,
                    help="restrict to these bench names")
    args = ap.parse_args(argv)
    return record(args) if args.record else check(args)


if __name__ == "__main__":
    sys.exit(main())
