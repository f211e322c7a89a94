"""Resilience under injected faults: guarded against unguarded against
fault-free — the JAX package's ``benchmarks/resilience_bench.py`` on the
port.

Three drives of the SAME two-wave shared-prefix workload through identical
``ContinuousEngine`` configurations:

* fault-free — no injector, no guard: the throughput and greedy-stream
  baseline;
* guarded    — the canned fault plan (``serve/faults.py``: KV corruption,
  admission stalls, pool pressure, transient step faults, stalls,
  preemption storms, numerics spikes) with the ``EngineGuard`` degradation
  ladder attached;
* unguarded  — the identical storm with no guard: shows WHY the guard
  exists (the corrupted-KV request's greedy stream silently diverges, and
  its poisoned prompt blocks stay published in the prefix cache).

Gates (the bench fails loudly on any):

* guarded tok/s >= ``--min-ratio`` (default 0.70) of fault-free tok/s
  (best-of ``--repeats`` paired rounds);
* ``check_invariants`` (pool/radix refcount contract) passes after EVERY
  step of both faulted drives, and ``leaked_blocks`` is 0 after each
  drive drains;
* every non-quarantined request of the guarded drive streams
  byte-identical greedy tokens to the fault-free drive;
* the unguarded drive diverges on at least one request (the corruption is
  real, and only the guard's scatter-readback audit catches it).

Every timed drive ends in a device synchronize before the clock is read.
The injected stalls sleep for real on the wall clock, as designed. With
``--out`` it writes the record (``BENCH_torch_resilience.json`` by
convention) where the reference writes its record, before the gates are
judged; ``--fault-log`` writes the guarded drive's fault-injection replay
artifact. The guard's thresholds are the reference's reduced-model
defaults (``GuardConfig``); a deployment at another width sets its own
(``build_engines(guard_config=...)``): ``audit_deltas`` reads the clean
readback deltas of a workload, ``guard_config_for`` scales the two
logit-error thresholds above them.

    PYTHONPATH=src python -m repro_torch.benchmarks.resilience_bench \\
        [--smoke] [--device cpu] [--out BENCH_torch_resilience.json] \\
        [--fault-log resilience_faults.json]
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device, synchronize

BLOCK_SIZE = 8
NUM_BLOCKS = 80
MAX_BATCH = 6
PREFIX_LEN = 8                   # one full shared block per twin pair
TAIL_LEN = 6
MAX_STEPS = 500                  # runaway backstop, not a tuning knob


def make_workload(n_pairs: int, vocab: int, seed: int) -> List[np.ndarray]:
    """Two waves of ``n_pairs`` prompts; wave-2 prompt i shares its first
    ``PREFIX_LEN`` tokens (exactly one block) with wave-1 prompt i and
    nothing with any other pair — so a poisoned block published by one
    request is re-served to exactly one known successor."""
    rng = np.random.default_rng(seed)
    wave1, wave2 = [], []
    for _ in range(n_pairs):
        pre = rng.integers(1, vocab, (PREFIX_LEN,)).astype(np.int32)
        for wave in (wave1, wave2):
            tail = rng.integers(1, vocab, (TAIL_LEN,)).astype(np.int32)
            wave.append(np.concatenate([pre, tail]))
    return wave1 + wave2


def audit_deltas(eng, prompts: List[np.ndarray], max_new: int):
    """Serve ``prompts`` once through ``eng`` (its guard attached) and
    return each readback audit's max logit delta as (workload position,
    delta), in the order the audits ran, and the greedy streams. With a
    guard that cannot quarantine (``GuardConfig(quarantine_error=inf)``)
    these are the clean deltas a deployment's thresholds must clear."""
    seen = []
    audit = eng._readback_audit

    def recording(req, lg):
        err = audit(req, lg)
        seen.append((req.req_id, err))
        return err

    eng._readback_audit = recording
    try:
        handles = [eng.submit(p, max_new) for p in prompts]
        done = eng.run()
    finally:
        del eng._readback_audit
    pos = {h.req_id: i for i, h in enumerate(handles)}
    return [(pos[r], e) for r, e in seen], \
        [list(done[h.req_id].tokens) for h in handles]


def guard_config_for(clean_max: float):
    """The reference's ``GuardConfig`` with its two logit-error thresholds
    raised above a deployment's clean readback deltas (largest
    ``clean_max``): degraded at twice it, quarantine at four times it,
    never below the reference's defaults."""
    from repro_torch.serve import GuardConfig
    d = GuardConfig()
    return GuardConfig(
        logit_error_degraded=max(d.logit_error_degraded, 2.0 * clean_max),
        quarantine_error=max(d.quarantine_error, 4.0 * clean_max))


NO_QUARANTINE = dict(quarantine_error=math.inf,
                     logit_error_degraded=math.inf)


def build_engine(cfg, params, *, max_new: int, device, guard=None,
                 telemetry=None):
    """One warmed engine at the bench's geometry."""
    from repro_torch.serve import ContinuousEngine
    eng = ContinuousEngine(
        cfg, params, block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
        max_batch=MAX_BATCH, max_len=PREFIX_LEN + TAIL_LEN + max_new + 2,
        max_admit_per_step=2, guard=guard, telemetry=telemetry,
        retry_backoff_s=0.002, device=device)
    eng.warmup()
    return eng


def build_engines(cfg, params, *, max_new: int, device, guard_config=None):
    """The three engines of one workload: fault-free, guarded (the canned
    plan, the guard with ``guard_config``, the reference's defaults when
    None) and unguarded (the canned plan alone). Each injector is attached
    after warmup, so the plan's steps address serving steps. Returns
    (fault-free, guarded, its injector, unguarded, its injector)."""
    from repro_torch.serve import EngineGuard, FaultInjector, canned_plan
    eng_base = build_engine(cfg, params, max_new=max_new, device=device)
    eng_guard = build_engine(cfg, params, max_new=max_new, device=device,
                             guard=EngineGuard(guard_config))
    inj_guard = FaultInjector(canned_plan())
    eng_guard.attach_faults(inj_guard)
    eng_plain = build_engine(cfg, params, max_new=max_new, device=device)
    inj_plain = FaultInjector(canned_plan())
    eng_plain.attach_faults(inj_plain)
    return eng_base, eng_guard, inj_guard, eng_plain, inj_plain


def drive(eng, prompts: List[np.ndarray], max_new: int,
          check_each_step: bool = False):
    """One full serve of the workload. Token streams and finish reasons
    come back indexed by WORKLOAD position (req_ids are engine-lifetime
    monotonic — warmup and earlier rounds consume them — so they can't be
    compared across engines). Returns (streams, reasons, wall seconds,
    invariant checks run, delivered tokens)."""
    from repro_torch.serve import check_invariants, leaked_blocks
    handles = [eng.submit(p, max_new) for p in prompts]
    checks = 0
    synchronize(eng.device)
    t0 = time.perf_counter()
    steps = 0
    while eng.sched.has_work():
        eng.step()
        steps += 1
        if check_each_step:
            check_invariants(eng.pool, eng.prefix_cache)
            checks += 1
        if steps > MAX_STEPS:
            raise RuntimeError(f"drive did not converge in {MAX_STEPS} "
                               f"steps (guard stuck?)")
    eng.drain()
    synchronize(eng.device)
    dt = time.perf_counter() - t0
    done = eng.pop_finished()
    toks = [list(done[h.req_id].tokens) if h.req_id in done else None
            for h in handles]
    reasons = [done[h.req_id].finish_reason if h.req_id in done else ""
               for h in handles]
    leaked = leaked_blocks(eng.pool, eng.prefix_cache)
    if leaked:
        raise AssertionError(f"{leaked} blocks leaked after drain")
    delivered = sum(len(t) for t in toks if t)
    return toks, reasons, dt, checks, delivered


def run_rounds(eng_base, eng_guard, prompts, max_new: int, repeats: int):
    """One untimed priming drive per engine, then ``repeats`` paired
    (fault-free, guarded) timed rounds, each engine reset between rounds
    so every round starts from the same cold cache and pool. No per-step
    invariant check inside the timed windows (it is host work the
    fault-free engine does not pay). Returns (per-round ratios, the last
    fault-free streams, last fault-free tok/s, last guarded tok/s)."""
    for eng in (eng_base, eng_guard):
        drive(eng, prompts, max_new)
        eng.reset()
    base_toks: List[Optional[List[int]]] = []
    ratios = []
    tok_s_base = tok_s_guard = 0.0
    for r in range(repeats):
        if r > 0:
            eng_base.reset()
            eng_guard.reset()
        base_toks, _, dt_b, _, n_b = drive(eng_base, prompts, max_new)
        _, _, dt_g, _, n_g = drive(eng_guard, prompts, max_new)
        tok_s_base, tok_s_guard = n_b / dt_b, n_g / dt_g
        ratios.append(tok_s_guard / tok_s_base)
        print(f"resilience,round,{r},tok_s_fault_free,{tok_s_base:.1f},"
              f"tok_s_guarded,{tok_s_guard:.1f},"
              f"ratio,{ratios[-1]:.3f}")
    return ratios, base_toks, tok_s_base, tok_s_guard


def verify(eng_guard, eng_plain, inj_plain, prompts, max_new: int,
           base_toks):
    """The correctness drives. The guarded engine serves the identical
    storm once more (the injector resets with the engine, so it replays
    bit for bit) with the invariant checker after EVERY step: the
    corrupted request was quarantined, every OTHER request's greedy stream
    equals the fault-free run's. The unguarded engine serves the same
    storm with no audit: SOME greedy stream silently diverges. Returns a
    dict of what the gates read."""
    eng_guard.reset()
    guard_toks, guard_reasons, _, checks_g, _ = drive(
        eng_guard, prompts, max_new, check_each_step=True)
    victims = sorted(i for i, why in enumerate(guard_reasons)
                     if why == "quarantined")
    mismatched = sorted(i for i, t in enumerate(guard_toks)
                        if i not in victims and t != base_toks[i])
    m = eng_guard.metrics
    print(f"resilience,guarded,faults,{m.faults_injected},"
          f"retries,{m.transient_retries},quarantined,{m.quarantined},"
          f"preemptions,{m.preemptions},"
          f"guard_transitions,{len(eng_guard.guard.transitions)},"
          f"invariant_checks,{checks_g}")
    print(f"resilience,guarded,victims,{victims},"
          f"nonvictim_mismatches,{mismatched}")
    plain_toks, _, _, checks_p, _ = drive(
        eng_plain, prompts, max_new, check_each_step=True)
    divergent = sorted(i for i, t in enumerate(plain_toks)
                       if t != base_toks[i])
    corrupted = inj_plain.corrupted_req_ids()
    print(f"resilience,unguarded,corrupted_req_ids,{corrupted},"
          f"divergent_indices,{divergent}")
    return {"victims": victims, "mismatched": mismatched,
            "divergent": divergent, "corrupted": corrupted,
            "checks": checks_g + checks_p, "guard_streams": guard_toks,
            "guard_reasons": guard_reasons, "plain_streams": plain_toks}


def gate_failures(ratio: float, min_ratio: float, v) -> List[str]:
    """The four gates, as the reference words them."""
    failures = []
    if ratio < min_ratio:
        failures.append(f"guarded tok/s ratio {ratio:.3f} < {min_ratio}")
    if v["mismatched"]:
        failures.append(f"guarded non-victim streams diverged: "
                        f"{v['mismatched']}")
    if not v["victims"]:
        failures.append("guarded drive quarantined nothing (kv_corrupt "
                        "missed or audit failed)")
    if not v["divergent"]:
        failures.append("unguarded drive did not diverge (the injected "
                        "corruption had no effect?)")
    return failures


def record(args, device, ratio, tok_s_base, tok_s_guard, eng_guard, v,
           failures):
    """The JSON record: the reference's fields, the port's provenance
    header."""
    from repro_torch.benchmarks.provenance import provenance
    m = eng_guard.metrics
    return {
        "bench": "resilience",
        "provenance": provenance(
            mode="cuda" if device.type == "cuda" else "cpu-plain"),
        "workload": {"pairs": args.pairs, "max_new": args.max_new,
                     "prefix_len": PREFIX_LEN, "tail_len": TAIL_LEN,
                     "block_size": BLOCK_SIZE, "num_blocks": NUM_BLOCKS,
                     "max_batch": MAX_BATCH, "seed": args.seed,
                     "arch": args.arch, "reduced": True,
                     "smoke": args.smoke},
        "backend": device.type,
        "tok_s_fault_free": round(tok_s_base, 2),
        "tok_s_guarded": round(tok_s_guard, 2),
        "tok_s_ratio_guarded_over_fault_free": round(ratio, 4),
        "min_ratio_gate": args.min_ratio,
        "faults_injected": m.faults_injected,
        "transient_retries": m.transient_retries,
        "quarantined_indices": v["victims"],
        "guard_transitions": eng_guard.guard.transitions,
        "invariant_checks": v["checks"],
        "invariant_violations": 0,
        "leaked_blocks": 0,
        "guarded_nonvictim_mismatches": v["mismatched"],
        "unguarded_corrupted_req_ids": v["corrupted"],
        "unguarded_divergent_indices": v["divergent"],
        "gates_passed": not failures,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--pairs", type=int, default=8,
                    help="twin prompt pairs (2x this many requests)")
    ap.add_argument("--max-new", type=int, default=96,
                    help="tokens per request; large enough that the "
                         "plan's fixed costs (stalls, retry backoff, "
                         "readback audits) amortize the way they would "
                         "on a real serving window")
    ap.add_argument("--repeats", type=int, default=3,
                    help="paired (fault-free, guarded) timing rounds; the "
                         "reported ratio is the best round (absorbs host "
                         "noise at smoke scale)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-ratio", type=float, default=0.70,
                    help="gate: guarded tok/s as a fraction of fault-free")
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: fewer timing rounds, same gates")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the BENCH record (provenance + results)")
    ap.add_argument("--fault-log", default=None, metavar="PATH",
                    help="write the guarded drive's fault-injection replay "
                         "artifact")
    args = ap.parse_args(argv)
    if args.smoke:
        args.repeats = 2
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = make_workload(args.pairs, cfg.vocab_size, args.seed)

    eng_base, eng_guard, inj_guard, eng_plain, inj_plain = build_engines(
        cfg, params, max_new=args.max_new, device=device)
    ratios, base_toks, tok_s_base, tok_s_guard = run_rounds(
        eng_base, eng_guard, prompts, args.max_new, args.repeats)
    ratio = float(max(ratios))
    v = verify(eng_guard, eng_plain, inj_plain, prompts, args.max_new,
               base_toks)
    failures = gate_failures(ratio, args.min_ratio, v)

    if args.fault_log:
        inj_guard.save_log(args.fault_log)
        print(f"resilience,fault_log,{args.fault_log}")
    if args.out:
        rec = record(args, device, ratio, tok_s_base, tok_s_guard,
                     eng_guard, v, failures)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
            f.write("\n")
        print(f"resilience,record,{args.out}")

    if failures:
        raise AssertionError("resilience gates failed: " +
                             "; ".join(failures))
    print(f"resilience,ratio_guarded_over_fault_free,{ratio:.3f}")
    return ratio


if __name__ == "__main__":
    main()
