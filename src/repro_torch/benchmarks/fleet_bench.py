"""Fleet serving: multi-replica scaling, prefix-affinity routing, and
journaled failover under the canned fleet fault plan — the JAX package's
``benchmarks/fleet_bench.py`` on the port.

One Poisson multi-tenant twin-prefix workload (``--tenants`` tenants, each
with a shared prompt prefix and ``--per-tenant`` requests arriving on a
seeded exponential clock) driven through fleet configurations built from
identical ``ContinuousEngine`` replicas:

* single   — one replica, affinity router: the scaling baseline;
* fleet    — ``--replicas`` replicas, affinity router: the scaling and
  prefix-locality measurement (also the fault-free stream reference);
* fleet-rr — same replicas, round-robin router: the routing baseline
  affinity is gated against;
* chaos    — the affinity fleet under ``canned_fleet_plan`` (replica 0
  crashes at the workload midpoint; replica 1 hangs shortly after and
  recovers), with the write-ahead journal attached and the pool/radix
  invariant checker run after every supervision tick.

Gates (the bench fails loudly on any):

* aggregate tokens **per supervision tick** of the fleet >=
  ``--min-scaling`` (default 1.6) x the single replica's. One tick is one
  lockstep round of replica steps — on N devices it costs one step time,
  so tok/tick is the device-parallel throughput model and is exactly
  deterministic (one card timeshares every replica here, so wall tok/s —
  reported, not gated — cannot show the scaling);
* the affinity router's fleet-wide prefix-cache hit rate beats
  round-robin's on the same workload;
* under the chaos plan every request completes (``finish_reason
  "length"``), at least one request failed over, and every greedy stream
  is byte-identical to the fault-free fleet reference;
* zero invariant violations during the chaos drive and zero leaked blocks
  on every surviving pool after it drains;
* ``journal.replay()`` (in memory AND from the JSONL file) reconstructs
  every request's tokens and terminal state exactly.

The replicas step in threads (``step_parallel``), all on the device's
default stream. Every timed drive ends in a device synchronize before the
clock is read. With ``--out`` it writes the record
(``BENCH_torch_fleet.json`` by convention) with the port's provenance
header; ``--journal-out`` writes the chaos drive's journal.

    PYTHONPATH=src python -m repro_torch.benchmarks.fleet_bench \\
        [--smoke] [--device cpu] [--out BENCH_torch_fleet.json] \\
        [--journal-out fleet_journal.jsonl]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device, synchronize

BLOCK_SIZE = 8
NUM_BLOCKS = 64
MAX_BATCH = 4
PREFIX_LEN = 16                  # two full shared blocks per tenant
TAIL_LEN = 8
HANG_GRACE_TICKS = 2
MAX_TICKS = 20_000               # runaway backstop, not a tuning knob


def make_workload(tenants: int, per_tenant: int, mean_gap: float,
                  vocab: int, seed: int) -> List[Tuple[int, np.ndarray]]:
    """Poisson multi-tenant arrivals: each tenant owns a shared
    ``PREFIX_LEN``-token prefix; its requests are that prefix plus a
    private random tail. Arrival gaps are exponential (mean ``mean_gap``
    supervision ticks) on a seeded RNG, interleaved across tenants in
    arrival order — so prefix affinity has to win against mixed traffic,
    not conveniently batched tenants. Returns ``[(arrival_tick, prompt),
    ...]`` sorted by arrival."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab, (PREFIX_LEN,)).astype(np.int32)
                for _ in range(tenants)]
    arrivals = []
    t = 0.0
    order = rng.permutation(np.repeat(np.arange(tenants), per_tenant))
    for tenant in order:
        t += rng.exponential(mean_gap)
        tail = rng.integers(1, vocab, (TAIL_LEN,)).astype(np.int32)
        arrivals.append((int(t), np.concatenate([prefixes[tenant], tail])))
    return arrivals


def build_engines(cfg, params, n: int, max_new: int, *,
                  device) -> List[object]:
    """``n`` warmed replicas at the bench's geometry, sharing ``params``."""
    from repro_torch.serve import ContinuousEngine
    engines = []
    for _ in range(n):
        eng = ContinuousEngine(
            cfg, params, block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
            max_batch=MAX_BATCH,
            max_len=PREFIX_LEN + TAIL_LEN + max_new + 2,
            max_admit_per_step=2, retry_backoff_s=0.0, device=device)
        eng.warmup()
        engines.append(eng)
    return engines


def drive(engines, arrivals, max_new: int, *, policy: str = "affinity",
          faults=None, journal=None, check_each_tick: bool = False,
          step_parallel: Optional[bool] = None):
    """One full serve of the arrival schedule: submit each request on its
    arrival tick, tick the supervisor until the fleet drains. The replicas
    step in threads when there are several (``step_parallel`` None), or as
    ``step_parallel`` says. Returns (supervisor, tracked requests, wall
    seconds)."""
    from repro_torch.serve import FleetSupervisor, Router
    sup = FleetSupervisor(
        engines, router=Router(policy), journal=journal, faults=faults,
        hang_grace_ticks=HANG_GRACE_TICKS,
        check_invariants_each_tick=check_each_tick,
        step_parallel=(len(engines) > 1 if step_parallel is None
                       else step_parallel))
    treqs = []
    i = 0
    synchronize(engines[0].device)
    t0 = time.time()
    while i < len(arrivals) or sup.has_work():
        while i < len(arrivals) and arrivals[i][0] <= sup.ticks:
            treqs.append(sup.submit(arrivals[i][1], max_new))
            i += 1
        sup.tick()
        if sup.ticks > MAX_TICKS:
            raise RuntimeError(f"fleet did not drain in {MAX_TICKS} ticks")
    synchronize(engines[0].device)
    dt = time.time() - t0
    if sup._pool is not None:          # timed window excludes pool teardown
        sup._pool.shutdown(wait=True)
        sup._pool = None
    return sup, treqs, dt


def hit_rate(sup) -> float:
    """Fleet-wide prefix-cache hit rate: hit tokens over looked-up tokens,
    summed across every replica's radix tree (dead replicas included —
    their pre-crash lookups happened)."""
    hit = total = 0
    for r in sup.replicas:
        cs = r.engine.prefix_cache.stats
        hit += cs.hit_tokens
        total += cs.lookup_tokens
    return hit / total if total else 0.0


def delivered(treqs) -> int:
    return sum(len(t.result.tokens) for t in treqs)


def chaos_plan(fleet_ticks: int, replicas: int):
    """The chaos drive's plan: replica 0 crashes at the fault-free fleet
    drive's midpoint tick, replica 1 hangs four ticks later for four
    ticks. Returns (plan, crash tick)."""
    from repro_torch.serve import canned_fleet_plan
    mid = max(2, fleet_ticks // 2)
    return canned_fleet_plan(crash_tick=mid, crash_replica=0,
                             hang_tick=mid + 4, hang_ticks=4,
                             hang_replica=min(1, replicas - 1)), mid


def chaos_verdict(sup_c, treqs_c, journal, ref_streams,
                  journal_path: Optional[str] = None) -> Dict:
    """What the chaos gates read: failovers, requests not finished by
    length, streams that differ from the fault-free fleet's, leaked blocks
    on the surviving pools, whether the journal (in memory, and loaded
    from ``journal_path`` when written) replays to the tracker, and the
    journal's replica events."""
    from repro_torch.serve import Journal, leaked_blocks
    from repro_torch.serve.supervisor import SERVING
    streams = [list(t.result.tokens) for t in treqs_c]
    replay_sources = [journal.replay()]
    if journal_path:
        replay_sources.append(Journal.load(journal_path).replay())
    return {
        "streams": streams,
        "failovers": sum(t.n_failovers for t in treqs_c),
        "not_ok": [t.rid for t in treqs_c if not t.result.ok],
        "mismatched": [i for i, s in enumerate(streams)
                       if s != ref_streams[i]],
        "leaks": {r.name: leaked_blocks(r.engine.pool,
                                        r.engine.prefix_cache)
                  for r in sup_c.replicas if r.state == SERVING},
        "replay_exact": all(
            st.requests[t.rid].tokens == list(t.result.tokens)
            and st.requests[t.rid].finish_reason == t.result.finish_reason
            and st.requests[t.rid].n_failovers == t.n_failovers
            for st in replay_sources for t in treqs_c),
        "events": [(e["event"], e["replica"], e["tick"])
                   for e in journal.replay().replica_events],
    }


def gate_failures(scaling: float, min_scaling: float, affinity_hits: float,
                  rr_hits: float, rr_streams, ref_streams, chaos: Dict,
                  ttft_count: int, n_req: int) -> List[str]:
    """The bench's gates, as the reference words them."""
    failures = []
    if scaling < min_scaling:
        failures.append(f"fleet tok/tick scaling {scaling:.2f} < "
                        f"{min_scaling}")
    if affinity_hits <= rr_hits:
        failures.append(f"affinity hit rate {affinity_hits:.3f} did not "
                        f"beat round-robin {rr_hits:.3f}")
    if chaos["mismatched"]:
        failures.append(f"chaos streams diverged from fault-free fleet: "
                        f"{chaos['mismatched']}")
    if rr_streams != ref_streams:
        failures.append("round-robin streams diverged (placement must "
                        "never change greedy tokens)")
    if chaos["not_ok"]:
        failures.append(f"chaos requests did not complete: "
                        f"{chaos['not_ok']}")
    if chaos["failovers"] == 0:
        failures.append("chaos drive failed nothing over (crash plan "
                        "missed the in-flight window?)")
    if any(chaos["leaks"].values()):
        failures.append(f"leaked blocks on surviving pools: "
                        f"{chaos['leaks']}")
    if not chaos["replay_exact"]:
        failures.append("journal replay did not reconstruct the tracker")
    if ttft_count != n_req:
        failures.append(f"fleet TTFT sampled {ttft_count} times for "
                        f"{n_req} requests (migration double-count?)")
    return failures


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--per-tenant", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--mean-gap", type=float, default=0.75,
                    help="mean Poisson arrival gap in supervision ticks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-scaling", type=float, default=1.6,
                    help="gate: fleet tok/tick over single-replica "
                         "tok/tick")
    ap.add_argument("--smoke", action="store_true",
                    help="CI scale: smaller workload, same gates")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the BENCH record (provenance + results)")
    ap.add_argument("--journal-out", default=None, metavar="PATH",
                    help="write the chaos drive's write-ahead journal "
                         "(JSONL replay artifact)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.tenants, args.per_tenant, args.max_new = 4, 4, 24
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import FaultInjector, Journal

    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    arrivals = make_workload(args.tenants, args.per_tenant, args.mean_gap,
                             cfg.vocab_size, args.seed)
    n_req = len(arrivals)

    engines = build_engines(cfg, params, args.replicas, args.max_new,
                            device=device)

    def reset():
        for e in engines:
            e.reset()

    # priming drive: warmup() built the kernels, but the first serve still
    # pays one-time costs that would pollute the reported wall numbers
    drive(engines, arrivals, args.max_new)
    reset()

    # -- phase 1: scaling, 1 vs N replicas --------------------------------
    sup_1, treqs_1, dt_1 = drive(engines[:1], arrivals, args.max_new)
    engines[0].reset()
    sup_n, treqs_n, dt_n = drive(engines, arrivals, args.max_new)
    toks_1, toks_n = delivered(treqs_1), delivered(treqs_n)
    tpt_1 = toks_1 / sup_1.ticks
    tpt_n = toks_n / sup_n.ticks
    scaling = tpt_n / tpt_1
    ref_streams = [list(t.result.tokens) for t in treqs_n]
    affinity_hits = hit_rate(sup_n)
    print(f"fleet,scaling,replicas,{args.replicas},requests,{n_req},"
          f"tok_per_tick_single,{tpt_1:.2f},tok_per_tick_fleet,{tpt_n:.2f},"
          f"ratio,{scaling:.2f}")
    print(f"fleet,wall_informational,tok_s_single,{toks_1 / dt_1:.1f},"
          f"tok_s_fleet,{toks_n / dt_n:.1f} (the replicas timeshare one "
          f"device and one host; the tick ratio above is the "
          f"device-parallel model)")

    # -- phase 2: affinity vs round-robin routing -------------------------
    reset()
    sup_rr, treqs_rr, _ = drive(engines, arrivals, args.max_new,
                                policy="round-robin")
    rr_hits = hit_rate(sup_rr)
    rr_streams = [list(t.result.tokens) for t in treqs_rr]
    print(f"fleet,routing,affinity_hit_rate,{affinity_hits:.3f},"
          f"round_robin_hit_rate,{rr_hits:.3f}")

    # -- phase 3: chaos — canned fleet plan + journal + invariants --------
    reset()
    plan, mid = chaos_plan(sup_n.ticks, args.replicas)
    journal = Journal(path=args.journal_out)
    sup_c, treqs_c, _ = drive(engines, arrivals, args.max_new,
                              faults=FaultInjector(plan), journal=journal,
                              check_each_tick=True)
    journal.close()
    chaos = chaos_verdict(sup_c, treqs_c, journal, ref_streams,
                          args.journal_out)
    ttft = sup_c.tracker.h_ttft
    p50, p99 = ttft.quantile(0.5), ttft.quantile(0.99)
    print(f"fleet,chaos,crash_tick,{mid},events,{chaos['events']},"
          f"failovers,{chaos['failovers']},"
          f"mismatched,{chaos['mismatched']},not_ok,{chaos['not_ok']},"
          f"leaked,{chaos['leaks']},replay_exact,{chaos['replay_exact']}")
    print(f"fleet,chaos,ttft_p50_ms,{p50 * 1e3:.2f},"
          f"ttft_p99_ms,{p99 * 1e3:.2f},samples,{ttft.count}")

    failures = gate_failures(scaling, args.min_scaling, affinity_hits,
                             rr_hits, rr_streams, ref_streams, chaos,
                             ttft.count, n_req)

    if args.out:
        from repro_torch.benchmarks.provenance import provenance
        rec = {
            "bench": "fleet",
            "provenance": provenance(
                mode="cuda" if device.type == "cuda" else "cpu-plain"),
            "workload": {
                "replicas": args.replicas, "tenants": args.tenants,
                "per_tenant": args.per_tenant, "requests": n_req,
                "max_new": args.max_new, "mean_gap_ticks": args.mean_gap,
                "prefix_len": PREFIX_LEN, "tail_len": TAIL_LEN,
                "block_size": BLOCK_SIZE, "num_blocks": NUM_BLOCKS,
                "max_batch": MAX_BATCH, "seed": args.seed,
                "arch": args.arch, "reduced": True, "smoke": args.smoke},
            "backend": device.type,
            "tok_per_tick_single": round(tpt_1, 3),
            "tok_per_tick_fleet": round(tpt_n, 3),
            "scaling_ratio_fleet_over_single": round(scaling, 4),
            "min_scaling_gate": args.min_scaling,
            "wall_tok_s_single_informational": round(toks_1 / dt_1, 1),
            "wall_tok_s_fleet_informational": round(toks_n / dt_n, 1),
            "affinity_hit_rate": round(affinity_hits, 4),
            "round_robin_hit_rate": round(rr_hits, 4),
            "chaos": {
                "crash_tick": mid, "replica_events": chaos["events"],
                "failovers": chaos["failovers"],
                "replicas_crashed": int(sup_c.c_crashed.value),
                "replicas_hung": int(sup_c.c_hung.value),
                "stream_mismatches": chaos["mismatched"],
                "incomplete_requests": chaos["not_ok"],
                "leaked_blocks": chaos["leaks"],
                "journal_records": len(journal.records),
                "replay_exact": chaos["replay_exact"],
                "ttft_p50_ms": round(p50 * 1e3, 3),
                "ttft_p99_ms": round(p99 * 1e3, 3)},
            "gates_passed": not failures,
        }
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
            f.write("\n")
        print(f"fleet,record,{args.out}")
    if args.journal_out:
        print(f"fleet,journal,{args.journal_out}")

    if failures:
        raise AssertionError("fleet gates failed: " + "; ".join(failures))
    print(f"fleet,scaling_ratio_fleet_over_single,{scaling:.3f}")
    return scaling


if __name__ == "__main__":
    main()
