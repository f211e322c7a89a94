"""Durable serving state: SIGKILL mid-workload, restore, byte-identical —
the JAX package's ``benchmarks/restore_bench.py`` on the port.

The crash-consistency gate for ``serve/snapshot.py`` + the journal
durability layer. A child process serves a deterministic workload through
a 1-replica ``FleetSupervisor`` with per-tick snapshots and a write-ahead
journal, and SIGKILLs **itself** (no atexit, no flush — real process
death) once an adversarial state condition holds:

* ``midprefill``     — a long prompt is mid-chunked-prefill
  (``0 < n_prefilled < prompt_len``), so the last snapshot carries a
  partially-resident prompt and chunk cursor;
* ``midcow``         — a shared non-block-aligned prefix has triggered a
  copy-on-write (``cow_copies > 0``) and a first-wave request has already
  completed, so the snapshot carries a COW'd partial tail next to its
  still-shared radix sibling, plus finished chains that exist nowhere but
  the tree;
* ``postquarantine`` — a kv_corrupt fault fired and the guard quarantined
  the victim, so the snapshot carries a purged subtree and the journal a
  ``quarantined`` terminal.

The parent then restores **in-process** from the child's artifacts
(snapshot warm start with fsck, journal-suffix adoption, recompute
resubmission of in-flight requests) and drives the workload to drain.

Gates (the bench fails loudly on any):

* the child actually died by SIGKILL at every kill point, after at least
  one durable snapshot;
* every recovered greedy stream (tokens AND finish reason, including the
  quarantined victim) is byte-identical to an uninterrupted in-process
  reference run of the same workload;
* ``check_invariants`` passes immediately after restore (fsck) and zero
  blocks leak once the recovered run drains;
* the recovered run's new journal replays to exactly the tracker's
  terminal state (completed streams match the journal);
* a deliberately corrupted snapshot falls back to **cold** recovery — and
  still reproduces byte-identical streams from the journal alone, rather
  than serving poisoned KV;
* warm restart beats cold restart for fresh traffic extending prompts
  that completed before the crash — chains only the snapshot remembers —
  both deterministically: fewer prefill tokens computed (the restored
  radix tree re-hits) and fewer supervision ticks to first token (one
  suffix chunk instead of re-prefilling the whole stem chunk by chunk).

The child is this module run again (``python -m
repro_torch.benchmarks.restore_bench --child CASE``) on the same
``--device``; it rebuilds the same weights from the same seed. With
``--out`` it writes the record (``BENCH_torch_restore.json`` by
convention) with the port's provenance header; the child journals and
snapshots live under ``--artifacts``.

    PYTHONPATH=src python -m repro_torch.benchmarks.restore_bench \\
        [--smoke] [--device cpu] [--out BENCH_torch_restore.json] \\
        [--artifacts restore_artifacts]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

BLOCK_SIZE = 8
NUM_BLOCKS = 48
MAX_BATCH = 3
PREFIX_LEN = 12                  # 1.5 blocks: the shared tail block is
#                                  partial, so a re-hit must COW it
TAIL_LEN = 8
PREFILL_CHUNK = 8
KILL_CASES = ("midprefill", "midcow", "postquarantine")
MAX_TICKS = 20_000               # runaway backstop, not a tuning knob
CHILD_EXIT_NO_KILL = 3           # child drained without hitting the
#                                  kill condition: a bench bug
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # the directory holding repro_torch/


def _setup(arch: str = "qwen3-4b"):
    """The reduced model and its weights from seed 0 (the child and the
    parent build the same ones)."""
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    cfg = reduce_config(get_config(arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    return cfg, params


def case_workload(case: str, vocab: int, seed: int, n_req: int
                  ) -> List[Tuple[int, np.ndarray]]:
    """Deterministic ``[(arrival_tick, prompt)]`` per (case, seed) — the
    child, the reference run, and the recovery all rebuild it bit for bit
    from the same RNG stream."""
    rng = np.random.default_rng(seed + 17 * KILL_CASES.index(case))
    if case == "midprefill":
        # long documents: several PREFILL_CHUNK-token chunks each, so
        # there is always a partially-prefilled request to kill over
        plen = 4 * PREFILL_CHUNK
        return [(0, rng.integers(1, vocab, (plen,)).astype(np.int32))
                for _ in range(n_req)]
    # two tenants sharing non-block-aligned PREFIX_LEN prefixes; the
    # second wave re-hits the published partial tail block (COW). The
    # quarantine case reuses the same shape (victims carry shared blocks)
    prefixes = [rng.integers(1, vocab, (PREFIX_LEN,)).astype(np.int32)
                for _ in range(2)]
    arrivals = []
    for i in range(n_req):
        tail = rng.integers(1, vocab, (TAIL_LEN,)).astype(np.int32)
        tick = 0 if i < 2 else 4 + 2 * (i - 2)
        arrivals.append((tick, np.concatenate([prefixes[i % 2], tail])))
    return arrivals


def fresh_batch(arrivals, vocab: int, seed: int, n: int) -> List[np.ndarray]:
    """New requests extending the original workload's prompts with fresh
    tails — the warm-vs-cold restart measurement traffic. A warm
    (snapshot-restored) radix tree serves the whole shared stem as prefix
    hits; a cold tree has to prefill it chunk by chunk."""
    rng = np.random.default_rng(seed + 9999)
    return [np.concatenate([arrivals[i % len(arrivals)][1],
                            rng.integers(1, vocab, (TAIL_LEN,))
                            .astype(np.int32)])
            for i in range(n)]


def make_factory(cfg, params, case: str, max_new: int, *, device,
                 prefill_chunk: Optional[int] = None, guard_config=None):
    """A factory of warmed engines at the bench's geometry. The quarantine
    case's guard takes ``guard_config`` (the reference's ``GuardConfig``
    defaults when None; a deployment at another width derives its own, as
    ``resilience_bench.guard_config_for`` does)."""
    from repro_torch.serve import ContinuousEngine, EngineGuard

    if prefill_chunk is None:
        prefill_chunk = PREFILL_CHUNK if case == "midprefill" else 0

    def factory():
        eng = ContinuousEngine(
            cfg, params, block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
            max_batch=MAX_BATCH,
            max_len=4 * PREFILL_CHUNK + TAIL_LEN + max_new + 2,
            max_admit_per_step=2, retry_backoff_s=0.0,
            prefill_chunk=prefill_chunk,
            guard=(EngineGuard(guard_config) if case == "postquarantine"
                   else None),
            device=device)
        eng.warmup()
        return eng
    return factory


def build_fleet(factory, case: str, journal=None, snapshot_dir=None,
                snapshot_every: int = 0):
    """One-replica supervised fleet; the quarantine case gets the
    deterministic kv_corrupt plan attached to the serving engine."""
    from repro_torch.serve import (FaultInjector, FaultPlan, FaultSpec,
                                   FleetSupervisor, Router)
    eng = factory()
    if case == "postquarantine":
        plan = FaultPlan(seed=0, specs=[
            FaultSpec("kv_corrupt", step=4, duration=2)])
        eng.attach_faults(FaultInjector(plan))
    return FleetSupervisor([eng], router=Router("affinity"),
                           journal=journal, snapshot_dir=snapshot_dir,
                           snapshot_every=snapshot_every,
                           max_attempts=1000)


def kill_condition(case: str, sup) -> bool:
    if int(sup.c_snapshots.value) < 1:
        return False           # die only once a durable snapshot exists
    eng = sup.replicas[0].engine
    if case == "midprefill":
        return any(0 < r.n_prefilled < r.prompt_len
                   for r in eng.sched.running)
    if case == "midcow":
        # COW has fired AND a first-wave request already completed: the
        # snapshot then carries chains whose requests are terminal in the
        # journal — a cold resume never re-places those, so their KV
        # survives only in the warm tree (the warm-vs-cold phase extends
        # exactly those prompts)
        return (eng.pool.stats.cow_copies > 0
                and any(t.result is not None
                        for t in sup.tracker.requests.values()))
    return any(t.result is not None
               and t.result.finish_reason == "quarantined"
               for t in sup.tracker.requests.values())


def drive(sup, arrivals, max_new: int, kill_case: Optional[str] = None,
          stop_at_kill: bool = False):
    """Submit each request on its arrival tick; tick until drained. In the
    child, SIGKILL ourselves the moment the kill condition holds — between
    ticks, exactly where a real crash would land. With ``stop_at_kill``
    the drive returns there instead (the in-process stand-in: the caller
    abandons the supervisor unflushed)."""
    pending = sorted(arrivals, key=lambda a: a[0])
    i = 0
    while i < len(pending) or sup.has_work():
        while i < len(pending) and pending[i][0] <= sup.ticks:
            sup.submit(pending[i][1], max_new)
            i += 1
        sup.tick()
        if kill_case is not None and kill_condition(kill_case, sup):
            if stop_at_kill:
                return sup
            os.kill(os.getpid(), signal.SIGKILL)
        if sup.ticks > MAX_TICKS:
            raise RuntimeError(f"workload did not drain in {MAX_TICKS}")
    return sup


def streams_of(sup) -> Dict[int, Tuple[List[int], str]]:
    return {rid: (list(t.result.tokens), t.result.finish_reason)
            for rid, t in sup.tracker.requests.items()
            if t.result is not None}


# ---------------------------------------------------------------------------
# child: serve until the kill point, then die for real
# ---------------------------------------------------------------------------

def run_child(args) -> None:
    from repro_torch.serve import Journal
    device = resolve_device(args.device)
    cfg, params = _setup(args.arch)
    arrivals = case_workload(args.child, cfg.vocab_size, args.seed,
                             args.n_req)
    factory = make_factory(cfg, params, args.child, args.max_new,
                           device=device)
    os.makedirs(args.artifacts, exist_ok=True)
    # quarantine terminals must be durable before death (a lost terminal
    # just regenerates tokens, but a *reason* is not recomputable once the
    # fault plan is gone); the other cases exercise the default interval
    # policy and its bounded tail-loss window
    journal = Journal(
        path=os.path.join(args.artifacts, "journal.jsonl"),
        fsync="always" if args.child == "postquarantine" else "interval",
        fsync_every=4)
    sup = build_fleet(factory, args.child, journal=journal,
                      snapshot_dir=os.path.join(args.artifacts, "snaps"),
                      snapshot_every=1)
    drive(sup, arrivals, args.max_new, kill_case=args.child)
    print(f"restore,child,{args.child},kill_condition_never_reached")
    sys.exit(CHILD_EXIT_NO_KILL)


def spawn_child(case: str, artifacts: str, seed: int, n_req: int,
                max_new: int, device: str, arch: str = "qwen3-4b") -> int:
    """Run the child for ``case`` in a process of its own; returns its exit
    code (``-SIGKILL`` when it died at the kill point)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.restore_bench",
         "--child", case, "--artifacts", os.path.abspath(artifacts),
         "--seed", str(seed), "--n-req", str(n_req),
         "--max-new", str(max_new), "--device", device, "--arch", arch],
        env=env, capture_output=True, text=True, timeout=1800)
    if proc.returncode != -signal.SIGKILL:
        print(proc.stdout)
        print(proc.stderr, file=sys.stderr)
    return proc.returncode


# ---------------------------------------------------------------------------
# parent: restore + verify
# ---------------------------------------------------------------------------

def recover(factory, case: str, artifacts: str, arrivals, max_new: int,
            snapshot_dir: Optional[str], journal_out: Optional[str] = None,
            extra_prompts: Optional[List[np.ndarray]] = None):
    """Resume from the child's artifacts and drive the workload to drain.
    Returns (supervisor, info) where info carries the per-phase evidence
    the gates consume."""
    from repro_torch.serve import (FleetSupervisor, Journal, Router,
                                   check_invariants, leaked_blocks, replay)
    jpath = os.path.join(artifacts, "journal.jsonl")
    newj = Journal(path=journal_out) if journal_out else None
    sup = FleetSupervisor.resume(
        factory, 1, jpath, snapshot_dir=snapshot_dir, journal=newj,
        router=Router("affinity"), max_attempts=1000)
    # fsck gate immediately after restore, before any new work
    for r in sup.replicas:
        check_invariants(r.engine.pool, r.engine.prefix_cache)
    adopted = int(sup.tracker.c_recovered.value)
    # a warm restore carries the dead process's counters (snapshots are
    # exact); warm-vs-cold must compare work done SINCE the restore
    eng0 = sup.replicas[0].engine
    pre_prefill = int(eng0.metrics.prefill_tokens)
    pre_hits = int(eng0.prefix_cache.stats.hit_tokens)
    # workload requests the dead process never journaled get submitted
    # fresh (arrival order == rid order, so the suffix lines up), plus any
    # measurement traffic — BEFORE the drive, so warm-vs-cold TTFT sees
    # the restored (or empty) radix tree, not one rebuilt mid-run
    t0 = time.time()
    for _, p in sorted(arrivals, key=lambda a: a[0])[adopted:]:
        sup.submit(p, max_new)
    extra_rids = [sup.submit(p, max_new).rid
                  for p in (extra_prompts or [])]
    # TTFT in supervision ticks (chunked-prefill steps to first token):
    # deterministic, so warm-vs-cold is free of timing noise
    submit_tick = sup.ticks
    first_tick: Dict[int, int] = {}
    while sup.has_work():
        sup.tick()
        for rid in extra_rids:
            if rid not in first_tick and sup.tracker.requests[rid].tokens:
                first_tick[rid] = sup.ticks
        if sup.ticks - submit_tick > MAX_TICKS:
            raise RuntimeError(f"resumed run did not drain in {MAX_TICKS}")
    wall = time.time() - t0
    eng = sup.replicas[0].engine
    info = {
        "mode": sup.restore_info[0]["mode"],
        "reason": sup.restore_info[0]["reason"],
        "adopted": adopted,
        "tail_lost": int(sup.tracker.c_tail_lost.value),
        "leaked": leaked_blocks(eng.pool, eng.prefix_cache),
        "prefill_tokens": int(eng.metrics.prefill_tokens) - pre_prefill,
        "prefix_hit_tokens":
            int(eng.prefix_cache.stats.hit_tokens) - pre_hits,
        "ttft_ticks": sorted(first_tick[r] - submit_tick
                             for r in extra_rids),
        "ttft_p50_s": sup.tracker.h_ttft.quantile(0.5),
        "wall_s": wall,
    }
    if newj is not None:
        st = replay(newj.records)
        live = streams_of(sup)
        info["journal_matches_streams"] = all(
            list(st.requests[rid].tokens) == toks
            and st.requests[rid].finish_reason == why
            for rid, (toks, why) in live.items())
        newj.close()
    check_invariants(eng.pool, eng.prefix_cache)
    return sup, info


def corrupt_snapshot(path: str) -> None:
    """Flip a byte span in the middle of the snapshot payload — a section
    checksum must catch it."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(8)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def warm_vs_cold(warm: Dict, cold: Dict) -> Tuple[float, int, int, List]:
    """The warm-restart gates: (cold over warm prefill tokens, warm and
    cold median ticks to first token, failures)."""
    ratio = cold["prefill_tokens"] / max(1, warm["prefill_tokens"])
    warm_ttft = warm["ttft_ticks"][len(warm["ttft_ticks"]) // 2]
    cold_ttft = cold["ttft_ticks"][len(cold["ttft_ticks"]) // 2]
    failures = []
    if warm["mode"] != "warm" or cold["mode"] != "cold":
        failures.append(f"warm/cold phase modes wrong: "
                        f"{warm['mode']}/{cold['mode']}")
    if warm["prefill_tokens"] >= cold["prefill_tokens"]:
        failures.append(
            f"warm restart did not save prefill: {warm['prefill_tokens']}"
            f" >= {cold['prefill_tokens']} tokens")
    if warm_ttft >= cold_ttft:
        failures.append(
            f"warm-restart TTFT p50 {warm_ttft} ticks did not beat "
            f"cold {cold_ttft} ticks")
    return ratio, warm_ttft, cold_ttft, failures


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on, the child's too (default: the "
                         "CUDA card; 'cpu' runs the kernels' plain "
                         "versions)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=41)
    ap.add_argument("--n-req", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--fresh", type=int, default=4,
                    help="fresh shared-stem requests for warm-vs-cold")
    ap.add_argument("--out", default=None, metavar="PATH")
    ap.add_argument("--artifacts", default="restore_artifacts",
                    metavar="DIR")
    ap.add_argument("--child", choices=KILL_CASES, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.smoke and not args.child:
        args.n_req, args.max_new, args.fresh = 4, 6, 2
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    if args.child:
        run_child(args)
        return 0.0
    device = resolve_device(args.device)

    cfg, params = _setup(args.arch)
    failures: List[str] = []
    cases: Dict[str, Dict] = {}
    shutil.rmtree(args.artifacts, ignore_errors=True)

    for case in KILL_CASES:
        adir = os.path.join(args.artifacts, case)
        arrivals = case_workload(case, cfg.vocab_size, args.seed,
                                 args.n_req)
        factory = make_factory(cfg, params, case, args.max_new,
                               device=device)

        # uninterrupted in-process reference: the byte-identity oracle
        ref = streams_of(drive(build_fleet(factory, case), arrivals,
                               args.max_new))

        rc = spawn_child(case, adir, args.seed, args.n_req, args.max_new,
                         str(device), args.arch)
        if rc != -signal.SIGKILL:
            failures.append(f"{case}: child exited {rc}, expected SIGKILL")
            cases[case] = {"child_rc": rc}
            continue

        sup, info = recover(
            factory, case, adir, arrivals, args.max_new,
            snapshot_dir=os.path.join(adir, "snaps"),
            journal_out=os.path.join(adir, "recovered_journal.jsonl"))
        got = streams_of(sup)
        mismatched = [rid for rid in ref
                      if got.get(rid) != ref[rid]]
        info.update({"child_rc": rc, "requests": len(ref),
                     "mismatched": mismatched})
        cases[case] = info
        print(f"restore,{case},mode,{info['mode']},adopted,"
              f"{info['adopted']},tail_lost,{info['tail_lost']},"
              f"mismatched,{mismatched},leaked,{info['leaked']},"
              f"journal_ok,{info['journal_matches_streams']}")
        if info["mode"] != "warm":
            failures.append(f"{case}: expected warm restore, got "
                            f"{info['mode']} ({info['reason']})")
        if mismatched:
            failures.append(f"{case}: recovered streams diverged: "
                            f"{mismatched}")
        if info["leaked"]:
            failures.append(f"{case}: {info['leaked']} leaked blocks")
        if not info["journal_matches_streams"]:
            failures.append(f"{case}: recovered journal does not replay "
                            f"to the delivered streams")

    # -- corrupted snapshot: must fall back cold, never serve poison ------
    case = "midcow"
    adir = os.path.join(args.artifacts, case)
    cdir = os.path.join(args.artifacts, "corrupted")
    corrupted: Dict = {}
    if os.path.isdir(os.path.join(adir, "snaps")):
        shutil.copytree(adir, cdir)
        corrupt_snapshot(os.path.join(cdir, "snaps", "replica0.snap"))
        arrivals = case_workload(case, cfg.vocab_size, args.seed,
                                 args.n_req)
        factory = make_factory(cfg, params, case, args.max_new,
                               device=device)
        ref = streams_of(drive(build_fleet(factory, case), arrivals,
                               args.max_new))
        sup, corrupted = recover(
            factory, case, cdir, arrivals, args.max_new,
            snapshot_dir=os.path.join(cdir, "snaps"))
        got = streams_of(sup)
        corrupted["mismatched"] = [r for r in ref if got.get(r) != ref[r]]
        print(f"restore,corrupted,mode,{corrupted['mode']},"
              f"reason,{corrupted['reason'][:60]!r},"
              f"mismatched,{corrupted['mismatched']}")
        if corrupted["mode"] != "cold":
            failures.append("corrupted snapshot was not detected: "
                            f"restore mode {corrupted['mode']}")
        if corrupted["mismatched"]:
            failures.append("cold-fallback streams diverged: "
                            f"{corrupted['mismatched']}")
    else:
        failures.append("corrupted-snapshot phase skipped: no midcow "
                        "artifacts")

    # -- warm vs cold restart: chunked-prefill TTFT + prefill savings -----
    # resume the midcow artifacts twice (with and without the snapshot
    # dir) and submit fresh requests extending the FIRST-WAVE prompts —
    # requests that completed before the kill. The journal adopts those
    # as terminal on both paths, so a cold resume never re-places them:
    # their chains survive only in the snapshot's radix tree. The
    # measurement engines prefill chunked so first-token latency counts
    # supervision ticks per stem chunk; that is legal against the
    # unchunked child's snapshot because the fingerprint covers state
    # geometry, not serving policy, and greedy streams are
    # chunk-invariant. Both readings are deterministic.
    case = "midcow"
    adir = os.path.join(args.artifacts, case)
    arrivals = case_workload(case, cfg.vocab_size, args.seed, args.n_req)
    factory = make_factory(cfg, params, case, args.max_new, device=device,
                           prefill_chunk=PREFILL_CHUNK)
    fresh = fresh_batch(arrivals[:2], cfg.vocab_size, args.seed,
                        args.fresh)
    best: Dict[str, Dict] = {}
    for kind, sdir in (("cold", None),
                       ("warm", os.path.join(adir, "snaps"))):
        _, best[kind] = recover(factory, case, adir, arrivals,
                                args.max_new, snapshot_dir=sdir,
                                extra_prompts=fresh)
    warm, cold = best["warm"], best["cold"]
    ratio, warm_ttft, cold_ttft, wc_failures = warm_vs_cold(warm, cold)
    failures += wc_failures
    print(f"restore,warm_vs_cold,prefill_tokens_warm,"
          f"{warm['prefill_tokens']},prefill_tokens_cold,"
          f"{cold['prefill_tokens']},ratio,{ratio:.2f}")
    print(f"restore,warm_vs_cold,ttft_ticks_warm,{warm['ttft_ticks']},"
          f"ttft_ticks_cold,{cold['ttft_ticks']},hit_tokens_warm,"
          f"{warm['prefix_hit_tokens']},hit_tokens_cold,"
          f"{cold['prefix_hit_tokens']}")

    if args.out:
        from repro_torch.benchmarks.provenance import provenance
        rec = {
            "bench": "restore",
            "provenance": provenance(
                mode="cuda" if device.type == "cuda" else "cpu-plain"),
            "workload": {
                "requests_per_case": args.n_req, "max_new": args.max_new,
                "fresh_requests": args.fresh, "seed": args.seed,
                "prefix_len": PREFIX_LEN, "tail_len": TAIL_LEN,
                "prefill_chunk": PREFILL_CHUNK,
                "block_size": BLOCK_SIZE, "num_blocks": NUM_BLOCKS,
                "max_batch": MAX_BATCH, "arch": args.arch, "reduced": True,
                "smoke": args.smoke},
            "backend": device.type,
            "cold_over_warm_prefill_tokens": round(ratio, 4),
            "kill_cases": cases,
            "corrupted_snapshot": corrupted,
            "warm_restart": {
                "warm_prefill_tokens": warm["prefill_tokens"],
                "cold_prefill_tokens": cold["prefill_tokens"],
                "cold_over_warm_prefill_tokens": round(ratio, 4),
                "warm_prefix_hit_tokens": warm["prefix_hit_tokens"],
                "cold_prefix_hit_tokens": cold["prefix_hit_tokens"],
                "warm_ttft_ticks": warm["ttft_ticks"],
                "cold_ttft_ticks": cold["ttft_ticks"],
                "warm_ttft_p50_ticks": warm_ttft,
                "cold_ttft_p50_ticks": cold_ttft,
                # the host-clock TTFT rides along; it is never gated
                "warm_ttft_p50_ms_wall": round(warm["ttft_p50_s"] * 1e3,
                                               3),
                "cold_ttft_p50_ms_wall": round(cold["ttft_p50_s"] * 1e3,
                                               3)},
            "gates_passed": not failures,
        }
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
            f.write("\n")
        print(f"restore,record,{args.out}")

    if failures:
        raise AssertionError("restore gates failed: " +
                             "; ".join(failures))
    print(f"restore,cold_over_warm_prefill_tokens,{ratio:.3f}")
    return ratio


if __name__ == "__main__":
    main()
