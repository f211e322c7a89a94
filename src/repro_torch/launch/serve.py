"""Serving launcher: the static-slot engine over a contiguous cache
(``--engine static``, the default) or the continuous-batching engine over
the paged KV pool (``--engine paged``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --batch 8 --prompt-len 1024 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --engine paged --batch 8 --prompt-len 512 --max-new 32 \
        --block-size 16 --num-blocks 2048 --prefill-chunk 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --engine paged --batch 8 --prompt-len 1024 --max-new 32 \
        --block-size 16 --num-blocks 2048 --kv-tile-blocks 4 \
        --decode-split-k 2 --autotune per-step

Observability (paged engine): ``--metrics-out metrics.prom`` (or
``.jsonl``) writes the metric registry, ``--trace-out trace.json`` the
Perfetto-loadable step timeline, ``--numerics-every N`` turns on the int8
numerics monitor; any of these implies ``--telemetry``, which without
``--metrics-out`` prints the registry's Prometheus text to stdout.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --engine paged --batch 8 --prompt-len 512 --max-new 32 \
        --num-blocks 2048 --kv-dtype int8 --metrics-out metrics.prom \
        --trace-out trace.json --numerics-every 1

Resilience (paged engine): ``--fault-plan PATH|canned`` attaches the fault
injector (``serve/faults.py``; ``--fault-log`` writes its replay
artifact), ``--guard`` the degradation ladder with the readback-audit
quarantine (``serve/guard.py``, the reference's reduced-model thresholds),
``--deadline-ms``/``--ttft-budget-ms`` cancel overdue requests; a
``resilience:`` line sums up what happened.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --reduced --device cpu --batch 2 --prompt-len 20 --max-new 6 \
        --block-size 8 --num-blocks 24 --fault-plan canned --guard \
        --deadline-ms 60000

Fleet and durability (paged engine): ``--replicas N`` serves through a
``FleetSupervisor`` over N replicas sharing one copy of the weights
(``--router affinity|round-robin``, step-watchdog supervision, journaled
failover; ``--fleet-fault-plan PATH|canned`` the replica crash and hang
plan); ``--journal-out`` writes the write-ahead journal (``--journal-fsync``
its policy); ``--snapshot-dir``/``--snapshot-every`` write crash-consistent
per-replica snapshots; ``--resume JOURNAL`` rebuilds a fleet from a dead
process's journal and snapshots. ``fleet[...]`` and ``resume:`` lines sum
up what happened.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine paged \
        --reduced --device cpu --batch 4 --prompt-len 20 --max-new 12 \
        --block-size 8 --num-blocks 24 --replicas 2 --fleet-fault-plan \
        canned --journal-out wal.jsonl --snapshot-dir snaps

Every decoder-only family serves on the static engine (the MLA, rwkv and
hybrid families only there: ``--engine paged`` refuses them, as the
reference does); ``--optimized`` also turns on ``opt_mla_absorbed``.
``--arch whisper-base`` is refused with a ValueError: the encoder-decoder
family's prefill reads audio frames, not prompts
(``registry.check_decoder_only``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --reduced --device cpu --batch 2 --prompt-len 20 --max-new 6

Runs on the CUDA card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels instead (with ``--reduced`` for a CPU-sized model).
Weights are random, drawn from ``--seed``; prompts too. The paged-engine
options are ignored by the static engine. The run is under
``sharding_context(mesh, SERVE_RULES)`` on ``make_host_mesh()`` or, with
``--production-mesh``, ``make_production_mesh`` (a ValueError names the
256 ranks it needs where the process group has fewer), as the
reference's. The parameters stay plain tensors, as the reference's serve
launcher places none, so every ``shard_act`` of the serving path returns
its input.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_shape)
from repro_torch.models.lm import cast_matrix_params
from repro_torch.models.registry import (GRID_ARCHS, check_decoder_only,
                                         get_config, init_lm_params,
                                         reduce_config)
from repro_torch.serve import (ContinuousEngine, EngineGuard,
                               EngineSheddingError, FaultInjector, FaultPlan,
                               FleetSupervisor, Journal, Router, ServeEngine,
                               Telemetry, canned_fleet_plan, canned_plan,
                               check_invariants)
from repro_torch.parallel.sharding import SERVE_RULES, sharding_context
from repro_torch.serve.paged_step import check_paged_support
from repro_torch.utils.device import resolve_device

log = logging.getLogger("repro_torch.launch.serve")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(GRID_ARCHS), default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="turn every opt_* flag of the config on (bf16 "
                         "params; an int8 KV pool by default)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--engine", choices=("static", "paged"),
                    default="static")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged engine: tokens per physical KV block")
    ap.add_argument("--num-blocks", type=int, default=128,
                    help="paged engine: physical blocks in the pool")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix-tree prompt-prefix reuse on the block pool")
    ap.add_argument("--evict-policy", choices=("lru", "fifo"), default="lru",
                    help="prefix cache: order in which unreferenced cached "
                         "blocks are reclaimed")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill long prompts this many tokens per step "
                         "through the flash-prefill kernel (rounded up to a "
                         "block multiple; 0 = one-shot prefill)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="cap on the total prefill chunk tokens dealt per "
                         "step across requests (0 = one chunk per "
                         "prefilling request per step)")
    ap.add_argument("--kv-dtype", choices=("auto", "bf16", "int8"),
                    default="auto",
                    help="KV pool storage: 'auto' = the compute dtype; "
                         "'int8' stores rows as int8 with per-row scales")
    ap.add_argument("--kv-tile-blocks", type=int, default=1,
                    help="pool blocks per KV tile of the paged kernels "
                         "(layout only: the same attention)")
    ap.add_argument("--decode-split-k", type=int, default=1,
                    help="split each decode lane's KV walk across this many "
                         "parallel lanes, merged by the exact Softermax "
                         "combine (layout only)")
    ap.add_argument("--autotune", choices=("off", "static", "per-step"),
                    default="off",
                    help="paged engine: grid autotuning from the analytic "
                         "kernel cost model (serve/kernel_costs.py). "
                         "'static' picks one (kv_tile_blocks, split_k) at "
                         "startup by modeled cost on the worst-case batch; "
                         "'per-step' re-plans every decode step from the "
                         "batch's lengths vector over the candidate grids. "
                         "--kv-tile-blocks/--decode-split-k bound the "
                         "candidate set")
    ap.add_argument("--telemetry", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="paged engine: per-request tracing + metric "
                         "registry + step timeline (serve/telemetry.py). "
                         "Defaults on when --metrics-out/--trace-out/"
                         "--numerics-every is given, off otherwise")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the final metric-registry state here: "
                         "*.jsonl appends one snapshot line (JSONL sink), "
                         "anything else gets Prometheus text exposition")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the step timeline as Chrome trace-event "
                         "JSON (load in chrome://tracing or Perfetto)")
    ap.add_argument("--numerics-every", type=int, default=0, metavar="N",
                    help="telemetry: audit every Nth prefill on an int8 "
                         "pool — lockstep full-precision vs int8 forward "
                         "publishing the live logit-error gauge plus "
                         "IntMax-overflow / scale-saturation counters "
                         "(0 = off)")
    ap.add_argument("--fault-plan", default=None, metavar="PATH|canned",
                    help="paged engine: attach the fault injector "
                         "(serve/faults.py) with this plan — a FaultPlan "
                         "JSON file, or the literal 'canned' for the "
                         "reference chaos plan. Attached before traffic "
                         "(no warmup runs here), so the plan's step "
                         "indices address serving steps")
    ap.add_argument("--fault-log", default=None, metavar="PATH",
                    help="write the fault-injection replay artifact "
                         "(plan + every injection that fired) here")
    ap.add_argument("--guard", action="store_true",
                    help="paged engine: enable the graceful-degradation "
                         "ladder (serve/guard.py) — sheds admissions, "
                         "shrinks prefill budgets, and quarantines "
                         "corrupted-KV requests as pool/numerics/queue "
                         "pressure crosses thresholds; recovers "
                         "automatically. Its thresholds are the "
                         "reference's reduced-model defaults")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="paged engine: per-request end-to-end deadline; "
                         "overdue requests are cancelled (reason "
                         "'deadline'). 0 = no deadline")
    ap.add_argument("--ttft-budget-ms", type=float, default=0.0,
                    help="paged engine: per-request time-to-first-token "
                         "budget; requests that miss it are cancelled "
                         "(reason 'deadline'). 0 = no budget")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 production mesh (256 ranks)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="paged engine: serve through a FleetSupervisor "
                         "over this many engine replicas (serve/"
                         "supervisor.py) — prefix-affinity routing, "
                         "step-watchdog supervision, journaled failover. "
                         "1 = the plain single-engine path")
    ap.add_argument("--router", choices=("affinity", "round-robin"),
                    default="affinity",
                    help="fleet placement policy: radix-cache prefix "
                         "affinity (load/budget fallback) or round-robin")
    ap.add_argument("--journal-out", default=None, metavar="PATH",
                    help="fleet: write the write-ahead request journal "
                         "(JSONL; serve/journal.py) — submit/placement/"
                         "token/terminal records, replayable post-mortem")
    ap.add_argument("--fleet-fault-plan", default=None,
                    metavar="PATH|canned",
                    help="fleet: attach the fleet fault injector — a "
                         "FaultPlan JSON file, or the literal 'canned' "
                         "for the reference replica-crash + hang plan "
                         "(serve/faults.py canned_fleet_plan)")
    ap.add_argument("--journal-fsync", choices=("none", "interval",
                                                "always"),
                    default="interval",
                    help="journal durability policy: 'always' fsyncs "
                         "every record (no tail loss, slowest), "
                         "'interval' flushes per record and fsyncs "
                         "periodically (default; bounded tail-loss "
                         "window), 'none' leaves records in stdio "
                         "buffers (fastest; a crash loses everything "
                         "unflushed). Dropped-tail records surface as "
                         "journal_tail_lost_total at recovery")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="fleet durability: write crash-consistent "
                         "per-replica snapshots (serve/snapshot.py — "
                         "KV pools, radix tree, scheduler queues, engine "
                         "counters; atomic tmp+rename, per-section "
                         "checksums) into this directory, plus one at "
                         "clean drain. Implies the fleet path even with "
                         "--replicas 1")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="N",
                    help="fleet durability: snapshot every N supervision "
                         "ticks (0 = only the final snapshot at drain); "
                         "each snapshot also anchors the journal so "
                         "replay cost is bounded by the suffix")
    ap.add_argument("--resume", default=None, metavar="JOURNAL",
                    help="crash recovery: rebuild the fleet from this "
                         "prior write-ahead journal (+ --snapshot-dir "
                         "snapshots when available — warm radix/pool "
                         "restore with fsck fallback to cold), adopt "
                         "every journaled request (terminal streams "
                         "resolve from the journal; in-flight ones "
                         "resubmit via the [prompt ‖ emitted] recompute "
                         "contract), then serve the new workload")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    args = parse_args(argv)
    own_group = not dist.is_initialized()
    mesh = make_production_mesh(device=args.device) if args.production_mesh \
        else make_host_mesh(device=args.device)
    device = resolve_device(args.device)
    log.info("mesh: %s", mesh_shape(mesh))
    try:
        with sharding_context(mesh, SERVE_RULES):
            _serve(args, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _serve(args, device) -> None:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.optimized:
        cfg = cfg.with_opts(True)
    check_decoder_only(cfg, "launch.serve")   # before the weights are drawn
    if args.engine == "paged":
        check_paged_support(cfg)        # before the weights are drawn
    params = init_lm_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    if args.engine == "static":
        eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.max_new,
                          device=device)
        del params
        t0 = time.time()
        res = eng.generate(prompts, args.max_new,
                           temperature=args.temperature, seed=args.seed)
        _report(cfg, device, [r.tolist() for r in res.tokens],
                time.time() - t0, "static")
        return
    if args.replicas > 1 or args.snapshot_dir or args.resume:
        t0 = time.time()
        rows, dt = _serve_fleet(args, cfg, params, prompts, device, t0)
        _report(cfg, device, rows, dt, "paged")
        return
    want_tel = args.telemetry if args.telemetry is not None else \
        bool(args.metrics_out or args.trace_out or args.numerics_every)
    tel = Telemetry(numerics_every=args.numerics_every) if want_tel else None
    eng = ContinuousEngine(
        cfg, params, block_size=args.block_size, num_blocks=args.num_blocks,
        max_batch=args.batch, max_len=args.prompt_len + args.max_new,
        seed=args.seed, prefix_cache=args.prefix_cache,
        evict_policy=args.evict_policy, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget,
        kv_dtype=None if args.kv_dtype == "auto" else args.kv_dtype,
        kv_tile_blocks=args.kv_tile_blocks,
        decode_split_k=args.decode_split_k, autotune=args.autotune,
        telemetry=tel, guard=EngineGuard() if args.guard else None,
        deadline_s=args.deadline_ms / 1e3 or None,
        ttft_budget_s=args.ttft_budget_ms / 1e3 or None, device=device)
    del params
    inj = None
    if args.fault_plan:
        plan = (canned_plan() if args.fault_plan == "canned"
                else FaultPlan.load(args.fault_plan))
        inj = FaultInjector(plan)
        eng.attach_faults(inj)
        log.info("fault injector attached: %d specs, seed %d",
                 len(plan.specs), plan.seed)
    t0 = time.time()
    handles = []
    for p in prompts:
        try:
            handles.append(eng.submit(p, args.max_new,
                                      temperature=args.temperature))
        except EngineSheddingError as e:
            # the guard refused the front door; its hint is the minimum
            # clean steps before a retry can succeed
            log.warning("submit shed by guard (%s): retry after >= %d "
                        "clean engine steps", e, e.retry_after_steps)
    results = eng.run()
    dt = time.time() - t0
    check_invariants(eng.pool, eng.prefix_cache)
    rows = [results[h.req_id].tokens for h in handles
            if h.req_id in results]
    m = eng.metrics
    if inj is not None or args.guard or args.deadline_ms or \
            args.ttft_budget_ms:
        log.info("resilience: %d faults injected, %d retries, %d cancelled "
                 "(%d deadline, %d quarantined), %d shed, guard=%s",
                 m.faults_injected, m.transient_retries, m.cancelled,
                 m.deadline_misses, m.quarantined, m.shed,
                 eng.guard.state if eng.guard else "off")
    if inj is not None and args.fault_log:
        inj.save_log(args.fault_log)
        log.info("fault replay artifact -> %s", args.fault_log)
    log.info("kv pool[%s]: %d-token capacity in %.2f MiB (%d blocks x %d)",
             eng.pool.kv_dtype, eng.pool.token_capacity,
             eng.pool.hbm_bytes / 2 ** 20, args.num_blocks, args.block_size)
    log.info("pool peak=%d blocks (%.0f%% of %d), preemptions=%d",
             m.peak_blocks, 100.0 * m.peak_blocks / args.num_blocks,
             args.num_blocks, m.preemptions)
    if args.prefill_chunk:
        log.info("chunked prefill[%d]: %d chunks over %d prefills "
                 "(%d prompt tokens computed)", eng.prefill_chunk,
                 m.prefill_chunks, m.prefills, m.prefill_tokens)
    if eng.prefix_cache is not None:
        cs = eng.prefix_cache.stats
        log.info("prefix cache[%s]: hit %d/%d prompt tokens (%.0f%%), "
                 "%d shared-block peak, %d COW, %d evictions, prefill "
                 "savings %.2fx", args.evict_policy, cs.hit_tokens,
                 cs.lookup_tokens, 100.0 * cs.hit_rate,
                 m.shared_blocks_peak, m.cow_copies, cs.evictions,
                 m.prefill_savings)
    if eng.planner is not None:
        log.info("autotune[%s]: grid=(tile=%d, split=%d), decisions %s",
                 args.autotune, eng.kv_tile_blocks, eng.decode_split_k,
                 eng.planner.summary() or "(static)")
    if tel is not None:
        _report_telemetry(args, cfg, tel)
    _report(cfg, device, rows, dt, "paged")


def _serve_fleet(args, cfg, params, prompts, device, t0):
    """Serve the workload through a FleetSupervisor over N replicas:
    prefix-affinity (or round-robin) placement, step-watchdog supervision,
    journaled failover, fleet-aggregated metrics. The replicas share one
    copy of the weights, cast once to the compute dtype on the device.

    On the CUDA card the replicas step on one thread: they all launch on
    the one current stream, so threads overlap no device work, and on an
    H100 a threaded drive took 1.6-2.0x as long as the same drive on one
    thread (``chip_smoke.py`` phase 29 (b)). On the CPU they step in
    threads, as the reference's launcher does."""
    want_tel = bool(args.telemetry or args.metrics_out)
    step_parallel = device.type != "cuda"
    params = cast_matrix_params(params, cfg.compute_dtype_)

    def engine_factory():
        eng = ContinuousEngine(
            cfg, params, block_size=args.block_size,
            num_blocks=args.num_blocks, max_batch=args.batch,
            max_len=args.prompt_len + args.max_new, seed=args.seed,
            prefix_cache=args.prefix_cache,
            evict_policy=args.evict_policy,
            prefill_chunk=args.prefill_chunk,
            prefill_budget=args.prefill_budget,
            kv_dtype=None if args.kv_dtype == "auto" else args.kv_dtype,
            kv_tile_blocks=args.kv_tile_blocks,
            decode_split_k=args.decode_split_k,
            telemetry=Telemetry() if want_tel else None,
            guard=EngineGuard() if args.guard else None, device=device)
        eng.warmup()
        return eng

    faults = None
    if args.fleet_fault_plan:
        plan = (canned_fleet_plan() if args.fleet_fault_plan == "canned"
                else FaultPlan.load(args.fleet_fault_plan))
        faults = FaultInjector(plan)
        log.info("fleet fault injector attached: %d specs, seed %d",
                 len(plan.specs), plan.seed)
    journal = Journal(path=args.journal_out, fsync=args.journal_fsync)
    if args.resume:
        # crash recovery: snapshot warm-restore per replica, then adopt
        # every journaled request (terminal ones resolve immediately;
        # in-flight ones resubmit via the recompute contract)
        sup = FleetSupervisor.resume(
            engine_factory, args.replicas, args.resume,
            snapshot_dir=args.snapshot_dir, journal=journal,
            router=Router(args.router), faults=faults,
            step_parallel=step_parallel, snapshot_every=args.snapshot_every)
        for info in sup.restore_info:
            log.info("replica %d restore: %s (%s)", info["replica"],
                     info["mode"], info["reason"])
        log.info("resume: %d requests adopted (%d already terminal), "
                 "%d torn-tail records lost",
                 int(sup.tracker.c_recovered.value),
                 sum(1 for t in sup.tracker.requests.values()
                     if t.result is not None),
                 int(sup.tracker.c_tail_lost.value))
    else:
        engines = [engine_factory() for _ in range(args.replicas)]
        sup = FleetSupervisor(engines, router=Router(args.router),
                              journal=journal, faults=faults,
                              step_parallel=step_parallel,
                              snapshot_dir=args.snapshot_dir,
                              snapshot_every=args.snapshot_every)
    treqs = [sup.submit(p, args.max_new, temperature=args.temperature,
                        deadline_s=args.deadline_ms / 1e3 or None,
                        ttft_budget_s=args.ttft_budget_ms / 1e3 or None)
             for p in prompts]
    sup.run_until_drained()
    dt = time.time() - t0
    tr = sup.tracker
    log.info("fleet[%dx %s, %s router]: %d completed, %d failed, "
             "%d failovers, %d placement retries in %d ticks",
             args.replicas, cfg.name, args.router,
             int(tr.c_completed.value), int(tr.c_failed.value),
             int(tr.c_failovers.value), int(tr.c_retries.value), sup.ticks)
    log.info("fleet health: crashed=%d hung=%d alive=%d",
             int(sup.c_crashed.value), int(sup.c_hung.value),
             int(sup.g_alive.value))
    for name, h in (("ttft", tr.h_ttft), ("e2e", tr.h_e2e)):
        if h.count:
            log.info("fleet %s: p50 %.1fms p99 %.1fms (n=%d)", name,
                     h.quantile(0.5) * 1e3, h.quantile(0.99) * 1e3,
                     h.count)
    events = journal.replay().replica_events
    if events:
        log.info("fleet replica events: %s",
                 [(e["event"], e["replica"], e["tick"]) for e in events])
    if args.metrics_out:
        agg = sup.collect_metrics()
        with open(args.metrics_out, "w") as f:
            f.write(agg.prometheus_text())
        log.info("fleet-aggregated metrics -> %s", args.metrics_out)
    if args.snapshot_dir:
        # final snapshot at quiescence: the next process warm-restarts
        # with the full radix tree even after a clean shutdown
        sup.save_snapshots()
        log.info("durable snapshots (%d written this run) -> %s",
                 int(sup.c_snapshots.value), args.snapshot_dir)
    if args.journal_out:
        log.info("write-ahead journal (%d records, fsync=%s) -> %s",
                 len(journal.records), args.journal_fsync,
                 args.journal_out)
    sup.close()
    rows = [list(t.result.tokens) for t in treqs]
    return rows, dt


def _report_telemetry(args, cfg, tel: Telemetry) -> None:
    """The telemetry's end-of-run lines (host dispatch stamps) and sinks."""
    for nm in ("ttft", "tpot", "e2e"):
        q = tel.quantiles(nm)
        log.info("%s: p50 %.1fms p90 %.1fms p99 %.1fms (n=%d)", nm,
                 q["p50"] * 1e3, q["p90"] * 1e3, q["p99"] * 1e3,
                 q["count"])
    err = tel.registry.get("numerics_logit_error_max")
    if err is not None:
        log.info("numerics: max |full - int8| logit delta %.4f over %d "
                 "probes", err.value, tel.c_probes.value)
    kd = tel.registry.get("kernel_dma_bytes_total")
    if kd is not None and kd.value > 0:
        kw = tel.registry.get("kernel_waste_bytes_total")
        kf = tel.registry.get("kernel_flops_total")
        log.info("kernel cost: %.2f MiB gather DMA (%.0f%% clamped waste), "
                 "%.2f MFLOP", kd.value / 2 ** 20,
                 100.0 * kw.value / kd.value, kf.value / 1e6)
    if args.metrics_out:
        tel.save_metrics(args.metrics_out,
                         extra={"arch": cfg.name, "engine": "paged"})
        log.info("metrics -> %s", args.metrics_out)
    else:
        # no sink requested: the final Prometheus exposition to stdout
        print("# final metric registry (Prometheus text exposition; pass "
              "--metrics-out to write a file)")
        print(tel.registry.prometheus_text(), end="")
    if args.trace_out:
        tel.save_chrome_trace(args.trace_out, meta={"arch": cfg.name})
        log.info("step timeline -> %s", args.trace_out)


def _report(cfg, device, rows, dt, engine) -> None:
    toks = sum(len(r) for r in rows)
    log.info("%s[%s] on %s: %d tokens in %.2fs (%.1f tok/s, first call "
             "included)", cfg.name, engine, device, toks, dt, toks / dt)
    for i, row in enumerate(rows[:2]):
        log.info("seq%d: %s", i, row)


if __name__ == "__main__":
    main()
