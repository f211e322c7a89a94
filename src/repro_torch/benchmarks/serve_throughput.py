"""Serving throughput: continuous batching over the paged KV pool against
static slots — the JAX package's ``benchmarks/serve_throughput.py`` on
the port.

Replays the same Poisson-arrival, mixed-length workload (prompts drawn
from [min_prompt, max_prompt]) through both engines at an EQUAL KV budget
of ``num_blocks * block_size`` cache tokens:

* static — ``ServeEngine`` slots (K5 on the card) are sized for the worst
  case (max_prompt + max_new tokens), so the budget admits only
  ``budget // slot_width`` requests at once and every prompt is padded to
  max_prompt;
* paged  — ``ContinuousEngine`` (K1 on the card) allocates each request
  ceil(len/block_size) blocks and grows block by block, so the same budget
  holds more concurrent requests and short prompts prefill at their
  padded-to-block length.

Both engines are warmed up before the measured phase; every drive ends in
a device synchronize before the clock is read. Arrivals are wall-clock
times, so the admission schedule depends on how long steps take: compare
per-request greedy streams, never schedules.

Unless ``--no-overhead-check`` is given, each round also drives the same
paged engine with telemetry fully on (request traces, step timeline,
latency histograms), back to back with the plain drive in alternating
order and the garbage collector held off across the pair: the best-of
paired on/off tok/s ratio must be >= 0.95 (the hooks cost < 5%), and the
TTFT, TPOT and e2e quantiles of the telemetry drives are printed (host
dispatch stamps). Writes no record, as the reference writes none. Prints
``serve_throughput,...`` CSV lines, the last one the paged/static tok/s
ratio.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_throughput \\
        [--fast] [--engine {static,paged,both}] [--no-overhead-check]
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import time
from collections import deque
from typing import List

import numpy as np
import torch

from repro_torch.utils.device import resolve_device, synchronize


@dataclasses.dataclass
class Arrival:
    t: float                 # seconds after workload start
    prompt: np.ndarray


def make_workload(n: int, rate: float, min_prompt: int, max_prompt: int,
                  vocab: int, seed: int) -> List[Arrival]:
    """Poisson arrivals; prompt lengths are the classic serving mixture —
    mostly short (chat turns), a long tail up to max_prompt (documents).
    The static engine must size every slot for the tail."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    ts = np.cumsum(gaps)
    ts[0] = 0.0              # clock starts at the first request
    mid = min(min_prompt + 16, max_prompt)
    lens = np.where(rng.random(n) < 0.8,
                    rng.integers(min_prompt, mid + 1, n),
                    rng.integers(mid, max_prompt + 1, n))
    return [Arrival(float(t),
                    rng.integers(1, vocab, (int(L),)).astype(np.int32))
            for t, L in zip(ts, lens)]


def make_paged_driver(cfg, params, workload, *, block_size, num_blocks,
                      max_batch, max_len, max_new, device, telemetry=None):
    """Returns drive(telemetry=None) -> (tokens, elapsed s, metrics, the
    finished requests in arrival order) on one warmed engine, and the
    engine."""
    from repro_torch.serve import ContinuousEngine, EngineMetrics
    # prefix cache OFF: the repeats replay identical prompts, and a warm
    # radix tree would let the paged engine skip prefills the static engine
    # must run — this benchmark isolates the paged-vs-static structural
    # win; prefix reuse has its own benchmark (prefix_cache_bench)
    eng = ContinuousEngine(cfg, params, block_size=block_size,
                           num_blocks=num_blocks, max_batch=max_batch,
                           max_len=max_len, prefix_cache=False,
                           telemetry=telemetry, device=device)
    eng.warmup()

    def drive(telemetry=None):
        # the overhead check swaps telemetry on and off on THIS engine, so
        # both drives share every buffer: the ratio measures the hooks
        eng.telemetry = telemetry
        pending = deque(workload)
        handles = []
        synchronize(device)
        t0 = time.perf_counter()
        while pending or eng.sched.has_work():
            now = time.perf_counter() - t0
            while pending and pending[0].t <= now:
                handles.append(eng.submit(pending.popleft().prompt,
                                          max_new))
            if eng.sched.has_work():
                eng.step()
            else:
                time.sleep(0.002)
        eng.drain()
        synchronize(device)
        elapsed = time.perf_counter() - t0
        done = eng.pop_finished()
        toks = sum(len(r.tokens) for r in done.values())
        m = eng.metrics
        eng.metrics = EngineMetrics()
        return toks, elapsed, m, [done[h.req_id] for h in handles]

    return drive, eng


def make_static_driver(cfg, params, workload, *, slots, pad_len, max_new,
                       device, window_s=0.25):
    """Static slots: fixed-size batches of worst-case-width cache rows.
    Prompts are padded to ``pad_len``; a batch launches when every slot is
    filled or no further arrivals can join within ``window_s``. drive()
    returns (tokens, elapsed s, the streams in arrival order)."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, max_len=pad_len + max_new, device=device)
    filler = np.ones((slots, pad_len), np.int32)
    eng.generate(filler, 2)                       # first launches

    def drive():
        pending = deque(workload)
        total = 0
        streams = []
        synchronize(device)
        t0 = time.perf_counter()
        while pending:
            batch: List[Arrival] = []
            while len(batch) < slots:
                now = time.perf_counter() - t0
                if pending and pending[0].t <= now:
                    batch.append(pending.popleft())
                elif batch and (not pending or
                                pending[0].t > now + window_s):
                    break                          # launch underfilled
                elif not pending:
                    break
                else:
                    time.sleep(0.002)
            tokens = filler.copy()                 # dummy rows fill the batch
            for i, a in enumerate(batch):
                row = np.ones((pad_len,), np.int32)
                row[:a.prompt.shape[0]] = a.prompt  # pad to the slot width
                tokens[i] = row
            res = eng.generate(tokens, max_new)
            streams += [res.tokens[i].tolist() for i in range(len(batch))]
            total += max_new * len(batch)
        synchronize(device)
        return total, time.perf_counter() - t0, streams

    return drive


def run_rounds(static_drive, paged_drive, repeats, tel=None):
    """Interleaved rounds, each pairing one static and one paged drive in
    the same wall-clock window; with ``tel``, one more paged drive with
    telemetry on, before or after the plain one in turns, the garbage
    collector held off across the pair (a collection landing in one window
    would read as hook overhead). Returns (static tok/s, paged tok/s,
    telemetry-on paged tok/s, per-round paged/static ratios, the last
    plain paged metrics, the plain paged rounds' finished requests)."""
    s_rounds, p_rounds, t_rounds, ratios, paged_reqs = [], [], [], [], []
    m = None
    if paged_drive and tel is not None:
        # one untimed plain drive before the overhead rounds: warmup() runs
        # one synthetic request, so the first drive meets the workload's
        # prompt shapes cold and, landing in round 0's telemetry turn,
        # would read as hook overhead. Without ``tel`` the rounds run as
        # the reference's do, the first drive cold
        t, e, _, _ = paged_drive()
        print(f"serve_throughput,telemetry_warm_drive_tok_s,{t / e:.0f}")
    for r in range(repeats):
        if static_drive:
            t, e, _ = static_drive()
            s_rounds.append(t / e)
        if paged_drive:
            # whichever drive runs second sees a slightly colder window,
            # so the order alternates
            order = [(p_rounds, None)]
            if tel is not None:
                order.insert(r % 2, (t_rounds, tel))
            gc.collect()
            gc.disable()
            try:
                for sink, t_arg in order:
                    t, e, mm, reqs = paged_drive(telemetry=t_arg)
                    sink.append(t / e)
                    if t_arg is None:
                        m = mm
                        paged_reqs.append(reqs)
            finally:
                gc.enable()
        if static_drive and paged_drive:
            ratios.append(p_rounds[-1] / s_rounds[-1])
    return s_rounds, p_rounds, t_rounds, ratios, m, paged_reqs


def report_telemetry(tel, t_rounds, p_rounds) -> float:
    """Print the telemetry drives' latency quantiles, the paired on/off
    tok/s and the median of the paired ratios; returns the best-of ratio
    (the overhead gate's reading: best-of keeps a host hiccup in one window
    from reading as overhead, and the median shows how far the rounds
    spread around it)."""
    for name in ("ttft", "tpot", "e2e"):
        q = tel.quantiles(name)
        print(f"serve_throughput,{name},"
              f"p50_ms,{q['p50'] * 1e3:.2f},"
              f"p90_ms,{q['p90'] * 1e3:.2f},"
              f"p99_ms,{q['p99'] * 1e3:.2f},n,{q['count']}")
    overhead_ratio = max(t / p for t, p in zip(t_rounds, p_rounds))
    print("serve_throughput,telemetry_rounds_tok_s," +
          ",".join(f"{t:.0f}/{p:.0f}" for t, p in zip(t_rounds, p_rounds)))
    print(f"serve_throughput,telemetry_on_over_off,{overhead_ratio:.3f}")
    print("serve_throughput,telemetry_on_over_off_median,"
          f"{np.median([t / p for t, p in zip(t_rounds, p_rounds)]):.3f}")
    return overhead_ratio


class OverheadGateMissed(RuntimeError):
    """The telemetry-on drives ran more than 5% slower than the plain ones
    in every round."""


def check_overhead(ratio: float) -> None:
    """The overhead gate: the best-of paired on/off tok/s ratio >= 0.95."""
    if ratio < 0.95:
        raise OverheadGateMissed(
            f"telemetry-enabled tok/s {ratio:.3f}x of disabled (> 5% "
            "regression)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("static", "paged", "both"),
                    default="both")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=4000.0,
                    help="Poisson arrival rate (req/s); default saturates "
                         "both engines so tok/s measures capacity")
    ap.add_argument("--repeats", type=int, default=5,
                    help="replay count per engine; medians reported")
    ap.add_argument("--min-prompt", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--no-overhead-check", action="store_true",
                    help="skip the telemetry-enabled vs -disabled paged "
                         "drive comparison")
    args = ap.parse_args(argv)
    if args.fast:
        args.repeats = 6
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))

    budget = args.num_blocks * args.block_size     # cache tokens, both engines
    slot_width = args.max_prompt + args.max_new
    slots = max(budget // slot_width, 1)
    max_len = slot_width
    workload = make_workload(args.requests, args.rate, args.min_prompt,
                             args.max_prompt, cfg.vocab_size, args.seed)
    print(f"serve_throughput,budget_tokens,{budget},slot_width,{slot_width},"
          f"static_slots,{slots}")

    static_drive = paged_drive = tel = None
    if args.engine in ("static", "both"):
        static_drive = make_static_driver(cfg, params, workload, slots=slots,
                                          pad_len=args.max_prompt,
                                          max_new=args.max_new,
                                          device=device)
    if args.engine in ("paged", "both"):
        paged_drive, _ = make_paged_driver(
            cfg, params, workload, block_size=args.block_size,
            num_blocks=args.num_blocks, max_batch=args.max_batch,
            max_len=max_len, max_new=args.max_new, device=device)
        if not args.no_overhead_check:
            from repro_torch.serve import Telemetry
            tel = Telemetry()

    # interleaved rounds: the reported tok/s are the per-engine medians
    # and the ratio is the median of the per-round ratios
    s_rounds, p_rounds, t_rounds, ratios, m, _ = run_rounds(
        static_drive, paged_drive, args.repeats, tel)
    tok_s_static = float(np.median(s_rounds)) if s_rounds else 0.0
    tok_s_paged = float(np.median(p_rounds)) if p_rounds else 0.0
    if static_drive:
        print(f"serve_throughput,static,tok_s,{tok_s_static:.2f},"
              f"concurrency,{slots}")
    if paged_drive:
        print(f"serve_throughput,paged,tok_s,{tok_s_paged:.2f},"
              f"peak_blocks,{m.peak_blocks},decode_steps,{m.decode_steps},"
              f"preemptions,{m.preemptions}")
    if tel is not None:
        check_overhead(report_telemetry(tel, t_rounds, p_rounds))
    if args.engine == "both":
        ratio = float(np.median(ratios))
        print(f"serve_throughput,ratio_paged_over_static,{ratio:.2f}")
        return ratio
    return 0.0


if __name__ == "__main__":
    main()
