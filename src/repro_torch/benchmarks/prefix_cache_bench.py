"""Radix prefix cache on a shared-system-prompt workload, cache on against
cache off — the JAX package's ``benchmarks/prefix_cache_bench.py`` on the
port.

Every request carries the same system prompt + few-shot exemplars
(``--shared-len`` tokens) and a short unique user turn (``--unique-len``),
served by ``ContinuousEngine`` twice at an EQUAL pool budget:

* **off** — every prompt prefills end to end;
* **on**  — the radix tree shares the prefix blocks: after the first
  admissions publish the prefix, each later request splices it by
  reference and prefills only its unique suffix.

Rounds are interleaved and repeated; the cache-on engine keeps its tree
across rounds, so steady state is what the medians measure. Each round's
clock is read after a device synchronize. Gated:

* prefill-token savings  = computed-prefill-tokens(off) / (on)  >= 1.8x
* end-to-end throughput  = tok/s(on) / tok/s(off)  >= 1.3x (full mode)
* greedy outputs identical per request, cache on vs off, every round.

Writes no record, as the reference writes none. Prints
``prefix_cache_bench,...`` CSV lines, the last one the tok/s ratio.

    PYTHONPATH=src python -m repro_torch.benchmarks.prefix_cache_bench
    PYTHONPATH=src python -m repro_torch.benchmarks.prefix_cache_bench \\
        --device cpu --smoke
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.utils.device import resolve_device, synchronize


def make_prompts(n: int, shared_len: int, unique_len: int, vocab: int,
                 seed: int) -> List[np.ndarray]:
    """System prompt + few-shot block shared verbatim; user turn unique."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, (shared_len,))
    return [np.concatenate([system, rng.integers(1, vocab, (unique_len,))]
                           ).astype(np.int32) for _ in range(n)]


def make_driver(cfg, params, prompts, *, prefix_cache, block_size,
                num_blocks, max_batch, max_len, max_new, device):
    """Build one warmed engine; drive() replays the workload once and
    returns (per-request token lists, delivered tokens, elapsed seconds,
    prefill tokens computed this round)."""
    from repro_torch.serve import ContinuousEngine
    eng = ContinuousEngine(cfg, params, block_size=block_size,
                           num_blocks=num_blocks, max_batch=max_batch,
                           max_len=max_len, prefix_cache=prefix_cache,
                           device=device)
    eng.warmup()

    def drive():
        computed0 = eng.metrics.prefill_tokens
        synchronize(device)
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new) for p in prompts]
        results = eng.run()
        synchronize(device)
        elapsed = time.perf_counter() - t0
        toks: Dict[int, List[int]] = {
            i: results[h.req_id].tokens for i, h in enumerate(handles)}
        delivered = sum(len(t) for t in toks.values())
        return toks, delivered, elapsed, \
            eng.metrics.prefill_tokens - computed0

    return eng, drive


def run_rounds(drive_on, drive_off, repeats):
    """Interleaved rounds (off, then on), streams held equal in every
    round. Returns (on tok/s, off tok/s, on computed, off computed) per
    round."""
    on_tok_s, off_tok_s, on_computed, off_computed = [], [], [], []
    for rnd in range(repeats):
        toks_off, d_off, e_off, c_off = drive_off()
        toks_on, d_on, e_on, c_on = drive_on()
        assert toks_on == toks_off, (
            f"round {rnd}: cached greedy decode diverged from cold")
        off_tok_s.append(d_off / e_off)
        on_tok_s.append(d_on / e_on)
        off_computed.append(c_off)
        on_computed.append(c_on)
    return on_tok_s, off_tok_s, on_computed, off_computed


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--shared-len", type=int, default=480,
                    help="system-prompt + few-shot tokens shared by every "
                         "request (long enough that prefill is "
                         "compute-bound, the regime the cache targets)")
    ap.add_argument("--unique-len", type=int, default=16,
                    help="unique user-turn tokens per request")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--num-blocks", type=int, default=160)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5,
                    help="interleaved rounds; medians reported")
    ap.add_argument("--evict-policy", choices=("lru", "fifo"), default="lru")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast mode (asserts savings + equality; "
                         "throughput reported, not gated)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = 8
        args.shared_len = 224
        args.unique_len = 16
        args.max_new = 4
        args.num_blocks = 80
        args.repeats = 2
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))

    plen = args.shared_len + args.unique_len
    max_len = plen + args.max_new
    prompts = make_prompts(args.requests, args.shared_len, args.unique_len,
                           cfg.vocab_size, args.seed)
    print(f"prefix_cache_bench,workload,requests,{args.requests},"
          f"shared,{args.shared_len},unique,{args.unique_len},"
          f"max_new,{args.max_new},budget_blocks,{args.num_blocks}")

    common = dict(block_size=args.block_size, num_blocks=args.num_blocks,
                  max_batch=args.max_batch, max_len=max_len,
                  max_new=args.max_new, device=device)
    eng_on, drive_on = make_driver(cfg, params, prompts, prefix_cache=True,
                                   **common)
    _, drive_off = make_driver(cfg, params, prompts, prefix_cache=False,
                               **common)

    on_tok_s, off_tok_s, on_computed, off_computed = run_rounds(
        drive_on, drive_off, args.repeats)

    # steady state: every round after the first finds the prefix resident;
    # medians absorb the cold round and host noise
    savings = float(np.median(off_computed) / np.median(on_computed))
    ratio = float(np.median(on_tok_s) / np.median(off_tok_s))
    cs = eng_on.prefix_cache.stats
    m = eng_on.metrics
    print(f"prefix_cache_bench,off,tok_s,{np.median(off_tok_s):.2f},"
          f"prefill_tokens_per_round,{np.median(off_computed):.0f}")
    print(f"prefix_cache_bench,on,tok_s,{np.median(on_tok_s):.2f},"
          f"prefill_tokens_per_round,{np.median(on_computed):.0f},"
          f"hit_tokens,{cs.hit_tokens},evictions,{cs.evictions},"
          f"cow_copies,{m.cow_copies},shared_blocks_peak,"
          f"{m.shared_blocks_peak}")
    print(f"prefix_cache_bench,prefill_savings,{savings:.2f}")
    print(f"prefix_cache_bench,ratio_cached_over_cold,{ratio:.2f}")

    assert savings >= 1.8, (
        f"prefill-token savings {savings:.2f}x < 1.8x")
    if not args.smoke:
        assert ratio >= 1.3, f"tok/s ratio {ratio:.2f}x < 1.3x"
    return ratio


if __name__ == "__main__":
    main()
