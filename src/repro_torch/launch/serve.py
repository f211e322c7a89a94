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

Runs on the CUDA card by default; ``--device cpu`` runs the plain PyTorch
versions of the kernels instead (with ``--reduced`` for a CPU-sized model).
Weights are random, drawn from ``--seed``; prompts too. The paged-engine
options are ignored by the static engine.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.models.registry import (GRID_ARCHS, get_config,
                                         init_lm_params, reduce_config)
from repro_torch.serve import (ContinuousEngine, ServeEngine,
                               check_invariants)
from repro_torch.utils.device import resolve_device

log = logging.getLogger("repro_torch.launch.serve")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(GRID_ARCHS), default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true")
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
    return ap.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
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
    eng = ContinuousEngine(
        cfg, params, block_size=args.block_size, num_blocks=args.num_blocks,
        max_batch=args.batch, max_len=args.prompt_len + args.max_new,
        seed=args.seed, prefix_cache=args.prefix_cache,
        evict_policy=args.evict_policy, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget,
        kv_dtype=None if args.kv_dtype == "auto" else args.kv_dtype,
        kv_tile_blocks=args.kv_tile_blocks,
        decode_split_k=args.decode_split_k, autotune=args.autotune,
        device=device)
    del params
    t0 = time.time()
    handles = [eng.submit(p, args.max_new, temperature=args.temperature)
               for p in prompts]
    results = eng.run()
    dt = time.time() - t0
    check_invariants(eng.pool, eng.prefix_cache)
    rows = [results[h.req_id].tokens for h in handles]
    m = eng.metrics
    log.info("kv pool[%s]: %d-token capacity in %.2f MiB (%d blocks x %d)",
             eng.pool.kv_dtype, eng.pool.token_capacity,
             eng.pool.hbm_bytes / 2 ** 20, args.num_blocks, args.block_size)
    log.info("pool peak=%d blocks, preemptions=%d, decode steps=%d, "
             "prefill chunks=%d", m.peak_blocks, m.preemptions,
             m.decode_steps, m.prefill_chunks)
    if eng.prefix_cache is not None:
        cs = eng.prefix_cache.stats
        log.info("prefix cache[%s]: hit %d/%d prompt tokens, %d COW",
                 args.evict_policy, cs.hit_tokens, cs.lookup_tokens,
                 m.cow_copies)
    if eng.planner is not None:
        log.info("autotune[%s]: grid=(tile=%d, split=%d), decisions %s",
                 args.autotune, eng.kv_tile_blocks, eng.decode_split_k,
                 eng.planner.summary() or "(static)")
    _report(cfg, device, rows, dt, "paged")


def _report(cfg, device, rows, dt, engine) -> None:
    toks = sum(len(r) for r in rows)
    log.info("%s[%s] on %s: %d tokens in %.2fs (%.1f tok/s, first call "
             "included)", cfg.name, engine, device, toks, dt, toks / dt)
    for i, row in enumerate(rows[:2]):
        log.info("seq%d: %s", i, row)


if __name__ == "__main__":
    main()
