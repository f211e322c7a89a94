"""Serving example: continuous batching with softermax decode attention —
the JAX package's ``examples/serve_lm.py`` on the port.

Submits a mixed-length batch of prompts to the paged ``ContinuousEngine``
and streams tokens as they decode. Runs the reduced (CPU smoke) config by
default; pass --full for the real model dimensions.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Runs on the CUDA card by default (``--device cpu`` for the CPU). Weights
are random, drawn from ``torch.Generator(device).manual_seed(0)``; the
prompts from ``numpy.random.default_rng(0)``, as in the reference.
``--kv-tile-blocks`` and ``--decode-split-k`` are the reference's TPU grid
knobs; the port's engine takes them with the same meaning.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.serve import ContinuousEngine, Telemetry
from repro_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    """Serves and prints the streams and the latency table; returns
    {"prompts": the submitted prompts, "tokens": {req_id: its tokens}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="run the full-size config (default: reduced)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix-tree prompt-prefix reuse")
    ap.add_argument("--kv-tile-blocks", type=int, default=1,
                    help="pool blocks per kernel kv grid step (TPU knob; "
                         "layout-only, identical outputs)")
    ap.add_argument("--decode-split-k", type=int, default=1,
                    help="parallel KV partitions per decode lane (TPU "
                         "knob; same attention up to fp summation order "
                         "of the split partials)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt shared by every request "
                         "(exercises the prefix cache)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduce_config(cfg)
    fns = model_fns(cfg)
    params = fns.init(torch.Generator(device=device).manual_seed(0))
    tel = Telemetry()
    eng = ContinuousEngine(
        cfg, params, block_size=args.block_size,
        num_blocks=args.num_blocks, max_batch=args.requests,
        max_len=args.shared_prefix + args.prompt_len + args.max_new,
        prefix_cache=not args.no_prefix_cache,
        kv_tile_blocks=args.kv_tile_blocks,
        decode_split_k=args.decode_split_k,
        telemetry=tel, device=device)

    rng = np.random.default_rng(0)
    # mixed lengths: the whole point of per-request paged admission
    lens = rng.integers(args.prompt_len // 2, args.prompt_len + 1,
                        args.requests)
    system = rng.integers(1, cfg.vocab_size, (args.shared_prefix,))
    prompts = [np.concatenate([system,
                               rng.integers(1, cfg.vocab_size, (n,))]
                              ).astype(np.int32) for n in lens]
    handles = [eng.submit(p, args.max_new, temperature=args.temperature)
               for p in prompts]

    t0 = time.time()
    results = eng.run(on_token=lambda rid, toks:
                      print(f"  req{rid} += {toks}"))
    dt = time.time() - t0

    print(f"arch={cfg.name} requests={args.requests} "
          f"prompt_lens={lens.tolist()} device={device}")
    m = eng.metrics
    print(f"generated {m.tokens_out} tokens in {dt:.2f}s "
          f"({m.tokens_out / dt:.1f} tok/s incl. prefill); "
          f"peak pool use {m.peak_blocks}/{args.num_blocks} blocks, "
          f"{m.preemptions} preemptions")
    if eng.prefix_cache is not None:
        cs = eng.prefix_cache.stats
        print(f"prefix cache: {cs.hit_tokens}/{cs.lookup_tokens} prompt "
              f"tokens reused ({100 * cs.hit_rate:.0f}%), prefill savings "
              f"{m.prefill_savings:.2f}x, shared-block peak "
              f"{m.shared_blocks_peak}, {m.cow_copies} COW copies, "
              f"{cs.evictions} evictions, "
              f"{eng.prefix_cache.cached_blocks} blocks cached at exit")
    # per-request latency table from the telemetry traces (same data the
    # registry aggregates into the p50/p90/p99 histograms)
    print(f"{'req':>4} {'prompt':>6} {'hit':>4} {'ttft_ms':>8} "
          f"{'tpot_ms':>8} {'e2e_ms':>8} {'toks':>5} {'preempt':>7}")
    for tr in sorted(tel.finished_traces, key=lambda t: t.req_id):
        print(f"{tr.req_id:>4} {tr.prompt_len:>6} {tr.n_prefix_hit:>4} "
              f"{tr.ttft * 1e3:>8.1f} {tr.tpot_mean * 1e3:>8.2f} "
              f"{tr.e2e * 1e3:>8.1f} {tr.n_tokens:>5} "
              f"{tr.n_preemptions:>7}")
    snap = tel.registry.snapshot()
    print(f"registry: cache_hit_tokens={snap.get('cache_hit_tokens', 0):.0f} "
          f"cache_hit_rate={snap.get('cache_hit_rate', 0.0):.2f} "
          f"pool_cow_copies={snap.get('pool_cow_copies', 0):.0f} "
          f"ttft_p99_ms={snap['serve_ttft_seconds']['p99'] * 1e3:.1f} "
          f"tpot_p99_ms={snap['serve_tpot_seconds']['p99'] * 1e3:.2f}")
    for h in handles[:2]:
        r = results[h.req_id]
        print(f"req{h.req_id} (ttft {r.ttft * 1e3:.0f}ms): {r.tokens}")
    return {"prompts": prompts,
            "tokens": {h.req_id: list(results[h.req_id].tokens)
                       for h in handles}}


if __name__ == "__main__":
    main()
