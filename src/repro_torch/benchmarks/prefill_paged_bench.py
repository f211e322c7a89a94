"""Chunked-prefill kernel (K2) against the dense one-shot suffix prefill on
long documents — the JAX package's ``benchmarks/prefill_paged_bench.py``
on the port.

Every request is a long unique document body behind a shared,
radix-cache-resident head (RAG / long-context chat: the head is the
system prompt or a shared document, the body is new text), replayed
through the two prefill paths at an EQUAL pool budget:

* **dense**   — ``paged_prefill_suffix`` computes the whole uncached
  remainder as ONE dense attention: the full (suffix, prefix + suffix)
  score matrix per layer, the prefix K/V gathered out of the pool through
  the engine's pow2-bucketed prefix table (junk columns masked).
* **chunked** — ``paged_prefill_chunked`` walks the same remainder in
  fixed-size chunks through ``kernels/flash_prefill_paged`` (K2 on the
  card); each chunk writes its K/V into the pool and attends [cached
  prefix ‖ earlier chunks ‖ itself] through the block table.

Two measurements:

1. **Op-level prefill tok/s** (gated at >= 2x in full mode): both paths
   prefill the identical suffix over the identical resident prefix,
   their pool writes included, best of strictly alternating rounds. Each
   timed region ends in a device synchronize before the clock is read.
2. **Engine-level greedy equality**: a chunked ``ContinuousEngine`` and a
   one-shot engine serve the same workload at the same pool budget; every
   request's tokens must be identical, and the argmax of both paths' last
   logits must agree.

Full mode writes ``BENCH_torch_prefill.json`` (the reference's
``BENCH_prefill.json`` is its own CPU artifact). Prints
``prefill_paged_bench,...`` CSV lines, the last one the tok/s ratio.

    PYTHONPATH=src python -m repro_torch.benchmarks.prefill_paged_bench
    PYTHONPATH=src python -m repro_torch.benchmarks.prefill_paged_bench \\
        --device cpu --smoke
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List

import numpy as np
import torch

from repro_torch.utils.device import resolve_device, synchronize


def make_docs(n: int, shared_len: int, doc_len: int, vocab: int,
              seed: int) -> List[np.ndarray]:
    """Shared head (system prompt / shared document) + long unique body."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, (shared_len,))
    return [np.concatenate([head, rng.integers(1, vocab, (doc_len,))]
                           ).astype(np.int32) for _ in range(n)]


def _time_op_paths(cfg, params, prompt, *, shared_len, block_size, chunk,
                   repeats, device):
    """Prefill ``prompt[shared_len:]`` over a resident prefix through both
    paths, alternating rounds; returns (dense_s, chunked_s, argmax_equal).
    Each round rewrites the same pool (equal budget).

    Both paths are driven as ``ContinuousEngine`` dispatches them, table
    width policies included: the dense path gathers its prefix through a
    pow2-bucketed table, the chunked path uses chunk-quantized covers. The
    inputs of both are built on the device beforehand, so the timing
    isolates the prefill work."""
    from repro_torch.models.schema import tree_map, unstack_layers
    from repro_torch.serve.kv_pool import PagedKVCache
    from repro_torch.serve.paged_step import (paged_prefill,
                                              paged_prefill_chunked,
                                              paged_prefill_suffix,
                                              scatter_prefill,
                                              scatter_prefill_offset,
                                              table_width_bucket)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    params = unstack_layers(tree_map(lambda a: a.to(device), params))
    bs = block_size
    S = prompt.shape[0]
    m0 = shared_len
    nb = -(-S // bs)
    pool = PagedKVCache(cfg, num_blocks=nb, block_size=bs, device=device)
    table = np.asarray(pool.alloc(0, nb), np.int32)

    # make the shared head resident once (cold full prefill of the head,
    # right-padded to a block multiple like the engine's cold path)
    mb = -(-m0 // bs) * bs
    head = np.zeros((1, mb), np.int32)
    head[0, :m0] = prompt[:m0]
    _, ks, vs = paged_prefill(params, dev(head), dev([m0 - 1]), cfg)
    scatter_prefill(pool.k, pool.v, ks, vs, dev(table[:mb // bs]))
    del ks, vs

    sl = S - m0
    slp = -(-sl // bs) * bs
    toks = np.zeros((1, slp), np.int32)
    toks[0, :sl] = prompt[m0:]
    toks = dev(toks)
    pos = m0 + np.arange(slp)
    blk = dev(np.where(pos < S, table[np.minimum(pos, S - 1) // bs], 0))
    off = dev(pos % bs)
    W_pre = -(-m0 // bs)
    wp = table_width_bucket(W_pre)   # dense engine path: pow2 prefix table
    ptd = np.zeros((1, wp), np.int32)
    ptd[0, :W_pre] = table[:W_pre]
    ptd = dev(ptd)
    last = dev([sl - 1])
    m0j = dev([m0])

    cq = chunk // bs
    chunks = []
    m = m0
    while m < S:
        c = min(chunk, S - m)
        ct = np.zeros((1, chunk), np.int32)    # engine pads chunks to C
        ct[0, :c] = prompt[m:m + c]
        cover = min(-(-(m + chunk) // bs), nb)
        w = table_width_bucket(cover, chunk_blocks=cq)  # engine policy
        pt = np.zeros((1, w), np.int32)
        pt[0, :cover] = table[:cover]
        cpos = m + np.arange(chunk)
        cblk = np.where(cpos < S, table[np.minimum(cpos, S - 1) // bs], 0)
        cblk[c:] = 0                 # pad rows -> garbage block 0
        chunks.append((dev(ct), m, dev([c - 1]), dev(pt), dev(cblk),
                       dev(cpos % bs)))
        m += c

    def dense_once():
        t0 = time.perf_counter()
        lg, ks, vs = paged_prefill_suffix(params, toks, m0, last, pool.k,
                                          pool.v, ptd, m0j, cfg)
        scatter_prefill_offset(pool.k, pool.v, ks, vs, blk, off)
        synchronize(device)
        return time.perf_counter() - t0, lg

    def chunked_once():
        t0 = time.perf_counter()
        lg = None
        for ct, p0, lr, pt, bl, of in chunks:
            lg = paged_prefill_chunked(params, ct, p0, lr, pool.k, pool.v,
                                       pt, bl, of, cfg)
        synchronize(device)
        return time.perf_counter() - t0, lg

    synchronize(device)
    dense_once(), chunked_once()                 # first launches of both
    dense_s, chunked_s = [], []
    lg_d = lg_c = None
    for _ in range(repeats):
        td, lg_d = dense_once()
        tc, lg_c = chunked_once()
        dense_s.append(td)
        chunked_s.append(tc)
    eq = bool(torch.argmax(lg_d) == torch.argmax(lg_c))
    return float(min(dense_s)), float(min(chunked_s)), eq


def _engine_equality(cfg, params, prompts, *, block_size, num_blocks,
                     max_batch, max_len, max_new, chunk, device,
                     on_engine=None):
    """Serve the workload through a one-shot and a chunked engine at the
    same pool budget. Returns (tokens equal, chunked metrics, the streams
    of each by its ``prefill_chunk``); ``on_engine(engine, chunk)`` sees
    each engine before it serves."""
    from repro_torch.serve import ContinuousEngine
    outs = {}
    eng = None
    for c in (0, chunk):
        eng = ContinuousEngine(cfg, params, block_size=block_size,
                               num_blocks=num_blocks, max_batch=max_batch,
                               max_len=max_len, prefill_chunk=c,
                               device=device)
        if on_engine is not None:
            on_engine(eng, c)
        handles = [eng.submit(p, max_new) for p in prompts]
        results = eng.run()
        outs[c] = [results[h.req_id].tokens for h in handles]
    return outs[0] == outs[chunk], eng.metrics, outs


def record(args, device, dense_s, chunked_s):
    """The full-mode JSON record: the reference's fields, the port's
    provenance header."""
    from repro_torch.benchmarks.provenance import provenance
    sl = args.doc_len
    mode = "cuda" if device.type == "cuda" else "cpu-plain"
    return {
        "bench": "prefill_paged",
        "provenance": provenance(mode=mode),
        "workload": {"requests": args.requests,
                     "shared_len": args.shared_len,
                     "doc_len": args.doc_len, "chunk": args.chunk,
                     "block_size": args.block_size,
                     "arch": args.arch, "reduced": True},
        "backend": device.type,
        "dense": {"prefill_s": round(dense_s, 4),
                  "tok_s": round(sl / dense_s, 1)},
        "chunked": {"prefill_s": round(chunked_s, 4),
                    "tok_s": round(sl / chunked_s, 1)},
        "ratio_dense_over_chunked": round(dense_s / chunked_s, 3),
        "greedy_equal": True,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--shared-len", type=int, default=576,
                    help="shared head tokens, radix-cache-resident (the "
                         "cached prefix the suffix attends through the "
                         "block table); deliberately not a pow2 block "
                         "count — the dense engine path pow2-buckets its "
                         "prefix gather, and that cost is part of what "
                         "the kernel path removes")
    ap.add_argument("--doc-len", type=int, default=3072,
                    help="unique document-body tokens per request (the "
                         "uncached remainder both paths must prefill)")
    ap.add_argument("--chunk", type=int, default=256,
                    help="prefill chunk size (tokens)")
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=7,
                    help="alternating op-level rounds; best-of reported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_torch_prefill.json",
                    help="full mode: write the JSON perf record here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast mode (asserts chunked==dense greedy "
                         "outputs; speed reported, not gated)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = 2
        args.shared_len = 96
        args.doc_len = 256
        args.chunk = 128
        args.repeats = 2
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))

    S = args.shared_len + args.doc_len
    prompts = make_docs(args.requests, args.shared_len, args.doc_len,
                        cfg.vocab_size, args.seed)
    print(f"prefill_paged_bench,workload,requests,{args.requests},"
          f"shared,{args.shared_len},doc,{args.doc_len},"
          f"chunk,{args.chunk},block_size,{args.block_size}")

    dense_s, chunked_s, argmax_eq = _time_op_paths(
        cfg, params, prompts[0], shared_len=args.shared_len,
        block_size=args.block_size, chunk=args.chunk, repeats=args.repeats,
        device=device)
    assert argmax_eq, "dense and chunked prefill disagree on the next token"
    sl = args.doc_len
    ratio = dense_s / chunked_s
    print(f"prefill_paged_bench,dense,prefill_s,{dense_s:.3f},"
          f"tok_s,{sl / dense_s:.0f}")
    print(f"prefill_paged_bench,chunked,prefill_s,{chunked_s:.3f},"
          f"tok_s,{sl / chunked_s:.0f}")

    # equal pool budget for both engines: every trajectory + slack
    num_blocks = args.requests * ((S + args.max_new) // args.block_size + 2)
    tokens_eq, metrics, _ = _engine_equality(
        cfg, params, prompts, block_size=args.block_size,
        num_blocks=num_blocks, max_batch=max(2, args.requests // 2),
        max_len=S + args.max_new, max_new=args.max_new, chunk=args.chunk,
        device=device)
    assert tokens_eq, "chunked engine diverged from one-shot engine"
    print(f"prefill_paged_bench,engine,greedy_equal,1,"
          f"prefill_chunks,{metrics.prefill_chunks},"
          f"prefix_hit_tokens,{metrics.prefix_hit_tokens}")
    print(f"prefill_paged_bench,ratio_dense_over_chunked,{ratio:.2f}")

    if not args.smoke:
        assert ratio >= 2.0, (
            f"chunked prefill speedup {ratio:.2f}x < 2.0x")
        with open(args.out, "w") as f:
            json.dump(record(args, device, dense_s, chunked_s), f, indent=2)
            f.write("\n")
        print(f"prefill_paged_bench,wrote,{args.out}")
    return ratio


if __name__ == "__main__":
    main()
