"""Int8 quantized paged KV pool against bf16 at an EQUAL device-memory
budget — the JAX package's ``benchmarks/kv_int8_bench.py`` on the port.

Decode is memory-bound and pool capacity caps concurrency, so storing K/V
as int8 with per-row scales buys two wins, measured separately:

1. **Pool token capacity** (gated at >= 1.8x in full mode): both pools
   get the same byte budget — sized from the bf16 pool's
   ``PagedKVCache.bytes_per_block`` — and the int8 pool holds ~2x the
   blocks (the per-row f32 scales cost Dh/4 of the int8 payload back, so
   the exact ratio is ``2*Dh / (Dh + 4)``: 1.88x at head_dim 64).
2. **Served throughput** (gated at >= 1.3x): a concurrency-bound workload
   — more trajectories than either pool holds at once — served to
   completion by both engines. tok/s is wall-clock over delivered tokens,
   best of N alternating rounds, the first launches excluded by a
   throwaway first round; each round ends in a device synchronize.

**Accuracy guardrail.** A logit-error probe holds the max |logit delta|
between a full-precision and an int8-quantized prefill within
``--logit-tol``; a greedy-flip audit requires every bf16-vs-int8 stream
divergence to sit at a near-tie (the full-precision gap between the two
diverging tokens inside twice the tolerance) — a flip at a decisive gap
fails the bench.

The config is the reduced model with a production head_dim (64 by
default): the capacity ratio depends only on head_dim.

Full mode writes ``BENCH_torch_kv_int8.json`` (the reference's
``BENCH_kv_int8.json`` is its own CPU artifact).

    PYTHONPATH=src python -m repro_torch.benchmarks.kv_int8_bench
    PYTHONPATH=src python -m repro_torch.benchmarks.kv_int8_bench \\
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


def make_prompts(n: int, plen: int, vocab: int, seed: int
                 ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (plen,)).astype(np.int32)
            for _ in range(n)]


def _serve_once(eng, prompts, max_new):
    """One full serve of the workload on a persistent engine; returns
    (wall_s, token streams)."""
    handles = [eng.submit(p, max_new) for p in prompts]
    t0 = time.perf_counter()
    results = eng.run()
    synchronize(eng.device)
    wall = time.perf_counter() - t0
    toks = [results[h.req_id].tokens for h in handles]
    assert all(len(t) == max_new for t in toks)
    return wall, toks


def _prefill_logits(cfg, params, tokens, quantize, device):
    from repro_torch.serve.paged_step import paged_prefill
    t = torch.as_tensor(np.asarray(tokens, np.int32)[None], device=device)
    last = torch.tensor([t.shape[1] - 1], dtype=torch.int32, device=device)
    lg, _, _ = paged_prefill(params, t, last, cfg, kv_quantize=quantize)
    return lg[0, :cfg.vocab_size].float().cpu().numpy()


def _logit_error_probe(cfg, params, prompt, device) -> float:
    """Max |logit delta| of a full-precision vs int8-quantized prefill of
    one prompt — the documented accuracy bound for the pool."""
    return float(np.abs(_prefill_logits(cfg, params, prompt, False, device) -
                        _prefill_logits(cfg, params, prompt, True, device)
                        ).max())


def _audit_divergences(cfg, params, prompts, toks_ref, toks_q, band,
                       device):
    """For every request whose int8 stream diverges from bf16, check the
    first flipped token was a near-tie: the full-precision logit gap
    between the two tokens that diverged (bf16's pick against int8's, not
    the generic top-2) must sit inside ``band``. Returns (n_diverged, max
    excused gap); raises on a decisive flip."""
    n_div, max_gap = 0, 0.0
    for prompt, a, b in zip(prompts, toks_ref, toks_q):
        if a == b:
            continue
        n_div += 1
        d = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.concatenate([prompt, np.asarray(a[:d], np.int32)])
        lg = _prefill_logits(cfg, params, ctx, False, device)
        gap = abs(float(lg[a[d]] - lg[b[d]]))
        max_gap = max(max_gap, gap)
        assert gap <= band, (
            f"int8 flipped a greedy token at a decisive logit gap "
            f"{gap:.4f} > noise band {band} (true drift, not a near-tie)")
    return n_div, max_gap


def equal_budget(cfg, block_size, bf16_blocks):
    """(budget bytes, int8 blocks, capacity ratio) of an int8 pool given
    the bytes of ``bf16_blocks`` bf16 blocks."""
    from repro_torch.serve.kv_pool import PagedKVCache
    b_bf16 = PagedKVCache.bytes_per_block(cfg, block_size, "bf16")
    b_int8 = PagedKVCache.bytes_per_block(cfg, block_size, "int8")
    budget = bf16_blocks * b_bf16
    int8_blocks = budget // b_int8
    return budget, int8_blocks, int8_blocks / bf16_blocks


def make_engines(cfg, params, args, int8_blocks, device):
    """The bf16 and int8 engines of the workload, by pool dtype, and the
    concurrency each pool admits."""
    from repro_torch.serve import ContinuousEngine
    max_len = args.prompt_len + args.max_new
    traj_blocks = -(-(max_len - 1) // args.block_size)
    conc = {"bf16": args.bf16_blocks // traj_blocks,
            "int8": int8_blocks // traj_blocks}
    max_batch = max(conc["int8"] + 1, 2)
    engines = {
        kv: ContinuousEngine(
            cfg, params, block_size=args.block_size, num_blocks=nb,
            max_batch=max_batch, max_len=max_len,
            max_admit_per_step=max_batch, prefix_cache=False, kv_dtype=kv,
            device=device)
        for kv, nb in (("bf16", args.bf16_blocks),
                       ("int8", int(int8_blocks)))}
    return engines, traj_blocks, conc


def serve_rounds(engines, prompts, max_new, repeats):
    """A throwaway round per engine, then alternating timed rounds.
    Returns (wall times by dtype, the last round's streams by dtype)."""
    walls = {kv: [] for kv in engines}
    toks = {}
    for eng in engines.values():
        _serve_once(eng, prompts, max_new)
    for _ in range(repeats):
        for kv, eng in engines.items():
            w, t = _serve_once(eng, prompts, max_new)
            walls[kv].append(w)
            toks[kv] = t
    return walls, toks


def record(args, device, budget, int8_blocks, cap_ratio, walls, tok_s,
           ratio, greedy_equal, agreement, n_div, flip_gap, err):
    """The full-mode JSON record: the reference's fields, the port's
    provenance header."""
    from repro_torch.benchmarks.provenance import provenance
    mode = "cuda" if device.type == "cuda" else "cpu-plain"
    return {
        "bench": "kv_int8",
        "provenance": provenance(mode=mode),
        "workload": {"requests": args.requests,
                     "prompt_len": args.prompt_len,
                     "max_new": args.max_new,
                     "block_size": args.block_size,
                     "head_dim": args.head_dim,
                     "bf16_blocks": args.bf16_blocks,
                     "int8_blocks": int(int8_blocks),
                     "arch": args.arch, "reduced": True},
        "backend": device.type,
        "hbm_budget_bytes": int(budget),
        "capacity_ratio_int8_over_bf16": round(cap_ratio, 3),
        "bf16": {"serve_s": round(min(walls["bf16"]), 4),
                 "tok_s": round(tok_s["bf16"], 1)},
        "int8": {"serve_s": round(min(walls["int8"]), 4),
                 "tok_s": round(tok_s["int8"], 1)},
        "tok_s_ratio_int8_over_bf16": round(ratio, 3),
        "greedy_equal": greedy_equal,
        "greedy_agreement": round(agreement, 3),
        "divergences_excused_as_near_ties": n_div,
        "max_excused_flip_gap": round(flip_gap, 5),
        "max_prefill_logit_error": round(err, 5),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--head-dim", type=int, default=64,
                    help="override the reduced config's toy head_dim with "
                         "a production one — the capacity ratio "
                         "2*Dh/(Dh+4) is what's being measured")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=40)
    ap.add_argument("--max-new", type=int, default=56)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--bf16-blocks", type=int, default=18,
                    help="bf16 pool blocks; their bytes are the shared "
                         "budget the int8 pool is sized from (3 "
                         "trajectories' worth by default — the workload "
                         "stays concurrency-bound for both pools)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="alternating serve rounds per engine; best-of")
    ap.add_argument("--logit-tol", type=float, default=0.1,
                    help="guardrail: max |logit delta| allowed between "
                         "full-precision and int8-quantized prefill")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_torch_kv_int8.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast mode (asserts int8==bf16 greedy "
                         "outputs + the logit bound; ratios reported, not "
                         "gated)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = 4
        args.prompt_len = 12
        args.max_new = 8
        args.bf16_blocks = 6
        args.block_size = 8
        args.repeats = 1
        args.seed = 2
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_map
    cfg = reduce_config(get_config(args.arch)).replace(
        head_dim=args.head_dim)
    params = tree_map(lambda a: a.to(device), init_lm_params(
        cfg, torch.Generator().manual_seed(0)))

    # -- equal memory budget ----------------------------------------------
    budget, int8_blocks, cap_ratio = equal_budget(cfg, args.block_size,
                                                  args.bf16_blocks)
    print(f"kv_int8_bench,budget_bytes,{budget},bf16_blocks,"
          f"{args.bf16_blocks},int8_blocks,{int8_blocks},"
          f"capacity_ratio,{cap_ratio:.2f}")

    engines, traj_blocks, conc = make_engines(cfg, params, args,
                                              int8_blocks, device)
    print(f"kv_int8_bench,workload,requests,{args.requests},prompt,"
          f"{args.prompt_len},max_new,{args.max_new},traj_blocks,"
          f"{traj_blocks},concurrency,bf16,{conc['bf16']},int8,"
          f"{conc['int8']}")

    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab_size,
                           args.seed)
    walls, toks = serve_rounds(engines, prompts, args.max_new, args.repeats)
    assert engines["int8"].metrics.preemptions == 0

    total = args.requests * args.max_new
    tok_s = {kv: total / min(ws) for kv, ws in walls.items()}
    ratio = tok_s["int8"] / tok_s["bf16"]
    for kv in ("bf16", "int8"):
        print(f"kv_int8_bench,{kv},serve_s,{min(walls[kv]):.3f},"
              f"tok_s,{tok_s[kv]:.0f}")
    print(f"kv_int8_bench,ratio_int8_over_bf16,{ratio:.2f}")

    # -- accuracy guardrail -------------------------------------------------
    err = max(_logit_error_probe(cfg, params, p, device)
              for p in prompts[:3])
    assert err <= args.logit_tol, (
        f"int8 prefill logit error {err:.4f} > {args.logit_tol}")
    greedy_equal = toks["bf16"] == toks["int8"]
    n_div, flip_gap = _audit_divergences(
        cfg, params, prompts, toks["bf16"], toks["int8"],
        band=2 * args.logit_tol, device=device)
    agreement = 1.0 - n_div / args.requests
    print(f"kv_int8_bench,guardrail,greedy_equal,{int(greedy_equal)},"
          f"agreement,{agreement:.2f},max_logit_err,{err:.4f},"
          f"max_excused_flip_gap,{flip_gap:.4f}")

    if not args.smoke:
        assert cap_ratio >= 1.8, (
            f"equal-memory token capacity {cap_ratio:.2f}x < 1.8x")
        assert ratio >= 1.3, (
            f"int8 served tok/s {ratio:.2f}x < 1.3x at equal memory")
        rec = record(args, device, budget, int8_blocks, cap_ratio, walls,
                     tok_s, ratio, greedy_equal, agreement, n_div, flip_gap,
                     err)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
            f.write("\n")
        print(f"kv_int8_bench,wrote,{args.out}")
    return ratio


if __name__ == "__main__":
    main()
