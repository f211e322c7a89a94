"""The grouped/tiled/split paged decode kernel (K1) against the per-head
single-block kernel (K8) on a long-context mixed-length batch — the JAX
package's ``benchmarks/decode_paged_bench.py`` on the port.

A fused batch where ONE long request stretches the pow2-bucketed,
batch-shared block-table width, replayed through the two kernel dataflows
over the same pool and tables:

* **per-head** (``flash_decode_paged_single``, K8): one lane per (sequence,
  query head), every query head of a GQA group reading the group's K/V
  for itself, one pool block per serial step;
* **grouped** (``flash_decode_paged``, K1): one lane per (sequence, KV head,
  split lane) for the whole group, ``kv_tile_blocks``-block tiles, split-K
  partials merged by the exact Softermax combine.

Two measurements:

1. **Kernel-level decode tok/s** (gated at >= 1.5x in full mode): N decode
   steps of the batch through each kernel, lengths advancing per step,
   best of strictly alternating rounds. On the card each N-step loop is
   timed with CUDA events; on the CPU (``--device cpu``) both dispatchers
   run their plain versions and the host clock times them (``mode``
   "cpu-plain": no statement about the card). The modeled gather bytes
   per token and layer (the TPU kernels' DMA) are reported beside.
2. **Engine-level greedy equality**: one-shot (cold, and cached with a
   copy-on-write fork) and chunked engines at baseline and at the
   tiled/split grid, bf16 and int8 pools, produce identical streams per
   dtype.

Full mode writes ``BENCH_torch_decode.json`` (the reference's
``BENCH_decode.json`` is its own CPU artifact). Prints
``decode_paged_bench,...`` CSV lines, the last one the tok/s ratio.

    PYTHONPATH=src python -m repro_torch.benchmarks.decode_paged_bench
    PYTHONPATH=src python -m repro_torch.benchmarks.decode_paged_bench \\
        --device cpu --smoke
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def _mixed_lengths(rng, requests, long_tokens, short_blocks_max,
                   block_size):
    """One long-context request + short mixed-length rest."""
    lens = [long_tokens]
    for _ in range(requests - 1):
        lens.append(int(rng.integers(block_size,
                                     short_blocks_max * block_size + 1)))
    return np.asarray(lens, np.int64)


def workload(args, rng, device):
    """The timed batch: f32 pools over disjoint tables of the engine's
    decode width, pre-scaled queries, and the lengths of each step."""
    from repro_torch.serve.paged_step import table_width_bucket

    B, Hq, Hkv = args.requests, args.hq, args.hkv
    D, BS = args.head_dim, args.block_size
    lens0 = _mixed_lengths(rng, B, args.long_blocks * BS,
                           args.short_blocks_max, BS)
    need = int(-(-(lens0.max() + args.steps) // BS))
    W = table_width_bucket(need)          # the engine's decode width policy
    N = int(sum(-(-(l + args.steps) // BS) for l in lens0)) + 1  # pool
    kp = torch.from_numpy(rng.normal(size=(N, Hkv, BS, D))
                          .astype(np.float32)).to(device)
    vp = torch.from_numpy(rng.normal(size=(N, Hkv, BS, D))
                          .astype(np.float32)).to(device)
    bt = np.zeros((B, W), np.int32)
    nxt = 1
    for b, l in enumerate(lens0):         # disjoint tables, pool-faithful
        nb = -(-(int(l) + args.steps) // BS)
        bt[b, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    q = torch.from_numpy((rng.normal(size=(B, Hq, D)) / np.sqrt(D))
                         .astype(np.float32)).to(device)
    lens_steps = [torch.from_numpy((lens0 + s).astype(np.int32)).to(device)
                  for s in range(args.steps)]
    return dict(q=q, kp=kp, vp=vp, bt=torch.from_numpy(bt).to(device),
                lens_steps=lens_steps, W=W)


def time_kernels(args, rng, device):
    """Parity of the two kernels' outputs, then best-of alternating rounds
    of each one's N-step loop. Returns (single_s, grouped_s, meta)."""
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged_op, flash_decode_paged_single_op, split_layout)

    wl = workload(args, rng, device)
    q, kp, vp, bt = wl["q"], wl["kp"], wl["vp"], wl["bt"]
    W = wl["W"]
    cuda = device.type == "cuda"

    def run_single():
        for ln in wl["lens_steps"]:
            o = flash_decode_paged_single_op(q, kp, vp, bt, ln)
        return o

    def run_grouped():
        for ln in wl["lens_steps"]:
            o = flash_decode_paged_op(q, kp, vp, bt, ln,
                                      kv_tile_blocks=args.tile_blocks,
                                      split_k=args.split_k)
        return o

    # parity first (and the kernels' first launches), then strictly
    # alternating rounds
    o_s = run_single().cpu().numpy()
    o_g = run_grouped().cpu().numpy()
    np.testing.assert_allclose(o_g, o_s, atol=1e-5)
    single_s, grouped_s = [], []
    for _ in range(args.repeats):
        for fn, times in ((run_single, single_s), (run_grouped, grouped_s)):
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)

    # modeled gather traffic per decoded token, per layer (the TPU
    # kernels' DMA): the per-head kernel walks W blocks once per *query*
    # head, the grouped kernel once per *KV* head over the tile-padded
    # table
    _, _, _, Wp = split_layout(W, args.tile_blocks, args.split_k)
    itm = 4                               # float32 pools
    D, BS = args.head_dim, args.block_size
    bytes_single = 2 * args.hq * W * BS * D * itm
    bytes_grouped = 2 * args.hkv * Wp * BS * D * itm
    return (float(min(single_s)), float(min(grouped_s)),
            {"mode": "cuda" if cuda else "cpu-plain",
             "table_width": int(W), "padded_width": int(Wp),
             "gather_bytes_per_token_per_layer": {
                 "single": int(bytes_single), "grouped": int(bytes_grouped),
                 "ratio": round(bytes_single / bytes_grouped, 3)}})


def engine_equality(args, rng, device):
    """Five serving paths (one-shot cold, one-shot cached with a COW fork
    and rehit, chunked), baseline against tiled/split grids, bf16 and
    int8: greedy streams identical per dtype."""
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine

    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    shared = rng.integers(1, cfg.vocab_size, (21,)).astype(np.int32)
    prompts = [np.concatenate(
        [shared, rng.integers(1, cfg.vocab_size, (n,))]).astype(np.int32)
        for n in (13, 30, 7)]

    def serve(**kw):
        eng = ContinuousEngine(cfg, params, block_size=8, num_blocks=64,
                               max_batch=4, max_len=96, device=device, **kw)
        hs = [eng.submit(p, 6) for p in prompts]
        res = eng.run()
        return [res[h.req_id].tokens for h in hs], eng

    grid = dict(kv_tile_blocks=args.tile_blocks,
                decode_split_k=args.split_k)
    cow_seen = 0
    for dtype in ("bf16", "int8"):
        kd = dict(kv_dtype=dtype) if dtype == "int8" else {}
        base, _ = serve(**kd)
        cold, _ = serve(prefix_cache=False, **grid, **kd)
        cached, e1 = serve(**grid, **kd)
        chunked, _ = serve(prefill_chunk=16, **grid, **kd)
        assert base == cold == cached == chunked, \
            f"{dtype}: greedy streams diverged across paths/grids"
        cow_seen += e1.metrics.cow_copies
    assert cow_seen >= 2, "COW-fork path was not exercised"
    return True


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card; 'cpu' "
                         "times the kernels' plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--hq", type=int, default=8,
                    help="query heads (kernel-level workload)")
    ap.add_argument("--hkv", type=int, default=2,
                    help="KV heads — hq/hkv is the GQA group whose "
                         "repeated gather the grouped kernel removes")
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--long-blocks", type=int, default=44,
                    help="resident blocks of the long-context request; its "
                         "pow2-bucketed cover is the table width EVERY "
                         "row's lane walks")
    ap.add_argument("--short-blocks-max", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4,
                    help="decode steps timed per round (lengths advance)")
    ap.add_argument("--tile-blocks", type=int, default=4,
                    help="kv_tile_blocks for the grouped kernel")
    ap.add_argument("--split-k", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=2,
                    help="alternating rounds; best-of reported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="BENCH_torch_decode.json")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast mode (asserts kernel parity + engine "
                         "greedy equality; speed reported, not gated)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = 2
        args.hq, args.hkv, args.head_dim = 4, 2, 16
        args.long_blocks, args.short_blocks_max = 6, 2
        args.steps, args.repeats = 2, 1
        args.tile_blocks, args.split_k = 2, 2
    return args


def main(argv=None) -> float:
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    print(f"decode_paged_bench,workload,requests,{args.requests},"
          f"hq,{args.hq},hkv,{args.hkv},long_blocks,{args.long_blocks},"
          f"block_size,{args.block_size},tile_blocks,{args.tile_blocks},"
          f"split_k,{args.split_k}")

    single_s, grouped_s, meta = time_kernels(args, rng, device)
    toks = args.requests * args.steps
    ratio = single_s / grouped_s
    print(f"decode_paged_bench,per_head,decode_s,{single_s:.6f},"
          f"tok_s,{toks / single_s:.1f}")
    print(f"decode_paged_bench,grouped,decode_s,{grouped_s:.6f},"
          f"tok_s,{toks / grouped_s:.1f}")
    dma = meta["gather_bytes_per_token_per_layer"]
    print(f"decode_paged_bench,gather_bytes_ratio,{dma['ratio']},"
          f"mode,{meta['mode']}")

    engine_equality(args, rng, device)
    print("decode_paged_bench,engine,greedy_equal,1")
    print(f"decode_paged_bench,ratio_per_head_over_grouped,{ratio:.2f}")

    if not args.smoke:
        assert ratio >= 1.5, (
            f"grouped/tiled/split decode speedup {ratio:.2f}x < 1.5x")
        from repro_torch.benchmarks.provenance import provenance
        record = {
            "bench": "decode_paged",
            "provenance": provenance(mode=meta["mode"]),
            "workload": {
                "requests": args.requests, "hq": args.hq, "hkv": args.hkv,
                "head_dim": args.head_dim, "block_size": args.block_size,
                "long_blocks": args.long_blocks,
                "short_blocks_max": args.short_blocks_max,
                "steps": args.steps, "arch": args.arch, "reduced": True},
            "grid": {"kv_tile_blocks": args.tile_blocks,
                     "split_k": args.split_k},
            "measurement": meta,
            "device": device.type,
            "per_head": {"decode_s": single_s, "tok_s": toks / single_s},
            "grouped": {"decode_s": grouped_s, "tok_s": toks / grouped_s},
            "ratio_per_head_over_grouped": ratio,
            "greedy_equal": True,
        }
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
        print(f"decode_paged_bench,wrote,{args.out}")
    return ratio


if __name__ == "__main__":
    main()
