"""Host time of the grouped paged decode wrapper (K1): what one call of
``flash_decode_paged`` costs the host to enqueue, with no device wait.

Two readings of the same calls (``host_times``):

* the mean over 20 back-to-back calls with Python's garbage collector on,
  what a serving process pays, collections included (the method of the
  earlier readings in ``PERF.md``);
* the median of 20 calls' own times with the collector off, the wrapper's
  own path.

Shapes: the kernel-time shape of ``chip_smoke.py`` phase 6 (B 8, 1024
tokens, Hq 24, Hkv 8, D 128, BS 16, bf16 pool, tile 1, split 1) and step 0
of ``decode_paged_bench`` at its defaults and at the full-width geometry
(``FULL_GEOMETRY``, tile 4, split 2).

The script calls only the wrapper's public entry point and the bench's
workload, so pointing ``PYTHONPATH`` at another checkout's ``src`` times
that checkout's wrapper on the same inputs (run it by path, so that the
package comes from ``PYTHONPATH``):

    PYTHONPATH=src python src/repro_torch/benchmarks/decode_host.py

Prints a line per shape and, last, one JSON object ``{label: {"mean_ms",
"median_ms"}}``. Needs a CUDA card.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

# the benches' full-width geometry: llama3.2-3b's heads, one 16,384-token
# request and seven of up to 1,024
FULL_GEOMETRY = ["--requests", "8", "--hq", "24", "--hkv", "8",
                 "--head-dim", "128", "--block-size", "16", "--long-blocks",
                 "1024", "--short-blocks-max", "64"]
FULL_BENCH = FULL_GEOMETRY + ["--steps", "4", "--tile-blocks", "4",
                              "--split-k", "2"]


def host_times(fn, iters: int = 20):
    """(mean, median) host ms to enqueue one call of ``fn``: the mean of
    ``iters`` back-to-back calls with the garbage collector on, then the
    median of ``iters`` calls timed one by one with it off."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    mean = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    gc.disable()
    try:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    finally:
        gc.enable()
    torch.cuda.synchronize()
    return mean, sorted(times)[iters // 2] * 1e3


def cases(dev):
    """(label, call) pairs: K1 at each shape, its inputs on ``dev``."""
    from repro_torch.benchmarks import decode_paged_bench as bench
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged

    g = torch.Generator(device="cpu").manual_seed(1)
    B, L, Hq, Hkv, D, BS = 8, 1024, 24, 8, 128, 16
    W = L // BS

    def bf16(*shape):
        return torch.randn(shape, generator=g).to(dev, torch.bfloat16)

    kp, vp = bf16(B * W + 1, Hkv, BS, D), bf16(B * W + 1, Hkv, BS, D)
    bt = (torch.randperm(B * W, generator=g) + 1).reshape(B, W).to(
        dev, torch.int32)
    ln = torch.full((B,), L, dtype=torch.int32, device=dev)
    q = bf16(B, Hq, D) * D ** -0.5
    out = [("phase-6 shape",
            lambda: flash_decode_paged(q, kp, vp, bt, ln))]
    for label, argv in (("bench defaults step 0", []),
                        ("bench full-width step 0", FULL_BENCH)):
        args = bench.parse_args(argv + ["--device", "cuda"])
        wl = bench.workload(args, np.random.default_rng(args.seed), dev)
        out.append((label, lambda wl=wl, args=args: flash_decode_paged(
            wl["q"], wl["kp"], wl["vp"], wl["bt"], wl["lens_steps"][0],
            kv_tile_blocks=args.tile_blocks, split_k=args.split_k)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_host: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    res = {}
    for label, fn in cases(dev):
        fn()                                  # build, caches, first launch
        mean, median = host_times(fn)
        res[label] = {"mean_ms": mean, "median_ms": median}
        print(f"K1 wrapper host enqueue, {label}: mean of 20 {mean:.4f} ms "
              f"(collector on), median of 20 {median:.4f} ms (collector "
              f"off)")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
