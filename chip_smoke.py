#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: torch/CUDA versions and the card's name and power limit.
2. Build: the CUDA kernels from ``src/repro_torch/csrc`` (ptxas report;
   the registers and spills of K5's bulk-copy kernel, K6's and K7's
   register kernels and K2's tensor-core kernel).
3. Kernel parity at the main path's head geometry (Hq 24, Hkv 8, D 128,
   block 16): each kernel against its plain PyTorch version.
4. Engine parity at reduced llama3.2-3b in float32: the engine on the card
   (kernels) emits the same greedy streams as the engine on the CPU (plain
   versions); the launch counters equal layers x decode steps (decode
   kernel) and layers x chunks (prefill kernel).
5. Full-width serving of llama3.2-3b in bfloat16 with random weights:
   one-shot prefill, chunked prefill, a shared-prefix resubmit and an int8
   pool; every request finishes and the pool invariants hold; every K2
   launch of the bf16 chunked runs on the tensor-core route, of the int8
   run on the earlier kernel. A profile of one chunked run (K2's share of
   its device time); the chunked run once more on the earlier K2 kernel,
   its greedy streams against the tensor-core route's (near-tie audit) and
   each against the one-shot run's.
6. Kernel times at the main path's shapes (CUDA events, L2 flushed between
   launches) beside their bound and their plain versions; for K2, the
   tensor-core route beside the earlier kernel on the same inputs, the
   int8 pool (earlier kernel), SDPA on K/V gathered beforehand (a
   yardstick, gather not timed) and the wrapper's host enqueue time.
7. Flash-attention kernel parity: K3 (o, m, d) and K4 (dq, dk, dv) against
   their plain versions, bf16 (the tensor-core kernels) and fp32 (the
   CUDA-core kernels), IntMax on and off, causal and not, GQA groups 1 and
   3, Sq = Sk and Sq < Sk, lengths off every tile, D 128, 64 and 16; the
   route each case took; under IntMax m equal to the plain version's.
8. Training parity at reduced llama3.2-3b in float32, attention_impl
   "flash": three steps on the card (kernels) against the same steps on
   the CPU (plain versions), through the CUDA-core K3/K4 (fp32).
9. Full-width training of llama3.2-3b: 28 layers, bf16 compute, fp32
   master weights and AdamW state, remat "full", seq 4096, batch 1, random
   weights; one step with the plain chunked attention, then three steps
   through K3/K4 from the same weights and batch, every launch on the
   tensor-core kernels; step time, tokens/s, peak memory, launches per
   step and a profile of one step.
10. K3 and K4 times at the full-width shape beside their bound, their
   plain versions, the CUDA-core kernels on the same bf16 inputs (their
   earlier route) and PyTorch's scaled_dot_product_attention (forward,
   and its autograd backward), which computes the same function up to
   rounding and is timed here only as a yardstick; achieved TFLOP/s and
   the new kernels' registers and spills. The CUDA-core kernels' own
   route (fp32) is timed at the same shape.
11. Contiguous decode kernel parity: K5 against its plain version, bf16
   and fp32, IntMax on and off, GQA groups 1, 3, 4 and 8, caches of 37 and
   1056 rows, lengths 1, the chunk and pass boundaries +-1 and the whole
   cache, every case on the bulk-copy route; a bf16 cache of D 36 on the
   earlier kernel; the route's tile rows equal to the wrapper's mirror.
12. Static engine parity at reduced llama3.2-3b in float32: the static
   engine on the card (K5) emits the greedy streams of the same engine on
   the CPU and of the paged engine on the card; an int8 cache on the card
   equals the CPU's.
13. Full-width static serving of llama3.2-3b in bf16 with random weights:
   8 prompts of 1024 tokens, 32 new tokens, with a bf16 and an int8
   cache; tok/s, ms per decode step, K5 launches (every one on the
   bulk-copy route) and a profile of 5 decode steps; the same prompts
   through the paged engine (one-shot prefill, and 256-token chunks with
   K2 on the tensor-core route and on the earlier kernel), each with a
   near-tie audit of the first greedy token that differs.
14. K5's time at the full-width decode shape beside its bound, its plain
   version, the earlier kernel on the same inputs and
   scaled_dot_product_attention.
15. (A) Softermax row kernel (K6) and fixed-point kernel (K7) parity: K6
   against its plain version (float32 math) within ``kernels/parity.py``'s
   rule, f32 and bf16, IntMax on and off; K7 EQUAL (``torch.equal``) to its
   mirror ``softermax_quant_plain`` and within 2^-7 of ``softermax_fixed``;
   masked and pad columns, rows whose max is <= -17, V off the 16-wide
   slice, V one short of, at and one past the register routes' cap (4096
   and 8192 for K6 alone), and both full-width shapes of phase 20; the
   route each K6 and K7 case took.
16. (B) Fixed-point parity at reduced size, float32: the static engine on
   the card (K7 prefill, K5 decode) against the same engine on the CPU and
   the paged engine on the card, a first differing token held to the
   near-tie audit of phase 13; three Softermax-aware finetuning steps
   (``softermax_fixed``, K7) of reduced bert-base on the card against the
   CPU.
17. (C) Full-width fixed-point serving of llama3.2-3b in bf16
   (``softmax_impl="softermax_fixed"``: every one-shot prefill on the naive
   path through K7): 8 prompts of 1024 tokens, 32 new tokens, through the
   static and then the paged engine, with the near-tie audit between them;
   prefill ms, tok/s, K7 launches (28 per prefill call, every one on the
   register route) and a profile of the prefill by kernel.
18. (D) Full-width naive float path: the same prompts through the static
   engine with ``attention_impl="naive"``, ``softmax_impl="softermax"`` (K6,
   28 launches per prefill, every one on the register route), audited
   against ``attention_impl="flash"`` (K3), which computes the same
   function.
19. (E) Full-width Softermax-aware finetuning of bert-base (12 layers, d
   768, seq 512, batch 16, fp32 master weights, bf16 compute, remat
   "full"): the Table III workflow at 10 pretrain and 5 finetune steps per
   variant, every eval loss finite; ms per ``softermax_fixed`` and per
   ``softmax`` step, K7 launches per step (every one on the register
   route), peak memory.
20. (F) K6 and K7 times at the full-width prefill shape (rows 8 x 24 x
   1024, V 1024, f32) and the bert shape (rows 16 x 12 x 512, V 512) beside
   their byte bound, their plain versions, the two-pass kernels on the same
   inputs (their earlier routes; K7's EQUAL to the mirror on both) and,
   for K6, ``torch.softmax`` of the scores already scaled by ln 2 as the
   library yardstick (the factor folds into q in use, so it is not timed;
   no PyTorch call computes K7's function).

21. (G) Per-head paged decode kernel (K8) parity: K8 against its plain
   version ``paged_decode_single_plain`` for f32, bf16 and int8 pools,
   IntMax on and off, GQA groups 1, 3, 4, 8 and 12, blocks of 8 and 16,
   lengths 0, 1, on block edges and odd, garbage table tails; the same at
   the full-width llama3.2-3b geometry (Hq 24, Hkv 8, D 128, block 16);
   and K8 against K1 on the same inputs at (tile, split) (1, 1) and (4, 2).
22. (H) The ported ``decode_paged_bench`` (its measuring function, not its
   gated CLI) at the reference's defaults and at the full-width geometry
   (8 requests, Hq 24, Hkv 8, D 128, one 16,384-token request): per-head
   (K8) and grouped (K1) tok/s, their ratio, the modeled gather-bytes
   ratio; K8 and K1 launches of each run; each kernel's device time per
   launch and its wrapper's host enqueue time per call.
23. (I) Autotune at full width: the paged engine with phase 13's weights
   and phase 5's prompts under ``autotune`` off, static and per-step,
   greedy streams held equal or each first difference to the near-tie
   audit, the planner's decisions; then a replay of ``autotune_bench``'s
   full-width trajectory timing K1 at every candidate grid per sampled
   step: on how many steps the modeled argmin is the measured fastest (a
   reading, not a gate).
24. (J) K8's time at the phase-22 full-width shape beside its byte bound
   (K/V read once, as for K1) and its plain version; no PyTorch call
   computes paged IntMax base-2 attention, so no library time.

Phase 4 also runs one engine with ``attention_impl="flash"``, whose one-shot
prefill goes through K3.

Prints the ``{"kernels": [...]}`` line and then, last, one JSON line with
``ok`` and the device. Without a card it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
BF16_ATOL, F32_ATOL = 2e-2, 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rand(rng, shape, scale=1.0):
    import numpy as np
    import torch
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32))


def _pools(rng, N, Hkv, BS, D, kv, dev):
    """(k, v, k_scale, v_scale) pools of one layer: bf16, f32 or int8."""
    import torch
    from repro_torch.models.attention import quantize_kv
    k, v = _rand(rng, (N, Hkv, BS, D)), _rand(rng, (N, Hkv, BS, D))
    if kv == "int8":
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        return [t.to(dev) for t in (kq, vq, ks, vs)]
    dt = getattr(torch, kv)
    return [k.to(dev, dt), v.to(dev, dt), None, None]


def phase_kernel_parity(dev):
    """Each kernel against its plain version on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, paged_decode_split_ref)
    from repro_torch.kernels.flash_prefill_paged import (
        flash_prefill_paged, paged_prefill_ref)
    rng = np.random.default_rng(0)
    Hq, Hkv, D, BS = 24, 8, 128, 16
    worst = {}
    lens = np.array([0, 1, 17, 1000], np.int32)
    W = -(-int(lens.max()) // BS)
    N = len(lens) * W + 1
    cases = [(kv, T, S) for kv in ("bfloat16", "int8") for T in (1, 2)
             for S in (1, 2, 3)] + [("float32", 1, 2)]
    for kv, T, S in cases:
        kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, dev)
        bt = rng.permutation(np.arange(1, N))[:len(lens) * W]
        bt = torch.from_numpy(bt.reshape(len(lens), W).astype(np.int32))
        bt[0] = 0                                   # zombie row
        bt, ln = bt.to(dev), torch.from_numpy(lens).to(dev)
        qdt = torch.float32 if kv == "float32" else torch.bfloat16
        q = _rand(rng, (len(lens), Hq, D), D ** -0.5).to(dev, qdt)
        got = flash_decode_paged(q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                                 kv_tile_blocks=T, split_k=S)
        torch.cuda.synchronize()
        want = paged_decode_split_ref(q, kp, vp, bt, ln, k_scale=ks,
                                      v_scale=vs, kv_tile_blocks=T,
                                      split_k=S)
        err = (got.float() - want.float()).abs().max().item()
        tol = F32_ATOL if qdt == torch.float32 else BF16_ATOL
        check(err <= tol, f"decode kernel {kv} T={T} S={S}: err {err}")
        check(bool(torch.all(got[0] == 0)), "decode kernel: zombie row")
        worst[("decode", kv)] = max(worst.get(("decode", kv), 0.0), err)
    for kv, C, pos0 in [("bfloat16", 64, 0), ("bfloat16", 64, 768),
                        ("bfloat16", 256, 0), ("bfloat16", 256, 768),
                        ("int8", 256, 768), ("float32", 64, 768)]:
        W = -(-(pos0 + C) // BS)
        kp, vp, ks, vs = _pools(rng, W + 1, Hkv, BS, D, kv, dev)
        bt = torch.from_numpy(rng.permutation(np.arange(1, W + 1))
                              .astype(np.int32)[None]).to(dev)
        p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
        qdt = torch.float32 if kv == "float32" else torch.bfloat16
        q = _rand(rng, (1, Hq, C, D), D ** -0.5).to(dev, qdt)
        got = flash_prefill_paged(q, kp, vp, bt, p0, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = paged_prefill_ref(q, kp, vp, bt, p0, k_scale=ks, v_scale=vs)
        err = (got.float() - want.float()).abs().max().item()
        tol = F32_ATOL if qdt == torch.float32 else BF16_ATOL
        check(err <= tol, f"prefill kernel {kv} C={C} pos0={pos0}: "
                          f"err {err}")
        worst[("prefill", kv)] = max(worst.get(("prefill", kv), 0.0), err)
    for (name, kv), err in sorted(worst.items()):
        print(f"[3] {name} kernel vs plain, {kv}: max |err| {err:.3g}")


def _drive(eng, prompts, max_new):
    """Submit, step to the end with a sync per step. Returns the results,
    the wall time, the decode-only step times (steps that ran no prefill
    work) and this drive's decode steps and prefill chunks."""
    import torch
    handles = [eng.submit(p, max_new) for p in prompts]
    steps0 = (eng.metrics.decode_steps, eng.metrics.prefill_chunks)
    decode_ms = []
    t0 = time.perf_counter()
    while eng.sched.has_work():
        before = (eng.metrics.prefills, eng.metrics.prefill_chunks)
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if (eng.metrics.prefills, eng.metrics.prefill_chunks) == before:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    eng.drain()
    wall = time.perf_counter() - t0
    res = eng.pop_finished()
    return ([res[h.req_id] for h in handles], wall, decode_ms,
            eng.metrics.decode_steps - steps0[0],
            eng.metrics.prefill_chunks - steps0[1])


def _reset_counts():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    flash_decode_paged.launches = 0
    flash_decode_paged_single.launches = 0
    flash_prefill_paged.launches = 0
    flash_prefill_paged.launches_tc = 0
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    flash_attention.launches_tc = 0
    flash_attention_bwd.launches_tc = 0
    flash_decode.launches = 0
    flash_decode.launches_bulk = 0
    softermax_rows.launches = 0
    softermax_rows.launches_reg = 0
    softermax_quant_rows.launches = 0
    softermax_quant_rows.launches_reg = 0


def _all_counts():
    """(K1, K2, K3, K4, K5, K6, K7) launch counts."""
    from repro_torch.kernels.flash_decode import flash_decode
    return (*_counts(), *_flash_counts(), flash_decode.launches,
            *_softermax_counts())


def _route_counts():
    """(K5 on the bulk-copy route, K6 on the register route, K7 on the
    register route) launches."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    return (flash_decode.launches_bulk, softermax_rows.launches_reg,
            softermax_quant_rows.launches_reg)


def _softermax_counts():
    """(K6, K7) launch counts."""
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    return softermax_rows.launches, softermax_quant_rows.launches


def _flash_counts():
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    return flash_attention.launches, flash_attention_bwd.launches


def _flash_tc_counts():
    """(K3, K4) launches on the tensor-core route alone."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    return flash_attention.launches_tc, flash_attention_bwd.launches_tc


def _counts():
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    return flash_decode_paged.launches, flash_prefill_paged.launches


def phase_engine_parity(dev):
    """Reduced llama3.2-3b, float32: the card's engine against the CPU's."""
    import numpy as np
    import torch
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine, check_invariants
    cfg = reduce_config(get_config("llama3.2-3b"))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (13, 21, 9, 30)]
    for chunk, kv in ((0, None), (8, None), (8, "int8"), (0, "int8")):
        kw = dict(block_size=8, num_blocks=40, max_batch=4, max_len=64,
                  prefill_chunk=chunk, kv_dtype=kv)
        streams = {}
        for d in ("cpu", dev):
            eng = ContinuousEngine(cfg, params, device=d, **kw)
            _reset_counts()
            res, _, _, n_dec, n_chunk = _drive(eng, prompts, 8)
            k1, k2 = _counts()
            check_invariants(eng.pool, eng.prefix_cache)
            streams[str(d)] = [r.tokens for r in res]
            if d != "cpu":
                check(k1 == cfg.n_layers * n_dec,
                      f"decode launches {k1} != {cfg.n_layers} x {n_dec}")
                check(k2 == cfg.n_layers * n_chunk,
                      f"prefill launches {k2} != {cfg.n_layers} x "
                      f"{n_chunk}")
                check(k1 > 0 and (k2 > 0) == (chunk > 0),
                      "a kernel of the path did not launch")
            else:
                check(_counts() == (0, 0), "the CPU engine launched a kernel")
        check(streams["cpu"] == streams[str(dev)],
              f"chunk={chunk} kv={kv}: card and CPU greedy streams differ: "
              f"{streams}")
        print(f"[4] reduced llama3.2-3b f32 chunk={chunk} kv={kv or 'auto'}:"
              f" card == cpu greedy streams, launches decode={k1} "
              f"prefill={k2}")

    # one-shot prefill through the flash-attention kernel (K3)
    fcfg = cfg.replace(attention_impl="flash")
    kw = dict(block_size=8, num_blocks=40, max_batch=4, max_len=64)
    streams = {}
    for d in ("cpu", dev):
        eng = ContinuousEngine(fcfg, params, device=d, **kw)
        _reset_counts()
        p0 = eng.metrics.prefills
        res, _, _, n_dec, _ = _drive(eng, prompts, 8)
        k1, _ = _counts()
        k3, k4 = _flash_counts()
        check_invariants(eng.pool, eng.prefix_cache)
        streams[str(d)] = [r.tokens for r in res]
        n_pre = eng.metrics.prefills - p0
        if d != "cpu":
            check(eng.metrics.prefix_hit_tokens == 0,
                  "flash engine: unexpected prefix hit")
            check(k3 == cfg.n_layers * n_pre and k3 > 0 and k4 == 0,
                  f"flash engine: K3 launches {k3} != {cfg.n_layers} x "
                  f"{n_pre} one-shot prefills (K4 {k4})")
            check(k1 == cfg.n_layers * n_dec, f"flash engine: decode "
                                              f"launches {k1}")
        else:
            check((k1, k3, k4) == (0, 0, 0), "the CPU engine launched a "
                                             "kernel")
    check(streams["cpu"] == streams[str(dev)],
          f"flash one-shot: card and CPU greedy streams differ: {streams}")
    print(f"[4] reduced llama3.2-3b f32 attention_impl=flash one-shot: card "
          f"== cpu greedy streams, launches flash_attention={k3} "
          f"decode={k1}")


def _chunked_on_earlier_k2(cfg, params, prompts, max_new, dev, **kw):
    """The prompts through the paged engine with 256-token chunks, every
    K2 launch on the earlier (CUDA-core) kernel: the route rule is switched
    off for this run alone. Returns the greedy tokens (B, T) and the
    logits behind them by (prompt index, step)."""
    import numpy as np
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.kernels.flash_prefill_paged import ops as k2_ops
    from repro_torch.serve import ContinuousEngine
    rule = k2_ops.tc_route
    k2_ops.tc_route = lambda *args: False
    try:
        eng = ContinuousEngine(cfg, params, device=dev, prefill_chunk=256,
                               **kw)
        rec = _paged_logits(eng)
        _reset_counts()
        res = _drive(eng, prompts, max_new)[0]
        k2, k2_tc = _counts()[1], flash_prefill_paged.launches_tc
    finally:
        k2_ops.tc_route = rule
    check(k2 > 0 and k2_tc == 0, f"chunked-256 on the earlier K2 kernel: "
                                 f"launches {k2}, {k2_tc} on the tensor "
                                 f"cores")
    logits = {(i, t): rec[r.req_id, t] for i, r in enumerate(res)
              for t in range(max_new)}
    return np.array([r.tokens for r in res]), logits


def _stream_share(a, b):
    """Share of equal greedy tokens and of equal streams of two runs."""
    return float((a == b).mean()), int((a == b).all(axis=1).sum())


def phase_full_width(dev):
    """Full-width llama3.2-3b in bf16: one-shot, chunked, shared-prefix
    resubmit, int8 pool; every K2 launch of the bf16 chunked runs on the
    tensor-core route, of the int8 run on the earlier kernel. Then the
    chunked run profiled (K2's share of its device time) and once more on
    the earlier K2 kernel, the greedy streams of the three runs compared.
    Under the reference's init the logits are decisive at every step and
    flip between any two summation orders (PERF.md), so the shares
    are read, not gated; phase 13's weights gate chunked against static
    streams. Returns the chunked run's launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.models.lm import cast_matrix_params
    from repro_torch.models.registry import get_config, init_lm_params
    from repro_torch.serve import ContinuousEngine, check_invariants
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    params = cast_matrix_params(
        init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0)),
        cfg.compute_dtype_)
    torch.cuda.synchronize()
    print(f"[5] llama3.2-3b random weights (bf16) on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_new = 32
    base = dict(block_size=16, num_blocks=2048, max_batch=8,
                max_len=1024 + max_new)
    runs = [("one-shot", dict(prefill_chunk=0), prompts),
            ("chunked-256", dict(prefill_chunk=256), prompts),
            ("int8-chunked-256", dict(prefill_chunk=256, kv_dtype="int8"),
             prompts)]
    main_counts = None
    streams = {}
    for name, kw, ps in runs:
        eng = ContinuousEngine(cfg, params, device=dev, **base, **kw)
        passes = [(name, ps)]
        if name == "chunked-256":
            # shared-prefix resubmit: half of each prompt plus a new tail
            passes.append(("prefix-resubmit", [
                np.concatenate([p[:len(p) // 2 + 3],
                                rng.integers(1, cfg.vocab_size, 40)
                                .astype(np.int32)]) for p in ps]))
        for label, batch in passes:
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            hits0 = eng.metrics.prefix_hit_tokens
            res, wall, dec_ms, n_dec, n_chunk = _drive(eng, batch, max_new)
            k1, k2 = _counts()
            k2_tc = flash_prefill_paged.launches_tc
            want_tc = 0 if "int8" in label else k2
            check(k2_tc == want_tc, f"{label}: {k2_tc} of {k2} K2 launches "
                                    f"on the tensor-core route, not "
                                    f"{want_tc}")
            check(all(len(r.tokens) == max_new for r in res),
                  f"{label}: a request did not finish with {max_new} tokens")
            check_invariants(eng.pool, eng.prefix_cache)
            hits = eng.metrics.prefix_hit_tokens - hits0
            check(k1 == cfg.n_layers * n_dec and k1 > 0,
                  f"{label}: decode launches {k1}")
            check(k2 == cfg.n_layers * n_chunk and
                  (k2 > 0) == bool(eng.prefill_chunk),
                  f"{label}: prefill launches {k2}")
            if label == "prefix-resubmit":
                check(hits > 0 and eng.metrics.cow_copies > 0,
                      "prefix-resubmit: no prefix hit / copy-on-write")
            toks = sum(len(r.tokens) for r in res)
            ttft = np.array([r.ttft for r in res]) * 1e3
            print(f"[5] {label}: {len(res)} requests x {max_new} tokens, "
                  f"{toks / wall:.1f} tok/s ({wall:.2f}s incl. prefill), "
                  f"TTFT p50 {np.median(ttft):.0f} ms max {ttft.max():.0f} "
                  f"ms (host stamps), "
                  f"{np.mean(dec_ms):.2f} ms per decode step "
                  f"(n={len(dec_ms)}), peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                  f"prefix hits {hits} tokens, launches "
                  f"decode={k1} prefill={k2} (tensor cores {k2_tc})")
            if label == "chunked-256":
                main_counts = (k1, k2)
            if label in ("one-shot", "chunked-256"):
                streams[label] = np.array([r.tokens for r in res])
        del eng
        torch.cuda.empty_cache()

    # K2's share of the chunked run's device time
    eng = ContinuousEngine(cfg, params, device=dev, **base,
                           prefill_chunk=256)
    print("[5] " + step_profile(lambda: _drive(eng, prompts, max_new), 1,
                                "chunked-256 run (one run)",
                                watch=("paged_prefill_tc_kernel",)))
    del eng
    # the same run on the earlier K2 kernel: the tensor-core route leaves
    # the one-shot and the chunked streams as (un)equal as the earlier
    # kernel does
    earlier = _chunked_on_earlier_k2(cfg, params, prompts, max_new, dev,
                                     **base)[0]
    one, tc = streams["one-shot"], streams["chunked-256"]
    for a, b, what in ((one, tc, "one-shot vs chunked-256 (tensor cores)"),
                       (one, earlier, "one-shot vs chunked-256 (earlier K2 "
                                      "kernel)"),
                       (tc, earlier, "chunked-256, tensor cores vs earlier "
                                     "K2 kernel")):
        share, n_eq = _stream_share(a, b)
        print(f"[5] {what}: {share:.3f} of greedy tokens equal, "
              f"{n_eq}/{len(a)} streams equal (reference init: read, not "
              f"gated)")
    del streams

    # where a decode step's time goes: a profiled window once every
    # request is decoding
    eng = ContinuousEngine(cfg, params, device=dev, **base)
    for p in prompts:
        eng.submit(p, max_new)
    while eng.sched.waiting or eng.metrics.decode_steps < 1 or any(
            r.state == "prefill" for r in eng.sched.running):
        eng.step()
    print("[5] " + step_profile(eng.step, 5, "decode"))
    while eng.sched.has_work():
        eng.step()
    eng.drain()
    return main_counts


def step_profile(step, n_steps: int, label: str, watch=()) -> str:
    """Device-busy share and kernel time by name over ``n_steps`` calls of
    ``step``, from the profiler's CUDA activity; with ``watch`` (kernel-name
    prefixes), also those kernels' summed time and share of the busy
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("<")[0].split("(")[0]
            kern[name] = kern.get(name, 0.0) + e.time_range.elapsed_us()
    if not kern:
        return f"{label} profile: device time not measured (no CUDA events)"
    busy = sum(kern.values()) / 1e3 / n_steps
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    line = (f"{label} profile over {n_steps} steps: "
            f"{wall * 1e3 / n_steps:.2f} ms per step, device busy "
            f"{busy:.2f} ms per step "
            f"({100 * busy / (wall * 1e3 / n_steps):.0f}%), by kernel (ms "
            f"per step): " + ", ".join(f"{k} {v / 1e3 / n_steps:.3f}"
                                       for k, v in top))
    if watch:
        w = sum(v for k, v in kern.items()
                if k.startswith(tuple(watch))) / 1e3 / n_steps
        line += (f"; {' + '.join(watch)}: {w:.3f} ms per step "
                 f"({100 * w / busy:.1f}% of busy)")
    return line


def _time_ms(fn, flush, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches, L2 flushed
    before each (the serving path reads every layer's pool cold). A device
    wait of ~0.5 ms after the flush keeps the card busy while the host
    enqueues ``fn``, so the host's own time stays out of the interval."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


def phase_kernel_times(dev, main_counts, n_layers):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode_paged import (flash_decode_paged,
                                                        gather_kv,
                                                        paged_decode_ref)
    from repro_torch.kernels.flash_prefill_paged import (flash_prefill_paged,
                                                         paged_prefill_ref)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill_paged import ops as k2_ops
    from repro_torch.kernels.parity import parity_error, tolerance
    rng = np.random.default_rng(1)
    Hq, Hkv, D, BS = 24, 8, 128, 16
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = []

    # K1: B = 8 rows of length 1024, T = 1, split 1, bf16 pool
    B, L = 8, 1024
    W = L // BS
    kp, vp, _, _ = _pools(rng, B * W + 1, Hkv, BS, D, "bfloat16", dev)
    bt = torch.from_numpy(rng.permutation(np.arange(1, B * W + 1))
                          .reshape(B, W).astype(np.int32)).to(dev)
    ln = torch.full((B,), L, dtype=torch.int32, device=dev)
    q = _rand(rng, (B, Hq, D), D ** -0.5).to(dev, torch.bfloat16)
    saved = flash_decode_paged.launches
    got = flash_decode_paged(q, kp, vp, bt, ln)
    err = (got.float() - paged_decode_ref(q, kp, vp, bt, ln).float()) \
        .abs().max().item()
    ms = _time_ms(lambda: flash_decode_paged(q, kp, vp, bt, ln), flush)
    plain = _time_ms(lambda: paged_decode_ref(q, kp, vp, bt, ln), flush)
    flash_decode_paged.launches = saved     # timing launches do not count
    nbytes = (2 * B * L * Hkv * D * 2 + 2 * q.numel() * 2 + bt.numel() * 4
              + B * 4)
    flops = 4 * B * Hq * L * D
    out.append(_row("flash_decode_paged", "flash_decode_paged.cu",
                    "src/repro/kernels/flash_decode_paged/"
                    "flash_decode_paged.py:150", main_counts[0], n_layers,
                    err, ms, plain, nbytes, flops))

    # K2: one 256-token chunk at pos0 = 768, bf16 pool: the tensor-core
    # route, the earlier kernel on the same inputs, the int8 pool (earlier
    # kernel) and SDPA on K/V gathered beforehand (a yardstick only: no
    # PyTorch call computes paged attention)
    C, pos0 = 256, 768
    W = (pos0 + C) // BS
    kp, vp, _, _ = _pools(rng, W + 1, Hkv, BS, D, "bfloat16", dev)
    bt = torch.from_numpy(rng.permutation(np.arange(1, W + 1))
                          .astype(np.int32)[None]).to(dev)
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    q = _rand(rng, (1, Hq, C, D), D ** -0.5).to(dev, torch.bfloat16)
    saved = flash_prefill_paged.launches, flash_prefill_paged.launches_tc
    got = flash_prefill_paged(q, kp, vp, bt, p0)
    check(flash_prefill_paged.launches_tc == saved[1] + 1,
          "K2 phase-6 shape: not on the tensor-core route")
    want = paged_prefill_ref(q, kp, vp, bt, p0)
    err, held = parity_error(got, want)
    tol = tolerance(torch.bfloat16)
    check(held <= tol, f"K2 tensor-core route: max |err| {err}, checked "
                       f"error {held} > {tol}")

    def earlier_k2(*pools):
        return k2_ops._launch(q, *pools[:2], bt, p0, *pools[2:], True, 1,
                              tc=False)[0]

    err_early = parity_error(earlier_k2(kp, vp, None, None), want)[0]
    ms = _time_ms(lambda: flash_prefill_paged(q, kp, vp, bt, p0), flush)
    earlier = _time_ms(lambda: earlier_k2(kp, vp, None, None), flush)
    plain = _time_ms(lambda: paged_prefill_ref(q, kp, vp, bt, p0), flush)
    ms2 = _time_ms(lambda: flash_prefill_paged(q, kp, vp, bt, p0), flush)
    host = _host_ms(lambda: flash_prefill_paged(q, kp, vp, bt, p0))
    # of which the C entry alone: three tensor maps encoded, the launch
    out_c = torch.empty_like(q)
    c_args = [build.ptr(t) for t in (q, kp, vp, bt, p0, out_c)] + [
        1, Hq, Hkv, C, D, BS, W, W + 1, 1, build.stream_ptr(q.device)]
    host_c = _host_ms(lambda: build.check(
        build.load_library().smx_paged_prefill_tc(*c_args), "K2 C entry"))
    # the int8 pool at the same shape: the earlier kernel's route
    kq, vq, ks, vs = _pools(rng, W + 1, Hkv, BS, D, "int8", dev)
    tc0 = flash_prefill_paged.launches_tc
    got8 = flash_prefill_paged(q, kq, vq, bt, p0, k_scale=ks, v_scale=vs)
    check(flash_prefill_paged.launches_tc == tc0,
          "K2 int8 pool: took the tensor-core route")
    err8, held8 = parity_error(got8, paged_prefill_ref(
        q, kq, vq, bt, p0, k_scale=ks, v_scale=vs))
    check(held8 <= tol, f"K2 int8 pool: {err8} ({held8})")
    int8_ms = _time_ms(lambda: flash_prefill_paged(
        q, kq, vq, bt, p0, k_scale=ks, v_scale=vs), flush)
    flash_prefill_paged.launches, flash_prefill_paged.launches_tc = saved
    # SDPA with scale ln 2 on the pre-gathered K/V and the positional mask
    kg, vg = gather_kv(kp, bt), gather_kv(vp, bt)
    mask = (torch.arange(W * BS, device=dev)[None] <=
            pos0 + torch.arange(C, device=dev)[:, None])

    def sdpa():
        return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask,
                                              scale=math.log(2),
                                              enable_gqa=True)

    sdpa_err = parity_error(sdpa(), got)[0]
    sdpa_ms = _time_ms(sdpa, flush)
    keys = sum(pos0 + i + 1 for i in range(C))   # causal: what the data needs
    nbytes = 2 * (pos0 + C) * Hkv * D * 2 + 2 * q.numel() * 2 + W * 4 + 4
    flops = 4 * Hq * keys * D
    print(f"[6] K2 at one 256-token chunk at pos0 {pos0} (Hq {Hq}, Hkv "
          f"{Hkv}, D {D}, BS {BS}, bf16): tensor-core route {ms:.4f} / "
          f"{ms2:.4f} ms, max |err| vs plain {err:.3g} (checked {held:.3g} "
          f"<= {tol}), {8 * Hq * keys * D / ms / 1e9:.1f} TFLOP/s of "
          f"tensor-core work (8·D per visible pair); earlier kernel on the "
          f"same inputs {earlier:.4f} ms (vs plain {err_early:.3g}); int8 "
          f"pool (earlier kernel) {int8_ms:.4f} ms (checked {held8:.3g}); "
          f"plain {plain:.4f} ms; SDPA on pre-gathered K/V (gather not "
          f"timed) {sdpa_ms:.4f} ms (vs K2 {sdpa_err:.3g}); wrapper host "
          f"enqueue {host * 1e3:.1f} us per call, of which the C entry "
          f"(three tensor maps encoded, the launch) {host_c * 1e3:.1f} us")
    row = _row("flash_prefill_paged", "flash_prefill_paged_tc.cu",
               "src/repro/kernels/flash_prefill_paged/"
               "flash_prefill_paged.py:136", main_counts[1], n_layers,
               err, ms, plain, nbytes, flops)
    row.update(earlier_ms=earlier, int8_earlier_ms=int8_ms,
               sdpa_pregathered_ms=sdpa_ms, host_enqueue_ms=host,
               host_c_entry_ms=host_c)
    out.append(row)
    return out


def _lse_err(m, d, pm, pd):
    """max |(m + log2 d) - (pm + log2 pd)|: the row statistics are fp32 in
    every dtype, and their log-sum is what the backward reads."""
    import torch
    return (m + torch.log2(d) - pm - torch.log2(pd)).abs().max().item()


def phase_flash_parity(dev):
    """K3 and K4 against their plain versions on the card, on both routes."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from repro_torch.kernels.parity import parity_error, tolerance
    worst, worst_lse, routes = {}, 0.0, {}
    # (B, Hkv, G, Sq, Sk, D)
    shapes = [(2, 2, 1, 77, 77, 128), (1, 2, 3, 50, 130, 128),
              (1, 8, 3, 200, 200, 128), (2, 1, 3, 33, 70, 64),
              (2, 2, 3, 77, 130, 16)]
    for shape in shapes:
        B, Hkv, G, Sq, Sk, D = shape
        rng = np.random.default_rng(Sq + Sk)
        for dtn in ("float32", "bfloat16"):
            dt = getattr(torch, dtn)

            def rand(*shp):
                return _rand(rng, shp).to(dev, dt)

            q = rand(B, Hkv * G, Sq, D) * D ** -0.5
            k, v = rand(B, Hkv, Sk, D), rand(B, Hkv, Sk, D)
            do = rand(B, Hkv * G, Sq, D)
            tol = tolerance(dt)
            for causal in (True, False):
                for intmax in (True, False):
                    tag = f"{shape} {dtn} causal={causal} intmax={intmax}"
                    tc0 = _flash_tc_counts()
                    o, m, d = flash_attention(q, k, v, causal=causal,
                                              intmax=intmax,
                                              return_stats=True)
                    torch.cuda.synchronize()
                    po, pm, pd = flash_attention_plain(
                        q, k, v, causal=causal, intmax=intmax,
                        return_stats=True)
                    errs = {"o": parity_error(o, po),
                            "lse": _lse_err(m, d, pm, pd)}
                    worst_lse = max(worst_lse, errs["lse"])
                    check(errs["o"][1] <= tol and errs["lse"] <= F32_ATOL,
                          f"K3 {tag}: {errs}")
                    if intmax:
                        check(bool(torch.equal(m, torch.ceil(m))),
                              f"K3 {tag}: IntMax m not integral")
                        check(bool(torch.equal(m, pm)),
                              f"K3 {tag}: IntMax m differs from plain")
                    grads = flash_attention_bwd(q, k, v, o, do, m, d,
                                                causal=causal)
                    torch.cuda.synchronize()
                    tc = [a - b for a, b in zip(_flash_tc_counts(), tc0)]
                    routes[shape, dtn] = tuple(
                        "tensor cores" if n else "CUDA cores" for n in tc)
                    want = (1, 2) if dtn == "bfloat16" else (0, 0)
                    check(tuple(tc) == want, f"{tag}: tensor-core launches "
                                             f"{tc}, want {want}")
                    plain = flash_attention_bwd_plain(q, k, v, o, do, m, d,
                                                      causal=causal)
                    for name, g, w in zip(("dq", "dk", "dv"), grads, plain):
                        check(g.dtype == w.dtype and g.shape == w.shape,
                              f"K4 {tag} {name}: dtype/shape")
                        errs[name] = parity_error(g, w)
                        check(errs[name][1] <= tol, f"K4 {tag}: {errs}")
                    for key in ("o", "dq", "dk", "dv"):
                        kern = "K3" if key == "o" else "K4"
                        w = worst.get((kern, dtn), (0.0, 0.0))
                        worst[kern, dtn] = (max(w[0], errs[key][0]),
                                            max(w[1], errs[key][1]))
    for (shape, dtn), (r3, r4) in routes.items():
        print(f"[7] {shape} {dtn}: K3 on the {r3}, K4 on the {r4}")
    for (kern, dtn), (err, held) in sorted(worst.items()):
        tol = tolerance(getattr(torch, dtn))
        print(f"[7] {kern} vs plain, {dtn}: max |err| {err:.3g}, checked "
              f"error {held:.3g} <= {tol} ({len(shapes) * 4} cases)")
    print(f"[7] K3 row statistics m + log2(d) vs plain: max |err| "
          f"{worst_lse:.3g} <= {F32_ATOL}; IntMax m equal to plain")
    return worst["K3", "float32"][0], worst["K4", "float32"][0]


def _train_run(cfg, params, tc, steps, data):
    """``steps`` train steps; per step (metrics as floats, seconds, K3 and K4
    launches), each step ending in a sync."""
    import torch
    from repro_torch.models.registry import model_fns
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    step = make_train_step(model_fns(cfg).loss, tc)
    opt = adamw.init_state(params)
    rows = []
    for _ in range(steps):
        batch = next(data)
        c0 = _flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c1 = _flash_counts()
        rows.append(({k: float(v) for k, v in m.items()}, dt,
                     (c1[0] - c0[0], c1[1] - c0[1])))
    return params, rows


def phase_train_parity(dev):
    """Reduced llama3.2-3b, flash, three steps: card against CPU."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_leaves, tree_map
    cfg = reduce_config(get_config("llama3.2-3b")).replace(
        attention_impl="flash")
    init = init_lm_params(cfg, torch.Generator().manual_seed(0))
    # lr 1e-4: AdamW's per-element normalization turns float32 gradient
    # noise into trajectory noise proportional to the step size
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=1e-4)
    out = {}
    for d in ("cpu", dev):
        _reset_counts()
        params = tree_map(lambda a: a.to(d, copy=True), init)
        data = SyntheticLMData(cfg.vocab_size, 32, 4, seed=0)
        out[str(d)] = _train_run(cfg, params, tc, 3, data)
    (cparams, crows), (gparams, grows) = out["cpu"], out[str(dev)]
    L = cfg.n_layers
    k3_per_step = (2 if cfg.remat == "full" else 1) * L
    for s, (c, g) in enumerate(zip(crows, grows)):
        for key in ("loss", "ce", "grad_norm", "lr"):
            rel = abs(g[0][key] - c[0][key]) / abs(c[0][key])
            check(rel <= 1e-4, f"train step {s} {key}: card {g[0][key]} "
                               f"cpu {c[0][key]}")
        check(c[2] == (0, 0), "the CPU training run launched a kernel")
        check(g[2] == (k3_per_step, 2 * L),
              f"train step {s}: launches K3/K4 {g[2]}")
    worst = 0.0
    for c, g in zip(tree_leaves(cparams), tree_leaves(gparams)):
        rel = (torch.linalg.vector_norm(g.cpu() - c) /
               torch.linalg.vector_norm(c)).item()
        worst = max(worst, rel)
    check(worst <= 1e-4, f"train: final parameters differ by {worst}")
    check(_flash_tc_counts() == (0, 0),
          "f32 training launched the tensor-core kernels")
    print(f"[8] reduced llama3.2-3b f32 flash, 3 steps: card == cpu within "
          f"1e-4 (losses {[round(r[0]['loss'], 5) for r in grows]}, grad "
          f"norms {[round(r[0]['grad_norm'], 4) for r in grows]}, worst "
          f"parameter leaf rel L2 {worst:.3g}), launches K3/K4 per step "
          f"{grows[0][2]}, all on the CUDA cores")
    return _flash_counts()


def _true_fan_in(params):
    """Rescale the attention projections of a stacked parameter tree, in
    place, to std 1/sqrt(true fan-in). The reference's init reads a
    matrix's fan-in from shape[-2], which for wq/wk/wv (d, H, dh) is the
    head count and for wo (H, dh, d) the head dim: at d 3072 those weights
    are 5-11x too large (a property of the reference, see ROADMAP Queue
    3)."""
    mixer = params["blocks"]["mixer"]
    for name in ("wq", "wk", "wv", "wo"):
        w = mixer[name]                               # stacked (L, ...)
        fan_in = w.shape[1] * (w.shape[2] if name == "wo" else 1)
        w.mul_(math.sqrt(w.shape[-2] / fan_in))
    return params


def phase_train_full_width(dev):
    """Full-width llama3.2-3b training: one chunked (plain) step, then three
    flash steps through train() from the same weights and batch."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TRAIN_4K, TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step, train
    base = get_config("llama3.2-3b")
    S, B = TRAIN_4K.seq_len, 1
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-4)
    torch.cuda.empty_cache()

    def init():
        """The model's own init, then the attention projections rescaled to
        their true fan-in: at full width the reference's init makes the
        fp32 gradient norm of one step overflow (``_true_fan_in``)."""
        t0 = time.perf_counter()
        p = _true_fan_in(model_fns(base).init(
            torch.Generator(device=dev).manual_seed(0)))
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    # one step with the plain chunked attention
    cfg = base.replace(attention_impl="chunked")
    params, t_init = init()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _, rows = _train_run(cfg, params, tc, 1,
                         SyntheticLMData(cfg.vocab_size, S, B, seed=0))
    chunked, t_chunked = rows[0][0], rows[0][1]
    peak_chunked = torch.cuda.max_memory_allocated()
    check(_flash_counts() == (0, 0), "chunked step launched K3/K4")
    del params
    torch.cuda.empty_cache()
    print(f"[9] llama3.2-3b fp32 master weights on the card in {t_init:.2f}s;"
          f" chunked step 0: loss {chunked['loss']:.5f} grad norm "
          f"{chunked['grad_norm']:.4f}, {t_chunked:.2f}s, peak memory "
          f"{peak_chunked / 2 ** 30:.2f} GiB")

    # three steps through K3 / K4, driven by train()
    cfg = base.replace(attention_impl="flash")
    params, _ = init()
    torch.cuda.reset_peak_memory_stats()
    inner = make_train_step(model_fns(cfg).loss, tc)
    rows = []

    def step(p, o, batch):
        c0 = _flash_counts() + _flash_tc_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = inner(p, o, batch)
        torch.cuda.synchronize()
        c1 = _flash_counts() + _flash_tc_counts()
        rows.append(({k: float(v) for k, v in m.items()},
                     time.perf_counter() - t0,
                     tuple(b - a for a, b in zip(c0, c1))))
        return p, o, m

    _reset_counts()
    out = train(train_step=step, params=params,
                data=SyntheticLMData(cfg.vocab_size, S, B, seed=0), tc=tc,
                opt_state=adamw.init_state(params), log_every=1)
    k3, k4 = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    check(len(out["history"]) == 3 and np.isfinite(out["history"]).all(),
          f"full-width flash: losses {out['history']}")
    for s, (m, dt, (a, b, a_tc, b_tc)) in enumerate(rows):
        check(np.isfinite(m["grad_norm"]), f"step {s}: grad norm {m}")
        check((a, b) == (2 * L, 2 * L),
              f"step {s}: launches K3 {a}, K4 {b} != {2 * L}, {2 * L}")
        check((a_tc, b_tc) == (a, b),
              f"step {s}: K3/K4 launches {a}/{b}, of which on the tensor "
              f"cores {a_tc}/{b_tc}")
    check((k3, k4) == (6 * L, 6 * L), f"launches K3 {k3} K4 {k4}")
    check(_flash_tc_counts() == (k3, k4),
          f"tensor-core launches {_flash_tc_counts()} != {(k3, k4)}")
    rel = abs(rows[0][0]["loss"] - chunked["loss"]) / abs(chunked["loss"])
    check(rel <= 2e-2, f"flash step-0 loss {rows[0][0]['loss']} vs chunked "
                       f"{chunked['loss']}")
    # the loss is dominated by the tied logits' scale; the gradient norm
    # reads every layer's attention backward
    rel_gn = abs(rows[0][0]["grad_norm"] - chunked["grad_norm"]) / \
        chunked["grad_norm"]
    check(rel_gn <= 1e-3, f"flash step-0 grad norm {rows[0][0]['grad_norm']}"
                          f" vs chunked {chunked['grad_norm']}")
    for s, (m, dt, (a, b, a_tc, b_tc)) in enumerate(rows):
        print(f"[9] flash step {s}: loss {m['loss']:.5f} grad norm "
              f"{m['grad_norm']:.4f} lr {m['lr']:.3g}, {dt:.3f}s "
              f"({B * S / dt:.0f} tokens/s), launches K3 {a} K4 {b}, on "
              f"the tensor cores K3 {a_tc} K4 {b_tc}")
    print(f"[9] full-width flash vs chunked step 0: loss rel diff {rel:.3g} "
          f"<= 2e-2, grad norm rel diff {rel_gn:.3g} <= 1e-3; flash peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches over 3 "
          f"steps K3 {k3} K4 {k4}")
    # where a step's time goes: one more step, profiled, after the counts
    # were read
    state = [out["params"], out["opt_state"]]
    batch = next(SyntheticLMData(cfg.vocab_size, S, B, seed=1))

    def profiled():
        state[0], state[1], _ = inner(state[0], state[1], batch)

    print("[9] " + step_profile(profiled, 1, "training step", watch=(
        "flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
        "flash_bwd_dq_tc_kernel")))
    del out, params, state
    torch.cuda.empty_cache()
    return (k3, k4)


def _ptxas_kernels(report, sources):
    """(kernel, registers, spill line) of each kernel ptxas compiled from
    ``sources``."""
    out = []
    for sec in report.split("== ")[1:]:
        if sec.split("\n", 1)[0].strip() not in sources:
            continue
        name = spill = None
        for line in sec.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                short = re.search(r"(decode_bulk_kernel|softermax_rows_reg_"
                                  r"kernel|softermax_quant_reg_kernel)I"
                                  r"(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E",
                                  name)
                if short:
                    kern, dt, a, b = short.groups()
                    name = (f"{kern}<{'bf16' if dt != 'f' else 'f32'}, {a}, "
                            f"{b}>")
                for short in ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel",
                              "flash_bwd_dq_tc_kernel",
                              "paged_prefill_tc_kernel"):
                    if short in name:
                        dp = name.split("ILi")[1].split("E")[0]
                        name = f"{short}<{dp}>"
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line and name:
                regs = line.split("Used ")[1].split(" registers")[0]
                out.append((name, int(regs), spill))
                name = None
    return out


def phase_flash_times(dev, counts, f32_counts, f32_errs, n_layers):
    """K3 / K4 at the full-width training shape, causal: the tensor-core
    kernels (bf16, the training path) beside the CUDA-core kernels on the
    same inputs (their earlier route), SDPA and the bounds; then the
    CUDA-core kernels on their own route (f32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain, ops)
    from repro_torch.kernels.parity import parity_error, tolerance
    rng = np.random.default_rng(2)
    B, Hq, Hkv, S, D = 1, 24, 8, 4096, 128
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    pairs = S * (S + 1) // 2 * Hq                  # causal, Sq = Sk

    def inputs(dt):
        return (_rand(rng, (B, Hq, S, D), D ** -0.5).to(dev, dt),
                _rand(rng, (B, Hkv, S, D)).to(dev, dt),
                _rand(rng, (B, Hkv, S, D)).to(dev, dt),
                _rand(rng, (B, Hq, S, D)).to(dev, dt))

    # the library yardstick: SDPA with scale ln 2 is the base-2 softmax of
    # the pre-scaled scores (the normalization ignores the max it subtracts)
    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              scale=math.log(2),
                                              enable_gqa=True)

    def library(q, k, v, do):
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        lo = sdpa(ql, kl, vl)
        return (_time_ms(lambda: sdpa(q, k, v), flush, iters=10),
                _time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                     retain_graph=True),
                         flush, iters=10))

    def nbytes(el):
        """What the function moves: q, k, v in, o and (m, d) out; q, k, v,
        o, dO, (m, d) in and dq, dk, dv out in the inputs' dtype."""
        qb, kvb = B * Hq * S * D * el, B * Hkv * S * D * el
        stats = 2 * B * Hq * S * 4
        return 2 * qb + 2 * kvb + stats, 4 * qb + 4 * kvb + stats

    saved = _flash_counts() + _flash_tc_counts()
    q, k, v, do = inputs(torch.bfloat16)
    o, m, d = flash_attention(q, k, v, return_stats=True)
    po, pm, pd = flash_attention_plain(q, k, v, return_stats=True)
    err3, held3 = parity_error(o, po)
    lse3 = _lse_err(m, d, pm, pd)
    grads = flash_attention_bwd(q, k, v, o, do, m, d)
    plain = flash_attention_bwd_plain(q, k, v, o, do, m, d)
    err4, held4 = map(max, zip(*(parity_error(g, w) for g, w in zip(grads,
                                                                    plain))))
    tol = tolerance(torch.bfloat16)
    check(held3 <= tol and lse3 <= F32_ATOL and held4 <= tol,
          f"full-width shape: K3 o {err3} ({held3}), m + log2(d) {lse3}; "
          f"K4 {err4} ({held4})")
    check(bool(torch.equal(m, torch.ceil(m))), "K3: IntMax m not integral")
    check(bool(torch.equal(m, pm)), "K3: IntMax m differs from plain")
    ms3 = _time_ms(lambda: flash_attention(q, k, v, return_stats=True),
                   flush, iters=10)
    ms4 = _time_ms(lambda: flash_attention_bwd(q, k, v, o, do, m, d), flush,
                   iters=10)
    plain3 = _time_ms(lambda: flash_attention_plain(q, k, v,
                                                    return_stats=True),
                      flush, iters=3)
    plain4 = _time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, m,
                                                        d),
                      flush, iters=3)
    # the CUDA-core kernels on the same bf16 inputs: K3/K4's earlier route
    delta = torch.sum(do.float() * o.float(), dim=-1).contiguous()
    core3 = _time_ms(lambda: ops._forward_cuda_cores(q, k, v, True, True),
                     flush, iters=5)
    core4 = _time_ms(lambda: ops._backward_cuda_cores(q, k, v, do, m, d,
                                                      delta, True),
                     flush, iters=3)
    lib_err = parity_error(sdpa(q, k, v), o)[0]
    lib3, lib4 = library(q, k, v, do)
    bytes3, bytes4 = nbytes(2)
    print(f"[10] full-width shape, bf16, tensor cores: K3 vs plain max "
          f"|err| {err3:.3g} (held {held3:.3g} <= {tol}), m + log2(d) "
          f"{lse3:.3g} <= {F32_ATOL}, IntMax m equal to plain; K4 vs plain "
          f"{err4:.3g} (held {held4:.3g} <= {tol}); SDPA vs K3 {lib_err:.3g}")
    print(f"[10] K3 {ms3:.4f} ms: {4 * pairs * D / ms3 / 1e9:.1f} TFLOP/s "
          f"of the function (4·D per visible pair), "
          f"{8 * pairs * D / ms3 / 1e9:.1f} on the tensor cores (8·D); K4 "
          f"{ms4:.4f} ms: {10 * pairs * D / ms4 / 1e9:.1f} TFLOP/s of the "
          f"function (10·D), {26 * pairs * D / ms4 / 1e9:.1f} on the tensor "
          f"cores (26·D); CUDA-core kernels on the same inputs K3 "
          f"{core3:.4f} ms, K4 {core4:.4f} ms; SDPA {lib3:.4f} / "
          f"{lib4:.4f} ms")
    for name, regs, spill in _ptxas_kernels(
            build.ptxas_report(),
            ("flash_attention_tc.cu", "flash_backward_tc.cu")):
        print(f"[10] ptxas {name}: {regs} registers at launch (consumers "
              f"raise theirs to 232 by setmaxnreg), {spill}")
    rows = [
        _row("flash_attention", "flash_attention_tc.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:99",
             counts[0], 2 * n_layers, err3, ms3, plain3, bytes3,
             4 * pairs * D, lib3),
        _row("flash_attention_bwd", "flash_backward_tc.cu",
             "src/repro/kernels/flash_attention/flash_backward.py:119",
             counts[1], 2 * n_layers, err4, ms4, plain4, bytes4,
             10 * pairs * D, lib4)]   # s, dP, dV, dK, dQ: 2·D each
    rows[0]["earlier_ms"], rows[1]["earlier_ms"] = core3, core4

    # the CUDA-core kernels on their own route, f32 (phase 8's training);
    # their parity is phase 7's (the f32 gate is an absolute 1e-5, which
    # sums of 4096 rows in another order do not keep)
    q, k, v, do = inputs(torch.float32)
    o, m, d = flash_attention(q, k, v, return_stats=True)
    f3 = _time_ms(lambda: flash_attention(q, k, v, return_stats=True), flush,
                  iters=5)
    f4 = _time_ms(lambda: flash_attention_bwd(q, k, v, o, do, m, d), flush,
                  iters=3)
    fp3 = _time_ms(lambda: flash_attention_plain(q, k, v, return_stats=True),
                   flush, iters=2)
    fp4 = _time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, m, d),
                   flush, iters=2)
    fl3, fl4 = library(q, k, v, do)
    # timing and comparison launches do not count
    flash_attention.launches, flash_attention_bwd.launches = saved[:2]
    flash_attention.launches_tc, flash_attention_bwd.launches_tc = saved[2:]
    print(f"[10] CUDA-core kernels, f32 inputs: K3 {f3:.4f} ms, K4 "
          f"{f4:.4f} ms (plain {fp3:.2f} / {fp4:.2f}, SDPA {fl3:.4f} / "
          f"{fl4:.4f})")
    bytes3, bytes4 = nbytes(4)
    for name, src, line, n, err, ms, pl, nb, flops, lib in (
            ("flash_attention_f32", "flash_attention.cu",
             "flash_attention.py:99", f32_counts[0], f32_errs[0], f3, fp3,
             bytes3, 4 * pairs * D, fl3),
            ("flash_attention_bwd_f32", "flash_backward.cu",
             "flash_backward.py:119", f32_counts[1], f32_errs[1], f4, fp4,
             bytes4, 10 * pairs * D, fl4)):
        rows.append(_row(name, src,
                         "src/repro/kernels/flash_attention/" + line, n,
                         n // 3, err, ms, pl, nb, flops, lib,
                         peak="float32"))      # phase 8 ran 3 steps
    return rows


def phase_decode_parity(dev):
    """K5 against its plain version on the card, at the main path's head
    geometry (Hkv 8, D 128)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import (bulk_tile_rows, decode_ref,
                                                  flash_decode)
    from repro_torch.kernels.parity import parity_error, tolerance
    saved = flash_decode.launches, flash_decode.launches_bulk
    lib = build.load_library()
    for D in (4, 8, 36, 40, 64, 128, 256):
        for elem in (2, 4):
            if D * elem % 16 == 0:
                check(lib.smx_decode_bulk_tile(D, elem) ==
                      bulk_tile_rows(D, elem),
                      f"K5 tile rows at D {D}, {elem}-byte cache")
    Hkv, D = 8, 128
    worst, n = {}, 0
    for S in (37, 1056):
        lens = [x for x in (1, 31, 32, 33, 127, 128, 129, S) if x <= S]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        for G in (1, 3, 4, 8):
            rng = np.random.default_rng(S + G)
            q = _rand(rng, (len(lens), G * Hkv, D), D ** -0.5)
            k = _rand(rng, (len(lens), Hkv, S, D))
            v = _rand(rng, (len(lens), Hkv, S, D))
            for dtn in ("float32", "bfloat16"):
                dt = getattr(torch, dtn)
                qd, kd, vd = (t.to(dev, dt) for t in (q, k, v))
                for intmax in (True, False):
                    bulk0 = flash_decode.launches_bulk
                    got = flash_decode(qd, kd, vd, ln, intmax=intmax)
                    torch.cuda.synchronize()
                    want = decode_ref(qd, kd, vd, ln, intmax=intmax)
                    err, held = parity_error(got, want)
                    check(got.dtype == dt and held <= tolerance(dt),
                          f"K5 S={S} G={G} {dtn} intmax={intmax}: max "
                          f"|err| {err}, held {held}")
                    check(flash_decode.launches_bulk == bulk0 + 1,
                          f"K5 S={S} G={G} {dtn}: not on the bulk route")
                    w = worst.get(dtn, (0.0, 0.0))
                    worst[dtn] = (max(w[0], err), max(w[1], held))
                    n += 1
    # off the rule: a bf16 row of 72 bytes takes the earlier kernel
    rng = np.random.default_rng(36)
    lens = [1, 31, 129, 300]
    q36 = _rand(rng, (len(lens), 3 * Hkv, 36), 36 ** -0.5).to(dev,
                                                               torch.bfloat16)
    k36, v36 = (_rand(rng, (len(lens), Hkv, 300, 36)).to(dev, torch.bfloat16)
                for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    bulk0 = flash_decode.launches_bulk
    got = flash_decode(q36, k36, v36, ln)
    torch.cuda.synchronize()
    err36, held36 = parity_error(got, decode_ref(q36, k36, v36, ln))
    check(flash_decode.launches_bulk == bulk0 and
          held36 <= tolerance(torch.bfloat16),
          f"K5 bf16 D 36: bulk launches {flash_decode.launches_bulk - bulk0}"
          f", held {held36}")
    # comparison launches do not count
    flash_decode.launches, flash_decode.launches_bulk = saved
    for dtn, (err, held) in sorted(worst.items()):
        print(f"[11] K5 vs plain, {dtn}: max |err| {err:.3g}, checked error "
              f"{held:.3g} <= {tolerance(getattr(torch, dtn))} ({n // 2} "
              f"cases, all on the bulk-copy route)")
    print(f"[11] K5 bf16 D 36 (off the rule) on the earlier kernel: max "
          f"|err| {err36:.3g}, checked {held36:.3g}; tile rows equal to "
          f"the wrapper's mirror")


def phase_static_parity(dev):
    """Reduced llama3.2-3b, float32: the static engine on the card against
    the same engine on the CPU and the paged engine on the card."""
    import numpy as np
    import torch
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine, ServeEngine
    cfg = reduce_config(get_config("llama3.2-3b"))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (4, 20)).astype(np.int32)
    max_new = 10
    for kv, c in (("f32", cfg), ("int8", cfg.replace(opt_int8_kv=True))):
        streams = {}
        for d in ("cpu", dev):
            _reset_counts()
            res = ServeEngine(c, params, max_len=30, device=d).generate(
                prompts, max_new)
            counts = _all_counts()
            streams[str(d)] = res.tokens.tolist()
            want = (0, 0, 0, 0, c.n_layers * (max_new - 1)
                    if d != "cpu" and kv == "f32" else 0, 0, 0)
            check(counts == want, f"static {kv} on {d}: launches "
                                  f"K1-K7 {counts} != {want}")
        check(streams["cpu"] == streams[str(dev)],
              f"static {kv}: card and CPU greedy streams differ: {streams}")
        if kv == "f32":
            eng = ContinuousEngine(c, params, block_size=8, num_blocks=40,
                                   max_batch=4, max_len=32, device=dev)
            handles = [eng.submit(p, max_new) for p in prompts]
            res = eng.run()
            paged = [res[h.req_id].tokens for h in handles]
            check(paged == streams["cpu"],
                  f"static and paged greedy streams differ: {streams}, "
                  f"{paged}")
        print(f"[12] reduced llama3.2-3b static {kv}: card == cpu"
              f"{' == paged engine' if kv == 'f32' else ''} greedy streams,"
              f" K5 launches {counts[4]}")


class _StaticRecorder:
    """Wraps a ServeEngine's model steps: each step synced and timed on the
    host clock, its logits kept for the near-tie audit."""

    def __init__(self, eng):
        import torch
        self.eng, self.logits, self.prefill_ms, self.decode_ms = eng, [], 0, []

        def timed(fn, label):
            def run(*a):
                t0 = time.perf_counter()
                lg, cache = fn(*a)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if label == "prefill":
                    self.prefill_ms = ms
                else:
                    self.decode_ms.append(ms)
                self.logits.append(lg.clone())
                return lg, cache
            return run

        eng._prefill = timed(eng._prefill, "prefill")
        eng._decode = timed(eng._decode, "decode")

    def close(self):
        del self.eng._prefill, self.eng._decode


def _paged_logits(eng):
    """Keep the logits behind every greedy token the paged engine samples,
    by (request id, token index): a prefill joining decode samples token 0
    of the newest row, a decode step token n_generated of every row."""
    rec, greedy = {}, eng._greedy

    def keep(lg):
        occ = [(i, r) for i, r in enumerate(eng._rows) if r is not None]
        if lg.shape[0] == 1:
            req = next(r for _, r in occ if r.n_generated == 0)
            rec[req.req_id, 0] = lg[0].clone()
        else:
            for i, r in occ:
                rec[r.req_id, r.n_generated] = lg[i].clone()
        return greedy(lg)

    eng._greedy = keep
    return rec


def _near_tie_audit(static, paged, s_logits, p_logits, vocab):
    """The static and paged greedy streams of each request, token by token.
    At the first token that differs both engines saw the same context; the
    flip is excused as a near-tie when, in each engine's own logits, the two
    diverging tokens lie within ``band`` of each other, where ``band`` is
    twice the largest |logit difference| between the engines at the steps
    before any divergence (the noise of their two summation orders).
    Returns (share of equal tokens, report lines); raises on a decisive
    flip."""
    import torch
    B, T = static.shape
    first = []
    noise = 0.0
    for b in range(B):
        t = next((i for i in range(T) if static[b, i] != paged[b][i]), T)
        first.append(t)
        for i in range(t):
            d = (s_logits[i][b, :vocab] - p_logits[b, i][:vocab]).abs()
            noise = max(noise, d.max().item())
    band = 2 * noise
    lines = [f"logit noise between the engines before any divergence "
             f"{noise:.4g} (band {band:.4g})"]
    equal = sum(int(static[b, i] == paged[b][i]) for b in range(B)
                for i in range(T))
    for b, t in enumerate(first):
        if t == T:
            continue
        ls, lp = s_logits[t][b, :vocab], p_logits[b, t][:vocab]
        a, c = int(static[b, t]), int(paged[b][t])
        gap_s, gap_p = (ls[a] - ls[c]).item(), (lp[c] - lp[a]).item()
        top_s, top_p = (torch.topk(x, 2).values for x in (ls, lp))
        lines.append(
            f"request {b}: first differing token at step {t} (static {a}, "
            f"paged {c}); top-2 gap static {(top_s[0] - top_s[1]).item():.4g}"
            f" paged {(top_p[0] - top_p[1]).item():.4g}; gap of the two "
            f"tokens static {gap_s:.4g} paged {gap_p:.4g}; max |logit diff| "
            f"at the step {(ls - lp).abs().max().item():.4g}")
        check(gap_s <= band and gap_p <= band,
              f"request {b} step {t}: a flip at a decisive logit gap "
              f"({gap_s:.4g}, {gap_p:.4g} > band {band:.4g})")
    return equal / (B * T), lines


def phase_static_full_width(dev):
    """Full-width llama3.2-3b in bf16, static engine: bf16 and int8 caches,
    then the same prompts through the paged engine. Returns the bf16 run's
    K5 launches.

    The attention projections are rescaled to their true fan-in
    (``_true_fan_in``): under the reference's init the attention scores
    reach a spread of ~200 (log2 units), each head attends to its top key
    alone, and a one-rounding difference between two keys' scores switches
    the key, so two summation orders give decisively different logits (a
    run with that init failed the near-tie audit: PERF.md, PR 13)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.models.lm import cast_matrix_params
    from repro_torch.models.registry import get_config, init_lm_params
    from repro_torch.serve import ContinuousEngine, ServeEngine
    cfg = get_config("llama3.2-3b")
    L = cfg.n_layers
    torch.cuda.empty_cache()
    params = cast_matrix_params(_true_fan_in(
        init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0))),
        cfg.compute_dtype_)
    rng = np.random.default_rng(0)
    B, P, max_new = 8, 1024, 32
    max_len = P + max_new
    prompts = rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)
    out = {}
    for kv, c in (("bf16", cfg), ("int8", cfg.replace(opt_int8_kv=True))):
        eng = ServeEngine(c, params, max_len=max_len, device=dev)
        rec = _StaticRecorder(eng)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new)
        wall = time.perf_counter() - t0
        counts = _all_counts()
        bulk = _route_counts()[0]
        rec.close()
        want = (0, 0, 0, 0, L * (max_new - 1) if kv == "bf16" else 0, 0, 0)
        check(counts == want, f"static {kv}: launches K1-K7 {counts} != "
                              f"{want}")
        check(bulk == counts[4], f"static {kv}: {bulk} of {counts[4]} K5 "
                                 "launches on the bulk-copy route")
        check(res.tokens.shape == (B, max_new) and
              ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all(),
              f"static {kv}: tokens {res.tokens}")
        check(all(torch.isfinite(lg).all().item() for lg in rec.logits),
              f"static {kv}: non-finite logits")
        print(f"[13] static {kv} cache: {B} requests x {max_new} tokens, "
              f"{B * max_new / wall:.1f} tok/s ({wall:.2f}s incl. prefill "
              f"{rec.prefill_ms:.0f} ms), {np.mean(rec.decode_ms):.2f} ms "
              f"per decode step (n={len(rec.decode_ms)}, synced), K5 "
              f"launches {counts[4]} ({counts[4] / (max_new - 1):.0f} per "
              f"decode step; {bulk} on the bulk-copy route), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        # where a decode step's time goes: 5 profiled steps after a prefill
        lg, cache = eng._prefill(torch.as_tensor(prompts, device=dev))
        state = [eng._sample(lg, None, 0.0), cache]

        def step():
            lg, state[1] = eng._decode(state[0], state[1])
            state[0] = eng._sample(lg, None, 0.0)

        print(f"[13] static {kv} cache " + step_profile(step, 5, "decode"))
        out[kv] = (res.tokens, rec.logits, counts[4])
        del eng, cache, state
        torch.cuda.empty_cache()

    # the same prompts and weights through the paged engine, one-shot
    eng = ContinuousEngine(cfg, params, block_size=16,
                           num_blocks=B * (max_len // 16 + 1) + 1,
                           max_batch=B, max_len=max_len, device=dev)
    p_logits = _paged_logits(eng)
    handles = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    paged = [res[h.req_id].tokens for h in handles]
    p_logits = {(i, t): p_logits[h.req_id, t] for i, h in enumerate(handles)
                for t in range(max_new)}
    tokens, s_logits, k5 = out["bf16"]
    share, lines = _near_tie_audit(tokens, paged, s_logits, p_logits,
                                   cfg.vocab_size)
    n_equal = sum(tokens[b].tolist() == paged[b] for b in range(B))
    print(f"[13] static vs paged engine (bf16, one-shot prefill): "
          f"{share:.3f} of greedy tokens equal, {n_equal}/{B} streams "
          f"equal")
    for line in lines:
        print("[13] near-tie audit: " + line)
    del eng, p_logits

    # the same prompts through the paged engine in 256-token chunks (K2),
    # on the tensor-core route and on the earlier kernel, each held to the
    # static engine's streams by the near-tie audit
    kw = dict(block_size=16, num_blocks=B * (max_len // 16 + 1) + 1,
              max_batch=B, max_len=max_len)
    eng = ContinuousEngine(cfg, params, prefill_chunk=256, device=dev, **kw)
    rec = _paged_logits(eng)
    _reset_counts()
    res = _drive(eng, prompts, max_new)[0]
    k2, k2_tc = _counts()[1], flash_prefill_paged.launches_tc
    check(k2 == k2_tc == L * B * (P // 256),
          f"paged chunked-256: K2 launches {k2}, {k2_tc} on the tensor "
          f"cores")
    chunked = {"tensor cores": (
        np.array([r.tokens for r in res]),
        {(i, t): rec[r.req_id, t] for i, r in enumerate(res)
         for t in range(max_new)})}
    del eng, rec
    chunked["earlier K2 kernel"] = _chunked_on_earlier_k2(
        cfg, params, prompts, max_new, dev, **kw)
    for label, (toks, lg) in chunked.items():
        share, lines = _near_tie_audit(tokens, [list(t) for t in toks],
                                       s_logits, lg, cfg.vocab_size)
        n_equal = sum(tokens[b].tolist() == list(toks[b]) for b in range(B))
        print(f"[13] static vs paged engine (bf16, chunked-256, K2 on the "
              f"{label}): {share:.3f} of greedy tokens equal, {n_equal}/{B} "
              f"streams equal, K2 launches {k2}")
        for line in lines:
            print("[13] near-tie audit: " + line)
    del out, chunked, params
    torch.cuda.empty_cache()
    return k5


def phase_decode_times(dev, launches, n_layers):
    """K5 at the full-width decode shape: B 8, Hq 24, Hkv 8, 1056 cached
    rows, D 128, bf16."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (bulk_tile_rows, decode_ref,
                                                  flash_decode, ops,
                                                  split_lanes)
    from repro_torch.kernels.parity import parity_error, tolerance
    rng = np.random.default_rng(3)
    B, Hq, Hkv, S, D = 8, 24, 8, 1056, 128
    bf = torch.bfloat16
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    q = _rand(rng, (B, Hq, D), D ** -0.5).to(dev, bf)
    k = _rand(rng, (B, Hkv, S, D)).to(dev, bf)
    v = _rand(rng, (B, Hkv, S, D)).to(dev, bf)
    ln = torch.full((B,), S, dtype=torch.int32, device=dev)
    saved = flash_decode.launches, flash_decode.launches_bulk
    got = flash_decode(q, k, v, ln)
    check(flash_decode.launches_bulk == saved[1] + 1,
          "K5 full-width shape: not on the bulk-copy route")
    err, held = parity_error(got, decode_ref(q, k, v, ln))
    check(held <= tolerance(bf), f"K5 full-width shape: {err} ({held})")
    # the earlier kernel on the same inputs (its route before the bulk copy)
    early, _ = ops._launch(q, k, v, ln, True, bulk=False)
    err_early = parity_error(early, got)[0]
    ms = _time_ms(lambda: flash_decode(q, k, v, ln), flush)
    earlier = _time_ms(lambda: ops._launch(q, k, v, ln, True, bulk=False),
                       flush)
    plain = _time_ms(lambda: decode_ref(q, k, v, ln), flush)
    ms2 = _time_ms(lambda: flash_decode(q, k, v, ln), flush)
    # timing launches do not count
    flash_decode.launches, flash_decode.launches_bulk = saved

    # the library yardstick: SDPA with scale ln 2 is the base-2 softmax of
    # the pre-scaled scores (IntMax changes no result in exact arithmetic;
    # every length is the cache's)
    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, scale=math.log(2), enable_gqa=True)

    lib_err = parity_error(sdpa()[:, :, 0], got)[0]
    lib = _time_ms(sdpa, flush)
    nbytes = 2 * B * Hkv * S * D * 2 + 2 * q.numel() * 2 + B * 4
    lane_rows, n = split_lanes(B * Hkv, S, bulk_tile_rows(D, 2))
    print(f"[14] full-width decode shape, bf16: K5 vs plain max |err| "
          f"{err:.3g} (held {held:.3g} <= {tolerance(bf)}); SDPA vs K5 "
          f"{lib_err:.3g}; earlier kernel vs K5 {err_early:.3g}; {n} split "
          f"lanes of {lane_rows} rows")
    print(f"[14] K5 bulk-copy route {ms:.4f} / {ms2:.4f} ms, earlier kernel "
          f"{earlier:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms")
    row = _row("flash_decode", "flash_decode_bulk.cu",
               "src/repro/kernels/flash_decode/flash_decode.py:71",
               launches, n_layers, err, ms, plain, nbytes,
               4 * B * Hq * S * D, lib)
    row["earlier_ms"] = earlier
    return [row]


def _score_rows(shape, seed, scale, dev):
    """Scores (rows, V) with a fully masked row, a half-masked row, a row
    whose max is <= -17 and a row masked up front: masked and pad entries
    enter the fixed-point PowSum."""
    import numpy as np
    import torch
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x *= scale
    if shape[0] > 3:
        x[0] = -1e9
        x[1, shape[1] // 2:] = -1e9
        x[2] -= 30.0
        x[3, :shape[1] // 3] = -1e9
    return torch.from_numpy(x).to(dev)


# K6 / K7 row shapes: the CPU tests', V off the 16-wide slice, and the two
# full-width shapes (llama3.2-3b prefill: 8 x 24 x 1024 rows of 1024;
# bert-base at seq 512, batch 16: 16 x 12 x 512 rows of 512)
PREFILL_ROWS = (8 * 24 * 1024, 1024)
BERT_ROWS = (16 * 12 * 512, 512)


def phase_softermax_parity(dev):
    """K6 and K7 against their plain versions on the card."""
    import torch
    from repro_torch.kernels.parity import parity_error, tolerance
    from repro_torch.kernels.softermax import (REG_CAP, softermax_rows,
                                               softermax_rows_ref)
    from repro_torch.kernels.softermax_quant import (softermax_quant_plain,
                                                     softermax_quant_ref,
                                                     softermax_quant_rows)
    saved = _softermax_counts(), _route_counts()
    # the route boundary (K6 and K7 share REG_CAP)
    shapes = [(4, 128), (8, 1024), (5, 300), (16, 64), (21, 130), (8, 37),
              (2, 16), (12, 200), (3, 1), PREFILL_ROWS, BERT_ROWS,
              (6, REG_CAP - 1), (6, REG_CAP), (6, REG_CAP + 1)]
    # the two-pass kernel's longer rows (K6 alone)
    k6_only = [(4, 4096), (4, 8192)]
    routes = {True: 0, False: 0}
    routes7 = {True: 0, False: 0}
    worst6, worst7, n7 = {}, 0.0, 0
    for shape in shapes + k6_only:
        x = _score_rows(shape, sum(shape), 4.0, dev)
        for dtn in ("float32", "bfloat16"):
            dt = getattr(torch, dtn)
            xd = x.to(dt)
            for intmax in (True, False):
                reg0 = softermax_rows.launches_reg
                got = softermax_rows(xd, intmax=intmax)
                torch.cuda.synchronize()
                reg = softermax_rows.launches_reg - reg0
                check(reg == int(shape[1] <= REG_CAP),
                      f"K6 {shape}: register-route launches {reg}")
                routes[bool(reg)] += 1
                want = softermax_rows_ref(xd.float(), intmax).to(dt)
                err, held = parity_error(got, want)
                check(held <= tolerance(dt) and
                      bool(torch.isfinite(got).all()),
                      f"K6 {shape} {dtn} intmax={intmax}: max |err| {err}, "
                      f"held {held}")
                w = worst6.get(dtn, (0.0, 0.0))
                worst6[dtn] = (max(w[0], err), max(w[1], held))
                del got, want
            if shape in k6_only:
                continue
            reg0 = softermax_quant_rows.launches_reg
            got = softermax_quant_rows(xd)
            torch.cuda.synchronize()
            reg = softermax_quant_rows.launches_reg - reg0
            check(reg == int(shape[1] <= REG_CAP),
                  f"K7 {shape}: register-route launches {reg}")
            routes7[bool(reg)] += 1
            check(bool(torch.equal(got, softermax_quant_plain(xd))),
                  f"K7 {shape} {dtn}: differs from softermax_quant_plain")
            ref_err = (got.float() - softermax_quant_ref(xd.float())) \
                .abs().max().item()
            check(ref_err <= 2 ** -7, f"K7 {shape} {dtn}: {ref_err} from "
                                      "softermax_fixed")
            worst7 = max(worst7, ref_err)
            n7 += 1
            del got, xd
        del x
        torch.cuda.empty_cache()
    # comparison launches do not count
    _set_softermax_counts(saved[0])
    _set_route_counts(saved[1])
    for dtn, (err, held) in sorted(worst6.items()):
        print(f"[15] K6 vs plain, {dtn}: max |err| {err:.3g}, checked error "
              f"{held:.3g} <= {tolerance(getattr(torch, dtn))} "
              f"({2 * len(shapes + k6_only)} cases)")
    print(f"[15] K6 routes: {routes[True]} cases on the register kernel (V "
          f"<= {REG_CAP}), {routes[False]} on the two-pass kernel")
    print(f"[15] K7 == softermax_quant_plain in all {n7} cases (f32, bf16; "
          f"up to {PREFILL_ROWS[0]} x {PREFILL_ROWS[1]}); max |K7 - "
          f"softermax_fixed| {worst7:.3g} <= 2^-7; {routes7[True]} cases on "
          f"the register kernel (V <= {REG_CAP}), {routes7[False]} on the "
          f"two-pass kernel")


def _set_softermax_counts(counts):
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    softermax_rows.launches, softermax_quant_rows.launches = counts


def _set_route_counts(counts):
    """Restore ``_route_counts()``."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.softermax import softermax_rows
    from repro_torch.kernels.softermax_quant import softermax_quant_rows
    (flash_decode.launches_bulk, softermax_rows.launches_reg,
     softermax_quant_rows.launches_reg) = counts


def _logit_list_audit(a_tokens, b_tokens, a_logits, b_logits, vocab):
    """The near-tie audit of two static engines' runs (token arrays and the
    per-step logits of each)."""
    B, T = a_tokens.shape
    p_logits = {(b, t): b_logits[t][b] for b in range(B) for t in range(T)}
    return _near_tie_audit(a_tokens, [r.tolist() for r in b_tokens],
                           a_logits, p_logits, vocab)


def phase_fixed_reduced(dev):
    """Reduced llama3.2-3b, float32, softermax_fixed: the static engine on
    the card against the CPU's and the paged engine's; then three QAT steps
    of reduced bert-base on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.serve import ServeEngine
    cfg = reduce_config(get_config("llama3.2-3b")).replace(
        softmax_impl="softermax_fixed")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (4, 20)).astype(np.int32)
    max_new = 10
    runs = {}
    for d in ("cpu", dev):
        eng = ServeEngine(cfg, params, max_len=30, device=d)
        rec = _StaticRecorder(eng)
        _reset_counts()
        res = eng.generate(prompts, max_new)
        counts = _all_counts()
        rec.close()
        want = (0, 0, 0, 0, 0, 0, 0) if d == "cpu" else \
            (0, 0, 0, 0, cfg.n_layers * (max_new - 1), 0, cfg.n_layers)
        check(counts == want, f"fixed-point static on {d}: launches K1-K7 "
                              f"{counts} != {want}")
        runs[str(d)] = (res.tokens, [lg.cpu() for lg in rec.logits])
    (ct, cl), (gt, gl) = runs["cpu"], runs[str(dev)]
    share, lines = _logit_list_audit(gt, ct, gl, cl, cfg.vocab_size)
    paged, p_logits, (k7, k7_reg) = _paged_run(
        cfg, params, prompts, max_new, dev, block_size=8, num_blocks=40)
    check(k7 == k7_reg == cfg.n_layers * len(prompts),
          f"paged fixed-point: K7 launches {k7} ({k7_reg} on the register "
          f"route) != {cfg.n_layers} x {len(prompts)} one-shot prefills")
    p_share, p_lines = _near_tie_audit(gt, paged, gl, p_logits,
                                       cfg.vocab_size)
    print(f"[16] reduced llama3.2-3b f32 softermax_fixed: card vs cpu static "
          f"engine {share:.3f} of greedy tokens equal, card static vs card "
          f"paged {p_share:.3f}; K7 launches {cfg.n_layers} per static "
          f"prefill, {k7} over {len(prompts)} paged prefills")
    for line in lines:
        print("[16] near-tie audit (card vs cpu): " + line)
    for line in p_lines:
        print("[16] near-tie audit (static vs paged): " + line)

    # three Softermax-aware finetuning steps of reduced bert-base
    bcfg = reduce_config(get_config("bert-base")).replace(
        causal=True, softmax_impl="softermax_fixed")
    init = init_lm_params(bcfg, torch.Generator().manual_seed(0))
    tc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=1e-4)
    out = {}
    for d in ("cpu", dev):
        _reset_counts()
        p = tree_map(lambda a: a.to(d, copy=True), init)
        data = SyntheticLMData(bcfg.vocab_size, 64, 16, seed=0)
        out[str(d)] = _train_run(bcfg, p, tc, 3, data), _softermax_counts()
    ((cp, crows), c_counts), ((gp, grows), g_counts) = \
        out["cpu"], out[str(dev)]
    check(c_counts == (0, 0) and g_counts == (0, 3 * bcfg.n_layers),
          f"bert QAT: K6/K7 launches cpu {c_counts} card {g_counts}")
    # The card's forward is K7, the CPU's softermax_fixed: they differ by
    # one Q(1,7) step where the running-max quantization ties
    # (kernels/softermax_quant/ref.py), and the STE gradient follows the
    # forward. On the CPU alone, swapping softermax_fixed's forward for
    # K7's mirror moves this run's losses and grad norms within the bounds
    # below (tests/test_torch_naive.py::test_qat_with_the_kernels_forward):
    # losses within 1e-3 at every step, the grad norm within 1e-3 at step 0
    # (same weights) and 2e-2 after, every parameter leaf within 1e-3 in
    # relative L2.
    rels = {}
    for s, (c, g) in enumerate(zip(crows, grows)):
        for key in ("loss", "ce", "grad_norm"):
            rel = abs(g[0][key] - c[0][key]) / abs(c[0][key])
            tol = 2e-2 if key == "grad_norm" and s > 0 else 1e-3
            rels[f"{key}[{s}]"] = rel
            check(rel <= tol, f"bert QAT step {s} {key}: card {g[0][key]}"
                              f" cpu {c[0][key]} (rel {rel} > {tol})")
    worst = max((torch.linalg.vector_norm(g.cpu() - c) /
                 torch.linalg.vector_norm(c)).item()
                for c, g in zip(tree_leaves(cp), tree_leaves(gp)))
    check(worst <= 1e-3, f"bert QAT: parameters differ by {worst}")
    print(f"[16] reduced bert-base softermax_fixed QAT, 3 steps: card vs cpu "
          f"relative differences " +
          ", ".join(f"{k} {v:.3g}" for k, v in rels.items()) +
          f" (losses {[round(r[0]['loss'], 5) for r in grows]}, grad norms "
          f"card {[round(r[0]['grad_norm'], 4) for r in grows]} cpu "
          f"{[round(r[0]['grad_norm'], 4) for r in crows]}), worst "
          f"parameter leaf rel L2 {worst:.3g} <= 1e-3, K7 launches "
          f"{g_counts[1]} ({bcfg.n_layers} per step)")


def _paged_run(cfg, params, prompts, max_new, dev, **kw):
    """The prompts through the paged engine (one-shot prefill): greedy
    streams, the logits behind each token by (prompt index, step), and the
    K7 launches of the run (all, and on the register route)."""
    from repro_torch.serve import ContinuousEngine
    B = len(prompts)
    max_len = len(prompts[0]) + max_new
    kw.setdefault("block_size", 16)
    kw.setdefault("num_blocks", B * (max_len // kw["block_size"] + 1) + 1)
    eng = ContinuousEngine(cfg, params, max_batch=B, max_len=max_len,
                           device=dev, **kw)
    rec = _paged_logits(eng)
    _reset_counts()
    handles = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    k7 = _softermax_counts()[1], _route_counts()[2]
    paged = [res[h.req_id].tokens for h in handles]
    logits = {(i, t): rec[h.req_id, t].cpu() for i, h in enumerate(handles)
              for t in range(max_new)}
    return paged, logits, k7


def _full_width_llama(dev):
    """llama3.2-3b in bf16 with weights from torch.Generator("cuda") seed 0,
    the attention projections at their true fan-in (``_true_fan_in``: the
    reference's init would put every score past Q(6,2)'s range), and the
    prompts of phase 13."""
    import numpy as np
    import torch
    from repro_torch.models.lm import cast_matrix_params
    from repro_torch.models.registry import get_config, init_lm_params
    cfg = get_config("llama3.2-3b")
    params = cast_matrix_params(_true_fan_in(
        init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0))),
        cfg.compute_dtype_)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (8, 1024)).astype(np.int32)
    return cfg, params, prompts


def _static_run(cfg, params, prompts, max_new, dev, label, tag):
    """The prompts through the static engine: tokens, per-step logits (on
    the host) and the K1-K7 launches; prints a profile of one more prefill
    by kernel."""
    import numpy as np
    import torch
    from repro_torch.serve import ServeEngine
    B, P = prompts.shape
    eng = ServeEngine(cfg, params, max_len=P + max_new, device=dev)
    rec = _StaticRecorder(eng)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new)
    wall = time.perf_counter() - t0
    counts = _all_counts()
    routes = _route_counts()
    rec.close()
    check(res.tokens.shape == (B, max_new) and
          ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all(),
          f"{label}: tokens {res.tokens}")
    check(all(torch.isfinite(lg).all().item() for lg in rec.logits),
          f"{label}: non-finite logits")
    print(f"[{tag}] {label}: {B} requests x {max_new} tokens, "
          f"{B * max_new / wall:.1f} tok/s ({wall:.2f}s incl. prefill "
          f"{rec.prefill_ms:.1f} ms), {np.mean(rec.decode_ms):.2f} ms per "
          f"decode step, launches K1-K7 {counts} (K5 on the bulk-copy route "
          f"{routes[0]}, K6 on the register route {routes[1]}, K7 on the "
          f"register route {routes[2]}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    tokens = torch.as_tensor(prompts, device=dev)
    print(f"[{tag}] {label} " + step_profile(lambda: eng._prefill(tokens), 1,
                                              "prefill"))
    del eng
    torch.cuda.empty_cache()
    return res.tokens, [lg.cpu() for lg in rec.logits], counts, routes


def phase_fixed_full_width(dev):
    """Full-width llama3.2-3b, bf16, softermax_fixed: the static engine
    (K7 prefill, K5 decode), then the paged engine (one-shot prefills
    through K7, K1 decode), with the near-tie audit between them. Returns
    the static run's K7 launches."""
    import torch
    cfg, params, prompts = _full_width_llama(dev)
    cfg = cfg.replace(softmax_impl="softermax_fixed")
    L, max_new = cfg.n_layers, 32
    tokens, s_logits, counts, routes = _static_run(
        cfg, params, prompts, max_new, dev, "static softermax_fixed", 17)
    check(counts == (0, 0, 0, 0, L * (max_new - 1), 0, L),
          f"static softermax_fixed: launches K1-K7 {counts}")
    check(routes[2] == counts[6], f"static softermax_fixed: {routes[2]} of "
                                  f"{counts[6]} K7 launches on the register "
                                  "route")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    paged, p_logits, (k7, k7_reg) = _paged_run(cfg, params, prompts,
                                               max_new, dev)
    wall = time.perf_counter() - t0
    check(k7 == k7_reg == L * len(prompts),
          f"paged softermax_fixed: K7 launches {k7} ({k7_reg} on the "
          f"register route) != {L} x {len(prompts)} prefills")
    share, lines = _near_tie_audit(tokens, paged, s_logits, p_logits,
                                   cfg.vocab_size)
    n_equal = sum(tokens[b].tolist() == paged[b] for b in range(len(paged)))
    print(f"[17] paged softermax_fixed: {len(paged)} requests x {max_new} "
          f"tokens, {len(paged) * max_new / wall:.1f} tok/s, K7 launches "
          f"{k7} ({L} per one-shot prefill, {k7_reg} on the register "
          f"route), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"[17] static vs paged engine (softermax_fixed, bf16): {share:.3f} "
          f"of greedy tokens equal, {n_equal}/{len(paged)} streams equal")
    for line in lines:
        print("[17] near-tie audit: " + line)
    del params, s_logits, p_logits
    torch.cuda.empty_cache()
    return counts[6]


def phase_naive_full_width(dev):
    """Full-width llama3.2-3b, bf16: the naive attention path with the float
    Softermax (K6) against the flash path (K3), static engine. Returns the
    naive run's K6 launches."""
    import torch
    cfg, params, prompts = _full_width_llama(dev)
    L, max_new = cfg.n_layers, 32
    naive = cfg.replace(attention_impl="naive", softmax_impl="softermax")
    tokens, n_logits, counts, routes = _static_run(
        naive, params, prompts, max_new, dev, "static naive softermax", 18)
    check(counts == (0, 0, 0, 0, L * (max_new - 1), L, 0),
          f"static naive: launches K1-K7 {counts}")
    check(routes == (counts[4], counts[5], 0),
          f"static naive: K5 / K6 launches {counts[4:6]}, on the bulk-copy "
          f"and register routes {routes}")
    flash = cfg.replace(attention_impl="flash", softmax_impl="softermax")
    f_tokens, f_logits, f_counts, _ = _static_run(
        flash, params, prompts, max_new, dev, "static flash softermax", 18)
    check(f_counts == (0, 0, L, 0, L * (max_new - 1), 0, 0),
          f"static flash: launches K1-K7 {f_counts}")
    share, lines = _logit_list_audit(tokens, f_tokens, n_logits, f_logits,
                                     cfg.vocab_size)
    print(f"[18] naive (K6) vs flash (K3) static engine, bf16: {share:.3f} "
          f"of greedy tokens equal")
    for line in lines:
        print("[18] near-tie audit: " + line)
    del params, n_logits, f_logits
    torch.cuda.empty_cache()
    return counts[5]


def phase_bert_finetune(dev):
    """Full-width bert-base: the Table III workflow at seq 512, batch 16,
    then timed steps of the softermax_fixed and the softmax variant."""
    import numpy as np
    import torch
    from repro_torch.benchmarks.table3_accuracy import (finetune_variants,
                                                        report)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.registry import get_config, model_fns
    from repro_torch.models.schema import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    seq, batch = 512, 16
    base = get_config("bert-base").replace(causal=True,
                                           softmax_impl="softmax")
    torch.cuda.empty_cache()
    init = _true_fan_in(model_fns(base).init(
        torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = finetune_variants(base, init, pretrain_steps=10, finetune_steps=5,
                            seq=seq, batch=batch)
    wall = time.perf_counter() - t0
    counts = _all_counts()
    k7_reg = _route_counts()[2]
    check(all(np.isfinite(v) for v in res.values()),
          f"bert-base Table III: losses {res}")
    check(counts[5] == 0 and counts[6] > 0 and k7_reg == counts[6],
          f"bert-base Table III: launches K1-K7 {counts}, K7 on the "
          f"register route {k7_reg}")
    print(f"[19] bert-base Table III workflow (seq {seq}, batch {batch}, 10 "
          f"pretrain + 3 x 5 finetune steps, 5 evals) in {wall:.1f}s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"launches K1-K7 {counts} (K7 on the register route {k7_reg})")
    for line in report(res).splitlines():
        if line.strip():
            print("[19] " + line)

    # ms per step of each variant, from the same weights
    per_step = {}
    for impl in ("softermax_fixed", "softmax"):
        cfg = base.replace(softmax_impl=impl)
        tc = TrainConfig(total_steps=4, warmup_steps=1, learning_rate=1e-4)
        step = make_train_step(model_fns(cfg).loss, tc)
        params = tree_map(lambda a: a.clone(), init)
        opt = adamw.init_state(params)
        data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=3)
        torch.cuda.reset_peak_memory_stats()
        ms, k7 = [], []
        for _ in range(4):
            b = next(data)
            c0 = _softermax_counts()[1], _route_counts()[2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            k7.append(_softermax_counts()[1] - c0[0])
            check(_route_counts()[2] - c0[1] == k7[-1],
                  f"{impl} step: {_route_counts()[2] - c0[1]} of {k7[-1]} "
                  "K7 launches on the register route")
            check(np.isfinite(float(m["loss"])), f"{impl} step: {m}")
        per_step[impl] = (ms, k7, torch.cuda.max_memory_allocated())
        print(f"[19] bert-base {impl} step: {np.mean(ms[1:]):.1f} ms (steps "
              f"1-3; step 0 {ms[0]:.1f} ms), K7 launches per step {k7[1:]}, "
              f"peak memory {per_step[impl][2] / 2 ** 30:.2f} GiB")
        if impl == "softermax_fixed":
            state = [params, opt]
            b = next(data)

            def profiled():
                state[0], state[1], _ = step(state[0], state[1], b)

            print("[19] softermax_fixed " + step_profile(profiled, 1,
                                                         "training step"))
        del params, opt
        torch.cuda.empty_cache()
    k7 = per_step["softermax_fixed"][1]
    L = base.n_layers
    want = (2 if base.remat == "full" else 1) * L
    check(all(n == want for n in k7), f"softermax_fixed step: K7 launches "
                                      f"{k7} != {want} per step")
    check(all(n == 0 for n in per_step["softmax"][1]),
          "softmax step launched K7")
    del init
    torch.cuda.empty_cache()


def phase_softermax_times(dev, k6_launches, k7_launches, n_layers):
    """K6 and K7 at the full-width prefill shape and the bert shape, f32."""
    import torch
    from repro_torch.kernels.parity import parity_error
    from repro_torch.kernels.softermax import (ops, softermax_rows,
                                               softermax_rows_ref)
    from repro_torch.kernels.softermax_quant import ops as ops7
    from repro_torch.kernels.softermax_quant import (softermax_quant_plain,
                                                     softermax_quant_rows)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    saved = _softermax_counts(), _route_counts()
    rows = {}
    for label, shape in (("prefill", PREFILL_ROWS), ("bert", BERT_ROWS)):
        x = torch.randn(shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(4)) * 3
        x[:, shape[1] // 2:][::2] = -1e9      # causal-like masked halves
        nbytes = 2 * x.numel() * 4            # read once, written once
        reg0 = softermax_rows.launches_reg
        got = softermax_rows(x)
        check(softermax_rows.launches_reg == reg0 + 1,
              f"K6 {shape}: not on the register route")
        err6 = parity_error(got, softermax_rows_ref(x))[0]
        # the two-pass kernel on the same inputs (its route before)
        err_two = parity_error(ops._launch(x, True, reg=False)[0], got)[0]
        ms6 = _time_ms(lambda: softermax_rows(x), flush)
        two6 = _time_ms(lambda: ops._launch(x, True, reg=False), flush)
        plain6 = _time_ms(lambda: softermax_rows_ref(x), flush, iters=5)
        ms6b = _time_ms(lambda: softermax_rows(x), flush)
        # the library's row softmax on scores already in base 2 (the path
        # folds ln 2 into q): the factor costs no pass of its own in use
        xs = x * math.log(2)
        lib6 = _time_ms(lambda: torch.softmax(xs, dim=-1), flush)
        del xs
        reg0 = softermax_quant_rows.launches_reg
        got = softermax_quant_rows(x)
        check(softermax_quant_rows.launches_reg == reg0 + 1,
              f"K7 {shape}: not on the register route")
        mirror = softermax_quant_plain(x)
        err7 = (got - mirror).abs().max().item()
        check(err7 == 0.0, f"K7 {shape}: differs from its mirror by {err7}")
        # the two-pass kernel on the same inputs (its route before)
        err7_two = (ops7._launch(x, reg=False)[0] - mirror).abs().max() \
            .item()
        check(err7_two == 0.0, f"K7 two-pass kernel {shape}: differs from "
                               f"the mirror by {err7_two}")
        del mirror
        ms7 = _time_ms(lambda: softermax_quant_rows(x), flush)
        two7 = _time_ms(lambda: ops7._launch(x, reg=False), flush)
        plain7 = _time_ms(lambda: softermax_quant_plain(x), flush, iters=2)
        ms7b = _time_ms(lambda: softermax_quant_rows(x), flush)
        rows[label] = (
            dict(_row("softermax_rows", "softermax.cu",
                      "src/repro/kernels/softermax/softermax.py:81",
                      k6_launches, n_layers, err6, ms6, plain6, nbytes,
                      5 * x.numel(), lib6), earlier_ms=two6),
            dict(_row("softermax_quant_rows", "softermax_quant.cu",
                      "src/repro/kernels/softermax_quant/softermax_quant.py"
                      ":67", k7_launches, n_layers, err7, ms7, plain7,
                      nbytes, 20 * x.numel()), earlier_ms=two7))
        print(f"[20] {label} shape {shape}: K6 register route {ms6:.4f} / "
              f"{ms6b:.4f} ms (bound {rows[label][0]['bound_ms']:.4f}, "
              f"two-pass kernel {two6:.4f} (vs K6 {err_two:.3g}), plain "
              f"{plain6:.4f}, torch.softmax {lib6:.4f}); K7 register route "
              f"{ms7:.4f} / {ms7b:.4f} ms (bound "
              f"{rows[label][1]['bound_ms']:.4f}, two-pass kernel "
              f"{two7:.4f}, both EQUAL to the mirror; plain {plain7:.4f}, "
              f"no library call)")
        del x, got
        torch.cuda.empty_cache()
    # timing launches do not count
    _set_softermax_counts(saved[0])
    _set_route_counts(saved[1])
    out = []
    for i in (0, 1):
        row = dict(rows["prefill"][i])
        bert = rows["bert"][i]
        row["bert_shape"] = {k: bert[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "earlier_ms") if k in bert}
        out.append(row)
    return out


def _paged_counts():
    """(K1, K8) launch counts."""
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    return flash_decode_paged.launches, flash_decode_paged_single.launches


def _set_paged_counts(counts):
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    flash_decode_paged.launches, flash_decode_paged_single.launches = counts


def _single_case(rng, dev, B, Hq, Hkv, D, BS, W, lens, kv, qdt):
    """Inputs of one K8 case: pools, a table whose entries past each row's
    block cover are garbage (other rows' blocks), lengths and queries."""
    import numpy as np
    import torch
    N = B * W + 1
    kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, dev)
    bt = rng.permutation(np.arange(1, N)).reshape(B, W).astype(np.int32)
    for b, ln in enumerate(lens):             # garbage past the cover
        cover = -(-ln // BS)
        bt[b, cover:] = rng.integers(0, N, W - cover)
    q = _rand(rng, (B, Hq, D), D ** -0.5).to(dev, qdt)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev), ks, vs)


def phase_single_parity(dev):
    """K8 against its plain version and against K1, on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single,
        paged_decode_single_plain)
    from repro_torch.kernels.parity import parity_error, tolerance
    saved = _paged_counts()
    rng = np.random.default_rng(21)
    worst, n, n_k1 = {}, 0, 0
    kinds = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
             ("int8", torch.float32), ("int8", torch.bfloat16)]
    cases = [(kv, qdt, G, BS, 2, 128, 7)
             for kv, qdt in kinds for G in (1, 3, 4, 8, 12) for BS in (8, 16)]
    cases += [(kv, qdt, 3, 16, 8, 128, 128) for kv, qdt in kinds]
    for kv, qdt, G, BS, Hkv, D, W in cases:
        if W == 7:
            lens = [0, 1, BS, 2 * BS + 5, 3 * BS, W * BS - 3]
        else:                                 # the full-width geometry
            lens = [0, 1, 16, 1023, 1024, 1025, 777, W * BS]
        B = len(lens)
        for intmax in (True, False):
            q, kp, vp, bt, ln, ks, vs = _single_case(
                rng, dev, B, G * Hkv, Hkv, D, BS, W, lens, kv, qdt)
            got = flash_decode_paged_single(q, kp, vp, bt, ln, k_scale=ks,
                                            v_scale=vs, intmax=intmax)
            torch.cuda.synchronize()
            want = paged_decode_single_plain(q, kp, vp, bt, ln, k_scale=ks,
                                             v_scale=vs, intmax=intmax)
            err, held = parity_error(got, want)
            label = f"{kv}/q {str(qdt)[6:]}"
            check(got.dtype == qdt and held <= tolerance(qdt),
                  f"K8 {label} G={G} BS={BS} W={W} intmax={intmax}: max "
                  f"|err| {err}, held {held}")
            check(bool(torch.all(got[0] == 0)), "K8: a row of length 0 is "
                                                "not 0")
            w = worst.get(label, (0.0, 0.0))
            worst[label] = (max(w[0], err), max(w[1], held))
            n += 1
            if G > 8:                         # K1 holds groups up to 8
                continue
            for T, S in ((1, 1), (4, 2)):
                k1 = flash_decode_paged(q, kp, vp, bt, ln, k_scale=ks,
                                        v_scale=vs, intmax=intmax,
                                        kv_tile_blocks=T, split_k=S)
                err1, held1 = parity_error(got, k1)
                check(held1 <= tolerance(qdt) and
                      bool(torch.all(k1[0] == 0)),
                      f"K8 vs K1 {label} G={G} BS={BS} T={T} S={S}: max "
                      f"|err| {err1}, held {held1}")
                w = worst.get(label + " vs K1", (0.0, 0.0))
                worst[label + " vs K1"] = (max(w[0], err1), max(w[1], held1))
                n_k1 += 1
    _set_paged_counts(saved)              # comparison launches do not count
    for label, (err, held) in sorted(worst.items()):
        print(f"[21] K8 {'' if 'K1' in label else 'vs plain '}{label}: max "
              f"|err| {err:.3g}, checked error {held:.3g}")
    print(f"[21] {n} K8 cases against its plain version, {n_k1} against K1 "
          f"(tile, split) (1, 1) and (4, 2); tolerances: fp32 outputs "
          f"{tolerance(torch.float32)} absolute, bf16 outputs "
          f"{tolerance(torch.bfloat16)} of each element's size")


# the benches' full-width geometry: llama3.2-3b's heads, one 16,384-token
# request and seven of up to 1,024
FULL_GEOMETRY = ["--requests", "8", "--hq", "24", "--hkv", "8",
                 "--head-dim", "128", "--block-size", "16", "--long-blocks",
                 "1024", "--short-blocks-max", "64"]
FULL_BENCH = FULL_GEOMETRY + ["--steps", "4", "--tile-blocks", "4",
                              "--split-k", "2"]


def _host_ms(fn, iters=20):
    """Mean host time to enqueue one call of ``fn`` (no device wait)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def phase_decode_bench(dev, card):
    """The ported decode_paged_bench's measuring function at the
    reference's defaults and at the full-width geometry, then each
    kernel's device time per launch and host enqueue time per call at the
    first step (the bench's events time whichever is longer). Returns the
    full-width run's (args, K8 launches)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import decode_paged_bench as bench
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged, flash_decode_paged_single)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = None
    for label, argv in (("defaults", []), ("full-width", FULL_BENCH)):
        args = bench.parse_args(argv + ["--device", "cuda"])
        _reset_counts()
        single_s, grouped_s, meta = bench.time_kernels(
            args, np.random.default_rng(args.seed), dev)
        k1, k8 = _paged_counts()
        want = args.steps * (1 + args.repeats)
        check(k8 == want and k1 == want,
              f"decode bench {label}: launches K8 {k8}, K1 {k1} != {want}")
        toks = args.requests * args.steps
        dma = meta["gather_bytes_per_token_per_layer"]
        print(f"[22] decode_paged_bench {label} (hq {args.hq}, hkv "
              f"{args.hkv}, D {args.head_dim}, long row "
              f"{args.long_blocks * args.block_size} tokens, table width "
              f"{meta['table_width']}, tile {args.tile_blocks}, split "
              f"{args.split_k}, {args.steps} steps, best of "
              f"{args.repeats}): per-head K8 {toks / single_s:.1f} tok/s "
              f"({single_s * 1e3:.4f} ms), grouped K1 "
              f"{toks / grouped_s:.1f} tok/s ({grouped_s * 1e3:.4f} ms), "
              f"ratio {single_s / grouped_s:.3f}, modeled gather-bytes ratio "
              f"{dma['ratio']}; launches K8 {k8}, K1 {k1}; {card}")
        wl = bench.workload(args, np.random.default_rng(args.seed), dev)
        q, kp, vp, bt = wl["q"], wl["kp"], wl["vp"], wl["bt"]
        ln = wl["lens_steps"][0]
        saved = _paged_counts()
        for name, fn in (
                ("K8", lambda: flash_decode_paged_single(q, kp, vp, bt, ln)),
                ("K1", lambda: flash_decode_paged(
                    q, kp, vp, bt, ln, kv_tile_blocks=args.tile_blocks,
                    split_k=args.split_k))):
            print(f"[22] decode_paged_bench {label} step 0: {name} device "
                  f"{_time_ms(fn, flush):.4f} ms per launch (L2 flushed, "
                  f"device wait before), host enqueue {_host_ms(fn):.4f} ms "
                  f"per call")
        _set_paged_counts(saved)          # timing launches do not count
        del wl, q, kp, vp, bt
        if label == "full-width":
            out = (args, k8)
    return out


def _autotune_engine(cfg, params, prompts, max_new, dev, mode):
    """The prompts through the paged engine under one autotune mode: greedy
    streams, the logits behind each token by (prompt index, step) on the
    host, K1/K8 launches, the decode steps and the engine."""
    from repro_torch.serve import ContinuousEngine, check_invariants
    eng = ContinuousEngine(cfg, params, block_size=16, num_blocks=2048,
                           max_batch=len(prompts),
                           max_len=max(len(p) for p in prompts) + max_new,
                           kv_tile_blocks=4, decode_split_k=2,
                           autotune=mode, device=dev)
    rec = _paged_logits(eng)
    _reset_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    wall = time.perf_counter() - t0
    counts = _paged_counts()
    check_invariants(eng.pool, eng.prefix_cache)
    streams = [res[h.req_id].tokens for h in handles]
    logits = {(i, t): rec[h.req_id, t].float().cpu()
              for i, h in enumerate(handles) for t in range(max_new)}
    return streams, logits, counts, eng.metrics.decode_steps, wall, eng


def phase_autotune(dev, card):
    """Full-width autotune: off / static / per-step engines, then the
    modeled argmin against the measured fastest grid on a replay of
    autotune_bench's full-width trajectory."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import autotune_bench
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.serve.autotune import GridPlanner
    cfg, params, _ = _full_width_llama(dev)
    rng = np.random.default_rng(0)            # phase 5's prompts
    lens = rng.integers(128, 1025, 8)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_new, V = 32, cfg.vocab_size
    runs = {}
    for mode in ("off", "static", "per-step"):
        streams, logits, (k1, k8), n_dec, wall, eng = _autotune_engine(
            cfg, params, prompts, max_new, dev, mode)
        check(k1 == cfg.n_layers * n_dec and k1 > 0 and k8 == 0,
              f"autotune {mode}: launches K1 {k1} (decode steps {n_dec}), "
              f"K8 {k8}")
        check(all(len(s) == max_new for s in streams),
              f"autotune {mode}: a request did not finish")
        dec = "" if eng.planner is None else \
            f", decisions {eng.planner.summary()}"
        print(f"[23] autotune {mode}: grid (tile {eng.kv_tile_blocks}, "
              f"split {eng.decode_split_k}){dec}; {len(prompts)} requests x "
              f"{max_new} tokens in {wall:.2f}s, K1 launches {k1} "
              f"({n_dec} decode steps)")
        runs[mode] = (streams, logits)
        del eng
        torch.cuda.empty_cache()
    off, off_logits = runs["off"]
    tokens = np.array(off)
    s_logits = [torch.stack([off_logits[b, t] for b in range(len(off))])
                for t in range(max_new)]
    for mode in ("static", "per-step"):
        streams, logits = runs[mode]
        share, lines = _near_tie_audit(tokens, streams, s_logits, logits, V)
        print(f"[23] off vs {mode}: {share:.3f} of greedy tokens equal, "
              f"{sum(a == b for a, b in zip(off, streams))}/{len(off)} "
              f"streams equal")
        for line in lines:
            print(f"[23] off ('static') vs {mode} ('paged') near-tie audit: "
                  + line)
    del params, runs
    torch.cuda.empty_cache()

    # modeled argmin against the measured fastest grid
    args = autotune_bench.parse_args(FULL_GEOMETRY + ["--device", "cuda"])
    steps = autotune_bench.trajectory(args)
    cands = autotune_bench.candidates(args)
    planner = GridPlanner(cands, cost_params=autotune_bench.cost_params(args),
                          n_q_heads=args.hq, n_kv_heads=args.hkv,
                          head_dim=args.head_dim, block_size=args.block_size,
                          kv_dtype=args.kv_dtype)
    BS, B = args.block_size, args.requests
    blocks = [-(-int(max(ln[b] for ln, _ in steps)) // BS) for b in range(B)]
    W_max = max(w for _, w in steps)
    N = sum(blocks) + 1
    rng = np.random.default_rng(23)
    kp = _rand(rng, (N, args.hkv, BS, args.head_dim)).to(dev)
    vp = _rand(rng, (N, args.hkv, BS, args.head_dim)).to(dev)
    table = np.zeros((B, W_max), np.int32)
    nxt = 1
    for b, nb in enumerate(blocks):
        table[b, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    table = torch.from_numpy(table).to(dev)
    q = _rand(rng, (B, args.hq, args.head_dim),
              args.head_dim ** -0.5).to(dev)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    saved = _paged_counts()
    sample = list(range(0, len(steps), 4))
    agree, picks, lines = 0, {}, []
    for i in sample:
        ln_np, w = steps[i]
        dec = planner.rank(ln_np, w)
        bt = table[:, :w].contiguous()
        ln = torch.from_numpy(ln_np.astype(np.int32)).to(dev)
        ms = {}
        for T, S in cands:
            ms[T, S] = _time_ms(lambda: flash_decode_paged(
                q, kp, vp, bt, ln, kv_tile_blocks=T, split_k=S), flush,
                iters=5)
        fastest = min(ms, key=ms.get)
        chosen = (dec.kv_tile_blocks, dec.split_k)
        agree += int(ms[chosen] == ms[fastest])
        key = f"t{chosen[0]}_s{chosen[1]}"
        picks[key] = picks.get(key, 0) + 1
        lines.append(f"step {i} (width {w}, longest {int(ln_np.max())}): "
                     f"modeled t{chosen[0]}_s{chosen[1]} "
                     f"{ms[chosen]:.4f} ms, measured fastest "
                     f"t{fastest[0]}_s{fastest[1]} {ms[fastest]:.4f} ms; "
                     + ", ".join(f"t{t}_s{s} {v:.4f}"
                                 for (t, s), v in sorted(ms.items())))
    _set_paged_counts(saved)              # timing launches do not count
    for line in lines:
        print("[23] trajectory " + line)
    print(f"[23] autotune_bench full-width trajectory ({len(steps)} steps, "
          f"{len(sample)} sampled, candidates {args.candidates}, machine "
          f"model cores {args.cores} flops/s {args.flops_per_s:g}): modeled "
          f"argmin is the measured fastest on {agree}/{len(sample)} steps; "
          f"modeled picks {picks}; {card}")


def phase_single_times(dev, bench_args, launches):
    """K8 at the phase-22 full-width shape (the first timed step)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import decode_paged_bench as bench
    from repro_torch.kernels.flash_decode_paged import (
        flash_decode_paged_single, paged_decode_single_plain)
    from repro_torch.kernels.parity import parity_error, tolerance
    wl = bench.workload(bench_args, np.random.default_rng(bench_args.seed),
                        dev)
    q, kp, vp, bt = wl["q"], wl["kp"], wl["vp"], wl["bt"]
    ln = wl["lens_steps"][0]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    saved = _paged_counts()
    got = flash_decode_paged_single(q, kp, vp, bt, ln)
    err, held = parity_error(got, paged_decode_single_plain(q, kp, vp, bt,
                                                            ln))
    check(held <= tolerance(q.dtype), f"K8 full-width shape: {err}")
    ms = _time_ms(lambda: flash_decode_paged_single(q, kp, vp, bt, ln),
                  flush)
    plain = _time_ms(lambda: paged_decode_single_plain(q, kp, vp, bt, ln),
                     flush, iters=2)
    _set_paged_counts(saved)              # timing launches do not count
    B, Hq, D = q.shape
    Hkv = kp.shape[1]
    rows = int(ln.sum().item())
    # K/V rows within the lengths read once per KV head (the least any
    # kernel of this function moves), q read and the output written once,
    # the tables and lengths
    nbytes = (2 * rows * Hkv * D * 4 + 2 * q.numel() * 4 + bt.numel() * 4
              + B * 4)
    row = _row("flash_decode_paged_single", "flash_decode_paged_single.cu",
               "src/repro/kernels/flash_decode_paged/"
               "flash_decode_paged.py:302", launches, 1, err, ms, plain,
               nbytes, 4 * Hq * rows * D)
    print(f"[24] K8 at the full-width bench shape (B {B}, Hq {Hq}, Hkv "
          f"{Hkv}, D {D}, {rows} cached rows, table width {bt.shape[1]}, "
          f"f32 pool): {ms:.4f} ms (bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']}, plain {plain:.4f} ms), max |err| vs plain "
          f"{err:.3g}")
    return [row]


def _row(name, src, replaces, launches, per_step, err, ms, plain, nbytes,
         flops, library=None, peak="bfloat16"):
    """One kernel's entry of the ``kernels`` line; ``peak`` names the rate
    its operations run at (the dtype of its inputs)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": launches, "launches_per_step": per_step,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_f32_peak": max(
                t_bytes, flops / PEAK_FLOPS["float32"] * 1e3),
            "library_ms": library}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import platform
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] python {platform.python_version()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"[1] {card}")

    t0 = time.perf_counter()
    build.load_library()
    print(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f}s")
    for line in build.ptxas_report().splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            print("[2] " + line.strip())
    for name, regs, spill in _ptxas_kernels(
            build.ptxas_report(), ("flash_decode_bulk.cu", "softermax.cu",
                                   "softermax_quant.cu",
                                   "flash_prefill_paged_tc.cu")):
        print(f"[2] ptxas {name}: {regs} registers, {spill}")

    phase_kernel_parity(dev)
    phase_engine_parity(dev)
    main_counts = phase_full_width(dev)
    from repro_torch.models.registry import get_config
    print("[6] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    n_layers = get_config("llama3.2-3b").n_layers
    kernels = phase_kernel_times(dev, main_counts, n_layers)
    flash_errs = phase_flash_parity(dev)
    f32_counts = phase_train_parity(dev)
    train_counts = phase_train_full_width(dev)
    print("[10] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_flash_times(dev, train_counts, f32_counts, flash_errs,
                                 n_layers)
    phase_decode_parity(dev)
    phase_static_parity(dev)
    k5_launches = phase_static_full_width(dev)
    print("[14] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_decode_times(dev, k5_launches, n_layers)
    phase_softermax_parity(dev)
    phase_fixed_reduced(dev)
    k7_launches = phase_fixed_full_width(dev)
    k6_launches = phase_naive_full_width(dev)
    phase_bert_finetune(dev)
    print("[20] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_softermax_times(dev, k6_launches, k7_launches, n_layers)
    phase_single_parity(dev)
    bench_args, k8_launches = phase_decode_bench(dev, card)
    phase_autotune(dev, card)
    print("[24] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels += phase_single_times(dev, bench_args, k8_launches)
    for k in kernels:
        k["card"] = card
        lib = "" if k["library_ms"] is None else \
            f", library {k['library_ms']:.4f} ms"
        if "earlier_ms" in k:
            lib += f", earlier route {k['earlier_ms']:.4f} ms"
        print(f"[kernels] {k['name']}: {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
              f"{k['bound_by']}{lib}), {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
