#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Device: torch/CUDA versions and the card's name and power limit.
2. Build: the CUDA kernels from ``src/repro_torch/csrc`` (ptxas report).
3. Kernel parity at the main path's head geometry (Hq 24, Hkv 8, D 128,
   block 16): each kernel against its plain PyTorch version.
4. Engine parity at reduced llama3.2-3b in float32: the engine on the card
   (kernels) emits the same greedy streams as the engine on the CPU (plain
   versions); the launch counters equal layers x decode steps (decode
   kernel) and layers x chunks (prefill kernel).
5. Full-width serving of llama3.2-3b in bfloat16 with random weights:
   one-shot prefill, chunked prefill, a shared-prefix resubmit and an int8
   pool; every request finishes and the pool invariants hold.
6. Kernel times at the main path's shapes (CUDA events, L2 flushed between
   launches) beside their bound and their plain versions.

Prints the ``{"kernels": [...]}`` line and then, last, one JSON line with
``ok`` and the device. Without a card it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
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
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    flash_decode_paged.launches = 0
    flash_prefill_paged.launches = 0


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


def phase_full_width(dev):
    """Full-width llama3.2-3b in bf16: one-shot, chunked, shared-prefix
    resubmit, int8 pool. Returns the chunked run's launch counts."""
    import numpy as np
    import torch
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
                  f"decode={k1} prefill={k2}")
            if label == "chunked-256":
                main_counts = (k1, k2)
        del eng
        torch.cuda.empty_cache()

    # where a decode step's time goes: a profiled window once every
    # request is decoding
    eng = ContinuousEngine(cfg, params, device=dev, **base)
    for p in prompts:
        eng.submit(p, max_new)
    while eng.sched.waiting or eng.metrics.decode_steps < 1 or any(
            r.state == "prefill" for r in eng.sched.running):
        eng.step()
    print("[5] " + decode_profile(eng, 5))
    while eng.sched.has_work():
        eng.step()
    eng.drain()
    return main_counts


def decode_profile(eng, n_steps: int) -> str:
    """Device-busy share and kernel time by name over ``n_steps`` decode
    steps, from the profiler's CUDA activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("<")[0].split("(")[0]
            kern[name] = kern.get(name, 0.0) + e.time_range.elapsed_us()
    if not kern:
        return "decode profile: device time not measured (no CUDA events)"
    busy = sum(kern.values()) / 1e3 / n_steps
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    return (f"decode profile over {n_steps} steps: {wall * 1e3 / n_steps:.2f}"
            f" ms per step, device busy {busy:.2f} ms per step "
            f"({100 * busy / (wall * 1e3 / n_steps):.0f}%), by kernel (ms "
            f"per step): " + ", ".join(f"{k} {v / 1e3 / n_steps:.3f}"
                                       for k, v in top))


def _time_ms(fn, flush, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches, L2 flushed
    before each (the serving path reads every layer's pool cold)."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
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
    from repro_torch.kernels.flash_decode_paged import (flash_decode_paged,
                                                        paged_decode_ref)
    from repro_torch.kernels.flash_prefill_paged import (flash_prefill_paged,
                                                         paged_prefill_ref)
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

    # K2: one 256-token chunk at pos0 = 768, bf16 pool
    C, pos0 = 256, 768
    W = (pos0 + C) // BS
    kp, vp, _, _ = _pools(rng, W + 1, Hkv, BS, D, "bfloat16", dev)
    bt = torch.from_numpy(rng.permutation(np.arange(1, W + 1))
                          .astype(np.int32)[None]).to(dev)
    p0 = torch.tensor([pos0], dtype=torch.int32, device=dev)
    q = _rand(rng, (1, Hq, C, D), D ** -0.5).to(dev, torch.bfloat16)
    saved = flash_prefill_paged.launches
    got = flash_prefill_paged(q, kp, vp, bt, p0)
    err = (got.float() - paged_prefill_ref(q, kp, vp, bt, p0).float()) \
        .abs().max().item()
    ms = _time_ms(lambda: flash_prefill_paged(q, kp, vp, bt, p0), flush)
    plain = _time_ms(lambda: paged_prefill_ref(q, kp, vp, bt, p0), flush)
    flash_prefill_paged.launches = saved
    keys = sum(pos0 + i + 1 for i in range(C))   # causal: what the data needs
    nbytes = 2 * (pos0 + C) * Hkv * D * 2 + 2 * q.numel() * 2 + W * 4 + 4
    flops = 4 * Hq * keys * D
    out.append(_row("flash_prefill_paged", "flash_prefill_paged.cu",
                    "src/repro/kernels/flash_prefill_paged/"
                    "flash_prefill_paged.py:136", main_counts[1], n_layers,
                    err, ms, plain, nbytes, flops))
    return out


def _row(name, src, replaces, launches, per_step, err, ms, plain, nbytes,
         flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "launches": launches, "launches_per_step": per_step,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_f32_peak": max(
                t_bytes, flops / PEAK_FLOPS["float32"] * 1e3),
            "library_ms": None}


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

    phase_kernel_parity(dev)
    phase_engine_parity(dev)
    main_counts = phase_full_width(dev)
    from repro_torch.models.registry import get_config
    print("[6] sm clock, power draw, temperature: " +
          card_line("clocks.sm,power.draw,temperature.gpu"))
    kernels = phase_kernel_times(dev, main_counts,
                                 get_config("llama3.2-3b").n_layers)
    for k in kernels:
        print(f"[6] {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}"
              f" ms, bound {k['bound_ms']:.4f} ms by {k['bound_by']}), "
              f"{card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
