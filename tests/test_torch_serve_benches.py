"""The port's serving benches on the CPU.

``repro_torch.benchmarks.decode_paged_bench`` and ``autotune_bench`` run in
``--smoke`` mode with ``--device cpu`` (the plain versions of K1 and K8;
kernel parity and the engines' greedy equality gated, speed not), writing
nothing. The autotune bench's full mode writes its record into
``tmp_path``, stamped by the port's provenance header.

The autotune bench's trajectory, per-step decisions and modeled totals
against the JAX bench's (``benchmarks/autotune_bench.py``) for the same
arguments: the trajectory and every decision EXACTLY equal; every total
EXACTLY the correctly rounded sum (``math.fsum``) of the reference's
per-step values, which both benches compute bit for bit alike. The
reference accumulates its static totals with ``+=`` and its per-step total
with ``sum()`` (compensated since Python 3.12), so its own totals may sit
an ulp off those sums: held to 1e-12 relative.

The four serving benches (``prefill_paged_bench``, ``kv_int8_bench``,
``prefix_cache_bench``, ``serve_throughput``): each passes ``--smoke
--device cpu`` (``serve_throughput``, which has no smoke mode in the
reference either, at a small explicit workload) and writes nothing; its
workload generator gives arrays EXACTLY equal to the reference's; its
readings on weights bridged from the JAX init equal the reference's:
prefill savings and the int8 capacity ratio EXACTLY, the logit-error probe
within 1e-4 absolute, every request's greedy stream EXACTLY the JAX
engine's. A record built from smoke readings carries the reference's
fields, the port's provenance and the commit the caller passes.
``serve_throughput`` without ``--no-overhead-check`` runs its telemetry
on/off rounds and prints their ratio and latency quantiles.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from benchmarks import autotune_bench as jax_bench
from benchmarks import kv_int8_bench as jax_int8
from benchmarks import prefill_paged_bench as jax_prefill
from benchmarks import prefix_cache_bench as jax_prefix
from benchmarks import serve_throughput as jax_serve
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.kernel_costs import (CostParams, decode_launch_cost,
                                      estimate_seconds)
from repro.serve.kv_pool import PagedKVCache as JaxPool
from repro_torch.benchmarks import (autotune_bench, decode_paged_bench,
                                    kv_int8_bench, prefill_paged_bench,
                                    prefix_cache_bench, provenance,
                                    serve_throughput)
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config


def test_decode_bench_smoke_on_cpu(tmp_path, capsys):
    out = tmp_path / "decode.json"
    ratio = decode_paged_bench.main(["--smoke", "--device", "cpu", "--out",
                                     str(out)])
    assert ratio > 0 and not out.exists()
    lines = capsys.readouterr().out.splitlines()
    assert "decode_paged_bench,engine,greedy_equal,1" in lines
    assert "mode,cpu-plain" in lines[3]


def test_autotune_bench_smoke_on_cpu(tmp_path, capsys):
    out = tmp_path / "autotune.json"
    ratio = autotune_bench.main(["--smoke", "--device", "cpu", "--out",
                                 str(out)])
    assert ratio >= 1.0 and not out.exists()
    assert "autotune_bench,engine,greedy_equal,1" in \
        capsys.readouterr().out.splitlines()


def test_autotune_bench_full_mode_writes_its_record(tmp_path):
    out = tmp_path / "autotune.json"
    ratio = autotune_bench.main(["--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert ratio > 1.0 and rec["ratio_best_static_over_per_step"] == ratio
    prov = rec["provenance"]
    assert prov["measurement_mode"] == "analytic-cost-model"
    assert prov["card_name"] is None and prov["card_power_limit"] is None
    assert {"git_commit", "timestamp_utc", "torch_version", "cuda_version",
            "platform", "python"} <= set(prov)
    assert rec["greedy_equal"] is True and rec["engine_device"] == "cpu"


@pytest.mark.parametrize("argv", [["--smoke"], []], ids=["smoke", "full"])
def test_autotune_model_matches_jax_bench(argv):
    args = autotune_bench.parse_args(argv + ["--device", "cpu"])
    steps = autotune_bench.trajectory(args)
    jsteps = jax_bench._trajectory(args)
    assert len(steps) == len(jsteps)
    for (ln, w), (jln, jw) in zip(steps, jsteps):
        assert w == jw and np.array_equal(ln, jln)

    best, best_tot, per_tot, static_tot, decisions, _ = \
        autotune_bench.model_costs(args, steps)
    jbest, jbest_tot, jper_tot, jstatic_tot, jdecisions, _ = \
        jax_bench._model_costs(args, jsteps)
    assert best == jbest and decisions == jdecisions
    assert sorted(static_tot) == sorted(jstatic_tot)

    # the reference's per-step values, recomputed with its own model
    shape = dict(n_q_heads=args.hq, n_kv_heads=args.hkv,
                 head_dim=args.head_dim, block_size=args.block_size,
                 kv_dtype=args.kv_dtype)
    jparams = CostParams(cores=args.cores, flops_per_s=args.flops_per_s)
    per_cand = {c: [estimate_seconds(decode_launch_cost(
        ln, w, kv_tile_blocks=c[0], split_k=c[1], **shape), jparams)
        for ln, w in jsteps] for c in jstatic_tot}
    for c, tot in static_tot.items():
        assert tot == math.fsum(per_cand[c])
        assert tot == pytest.approx(jstatic_tot[c], rel=1e-12)
    assert per_tot == math.fsum(min(v[i] for v in per_cand.values())
                                for i in range(len(jsteps)))
    assert per_tot == pytest.approx(jper_tot, rel=1e-12)
    assert best_tot / per_tot == pytest.approx(jbest_tot / jper_tot,
                                               rel=1e-12)


SERVE_SMALL = ["--device", "cpu", "--no-overhead-check", "--requests", "6",
               "--repeats", "1", "--max-prompt", "40", "--max-new", "4"]


def _bridged(arch="qwen3-4b", head_dim=None):
    jcfg = jax_reduce_config(jax_get_config(arch))
    tcfg = reduce_config(get_config(arch))
    if head_dim:
        jcfg, tcfg = (c.replace(head_dim=head_dim) for c in (jcfg, tcfg))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def qwen():
    return _bridged()


@pytest.mark.parametrize("bench, argv, out", [
    (prefill_paged_bench, ["--smoke"], "prefill.json"),
    (kv_int8_bench, ["--smoke"], "int8.json"),
    (prefix_cache_bench, ["--smoke"], None),
    (serve_throughput, SERVE_SMALL[2:], None)],
    ids=["prefill", "kv_int8", "prefix_cache", "serve_throughput"])
def test_serving_bench_smoke_on_cpu_writes_nothing(bench, argv, out,
                                                   tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.chdir(tmp_path)
    if out:
        argv = argv + ["--out", str(tmp_path / out)]
    ratio = bench.main(argv + ["--device", "cpu"])
    assert ratio > 0 and list(tmp_path.iterdir()) == []
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.split(",")[1].startswith("ratio_") for ln in lines)
    assert bench.parse_args([]).device == "cuda"


def test_serve_throughput_runs_its_overhead_check_on_cpu(capsys):
    """The smoke arguments without ``--no-overhead-check``: each round
    also drives the paged engine with telemetry on, and the bench prints
    the paired tok/s, the best-of on/off ratio, the median of the paired
    ratios and the telemetry drives' TTFT, TPOT and e2e quantiles before
    its >= 0.95 gate; one untimed plain drive precedes the rounds. The gate's
    reading is a host timing of a 2-layer model on a shared CPU, where a
    decode step takes about a millisecond and the hooks a few percent of
    it (the reference's CLI misses it too at these arguments): the test
    holds the check's wiring and the gate's rule on given ratios, not the
    reading."""
    argv = [a for a in SERVE_SMALL if a != "--no-overhead-check"]
    try:
        assert serve_throughput.main(argv) > 0
    except serve_throughput.OverheadGateMissed:
        pass
    lines = capsys.readouterr().out.splitlines()
    over = [ln.split(",") for ln in lines
            if ln.startswith("serve_throughput,telemetry_on_over_off,")]
    pairs = [ln.split(",")[2:] for ln in lines
             if ln.startswith("serve_throughput,telemetry_rounds_tok_s,")]
    med = [float(ln.split(",")[2]) for ln in lines if ln.startswith(
        "serve_throughput,telemetry_on_over_off_median,")]
    warm = [ln for ln in lines
            if ln.startswith("serve_throughput,telemetry_warm_drive_tok_s,")]
    assert len(over) == 1 and float(over[0][2]) > 0
    assert len(pairs) == 1 and len(pairs[0]) == 1      # one round
    assert med == [float(over[0][2])]                  # one pair: equal
    assert len(warm) == 1                              # before the rounds
    counts = {}
    for ln in lines:
        f = ln.split(",")
        if f[1] in ("ttft", "tpot", "e2e"):
            assert f[2::2][:3] == ["p50_ms", "p90_ms", "p99_ms"]
            assert 0 < float(f[3]) <= float(f[5]) <= float(f[7])
            counts[f[1]] = int(f[9])
    # 6 requests of 4 tokens in the one telemetry drive
    assert counts == {"ttft": 6, "tpot": 18, "e2e": 6}
    serve_throughput.check_overhead(0.95)
    with pytest.raises(serve_throughput.OverheadGateMissed):
        serve_throughput.check_overhead(0.949)


@pytest.mark.parametrize("argv", [["--smoke"], []], ids=["smoke", "full"])
def test_workload_generators_equal_the_reference(argv):
    V = 512
    a = prefill_paged_bench.parse_args(argv + ["--device", "cpu"])
    for x, y in zip(prefill_paged_bench.make_docs(
            a.requests, a.shared_len, a.doc_len, V, a.seed),
            jax_prefill.make_docs(a.requests, a.shared_len, a.doc_len, V,
                                  a.seed)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    a = kv_int8_bench.parse_args(argv + ["--device", "cpu"])
    for x, y in zip(kv_int8_bench.make_prompts(a.requests, a.prompt_len, V,
                                               a.seed),
                    jax_int8.make_prompts(a.requests, a.prompt_len, V,
                                          a.seed)):
        np.testing.assert_array_equal(x, y)
    a = prefix_cache_bench.parse_args(argv + ["--device", "cpu"])
    for x, y in zip(prefix_cache_bench.make_prompts(
            a.requests, a.shared_len, a.unique_len, V, a.seed),
            jax_prefix.make_prompts(a.requests, a.shared_len, a.unique_len,
                                    V, a.seed)):
        np.testing.assert_array_equal(x, y)
    a = serve_throughput.parse_args(["--device", "cpu"])
    wl = serve_throughput.make_workload(a.requests, a.rate, a.min_prompt,
                                        a.max_prompt, V, a.seed)
    jwl = jax_serve.make_workload(a.requests, a.rate, a.min_prompt,
                                  a.max_prompt, V, a.seed)
    assert [w.t for w in wl] == [w.t for w in jwl]
    for w, j in zip(wl, jwl):
        np.testing.assert_array_equal(w.prompt, j.prompt)


def test_prefill_bench_streams_match_jax_engines(qwen):
    jcfg, tcfg, jparams, tparams = qwen
    prompts = prefill_paged_bench.make_docs(2, 24, 40, tcfg.vocab_size, 0)
    kw = dict(block_size=8, num_blocks=24, max_batch=2, max_len=68,
              max_new=3)
    eq, metrics, outs = prefill_paged_bench._engine_equality(
        tcfg, tparams, prompts, chunk=16, device="cpu", **kw)
    assert eq and outs[0] == outs[16]
    for c in (0, 16):
        max_new = kw["max_new"]
        jeng = JaxEngine(jcfg, jparams, prefill_chunk=c,
                         **{k: v for k, v in kw.items() if k != "max_new"})
        hs = [jeng.submit(p, max_new) for p in prompts]
        res = jeng.run()
        assert [res[h.req_id].tokens for h in hs] == outs[c], f"chunk {c}"
    assert (metrics.prefill_chunks, metrics.prefix_hit_tokens) == \
        (jeng.metrics.prefill_chunks, jeng.metrics.prefix_hit_tokens)
    # the op-level paths agree on the next token at the same shapes
    _, _, argmax_eq = prefill_paged_bench._time_op_paths(
        tcfg, tparams, prompts[0], shared_len=24, block_size=8, chunk=16,
        repeats=1, device="cpu")
    assert argmax_eq


@pytest.mark.parametrize("head_dim, block_size, bf16_blocks", [
    (64, 16, 18), (128, 16, 18), (64, 8, 6), (16, 8, 7)])
def test_int8_bench_capacity_equals_the_reference(head_dim, block_size,
                                                  bf16_blocks):
    tcfg = reduce_config(get_config("qwen3-4b")).replace(head_dim=head_dim)
    jcfg = jax_reduce_config(jax_get_config("qwen3-4b")).replace(
        head_dim=head_dim)
    budget, int8_blocks, ratio = kv_int8_bench.equal_budget(
        tcfg, block_size, bf16_blocks)
    # the reference's arithmetic (kv_int8_bench.main), on its own pool
    jbudget = bf16_blocks * JaxPool.bytes_per_block(jcfg, block_size, "bf16")
    jint8 = jbudget // JaxPool.bytes_per_block(jcfg, block_size, "int8")
    assert (budget, int8_blocks, ratio) == (jbudget, jint8,
                                            jint8 / bf16_blocks)


def test_int8_bench_readings_match_jax():
    jcfg, tcfg, jparams, tparams = _bridged(head_dim=32)
    args = kv_int8_bench.parse_args(["--smoke", "--device", "cpu",
                                     "--head-dim", "32"])
    prompts = kv_int8_bench.make_prompts(args.requests, args.prompt_len,
                                         tcfg.vocab_size, args.seed)
    _, int8_blocks, _ = kv_int8_bench.equal_budget(tcfg, args.block_size,
                                                   args.bf16_blocks)
    engines, _, _ = kv_int8_bench.make_engines(tcfg, tparams, args,
                                               int8_blocks, "cpu")
    _, toks = kv_int8_bench.serve_rounds(engines, prompts, args.max_new, 1)
    for kv, eng in engines.items():
        jeng = JaxEngine(jcfg, jparams, block_size=args.block_size,
                         num_blocks=eng.pool.num_blocks,
                         max_batch=eng.max_batch, max_len=eng.max_len,
                         max_admit_per_step=eng.max_batch,
                         prefix_cache=False, kv_dtype=kv)
        _, jtoks = jax_int8._serve_once(jeng, prompts, args.max_new)
        assert toks[kv] == jtoks, kv
    for p in prompts[:2]:
        err = kv_int8_bench._logit_error_probe(tcfg, tparams, p, "cpu")
        assert err == pytest.approx(
            jax_int8._logit_error_probe(jcfg, jparams, p), abs=1e-4)
    n_div, gap = kv_int8_bench._audit_divergences(
        tcfg, tparams, prompts, toks["bf16"], toks["int8"], 0.2, "cpu")
    jn_div, jgap = jax_int8._audit_divergences(
        jcfg, jparams, prompts, toks["bf16"], toks["int8"], 0.2)
    assert n_div == jn_div and gap == pytest.approx(jgap, abs=1e-4)


def test_prefix_bench_savings_and_streams_match_jax(qwen):
    jcfg, tcfg, jparams, tparams = qwen
    prompts = prefix_cache_bench.make_prompts(4, 40, 6, tcfg.vocab_size, 0)
    kw = dict(block_size=8, num_blocks=40, max_batch=2, max_len=50,
              max_new=3)
    readings = []
    for mod, cfg, params, extra in (
            (prefix_cache_bench, tcfg, tparams, {"device": "cpu"}),
            (jax_prefix, jcfg, jparams, {})):
        _, on = mod.make_driver(cfg, params, prompts, prefix_cache=True,
                                **kw, **extra)
        _, off = mod.make_driver(cfg, params, prompts, prefix_cache=False,
                                 **kw, **extra)
        rounds = []
        for _ in range(2):
            t_off, _, _, c_off = off()
            t_on, _, _, c_on = on()
            assert t_on == t_off
            rounds.append((t_on, c_on, c_off))
        readings.append(rounds)
        if mod is prefix_cache_bench:
            # the bench's own round loop: one more steady-state round
            _, _, on_c, off_c = prefix_cache_bench.run_rounds(on, off, 1)
            assert (on_c[0], off_c[0]) == rounds[-1][1:]
    assert readings[0] == readings[1]
    on_c = [c for _, c, _ in readings[0]]
    off_c = [c for _, _, c in readings[0]]
    assert float(np.median(off_c) / np.median(on_c)) >= 1.8


def test_serve_throughput_streams_match_jax_engines(qwen):
    jcfg, tcfg, jparams, tparams = qwen
    a = serve_throughput.parse_args(SERVE_SMALL)
    wl = serve_throughput.make_workload(a.requests, a.rate, a.min_prompt,
                                        a.max_prompt, tcfg.vocab_size,
                                        a.seed)
    slot_width = a.max_prompt + a.max_new
    slots = max(a.num_blocks * a.block_size // slot_width, 1)
    paged, _ = serve_throughput.make_paged_driver(
        tcfg, tparams, wl, block_size=a.block_size, num_blocks=a.num_blocks,
        max_batch=a.max_batch, max_len=slot_width, max_new=a.max_new,
        device="cpu")
    static = serve_throughput.make_static_driver(
        tcfg, tparams, wl, slots=slots, pad_len=a.max_prompt,
        max_new=a.max_new, device="cpu")
    s_rounds, p_rounds, t_rounds, ratios, m, reqs = \
        serve_throughput.run_rounds(static, paged, 1)
    assert t_rounds == []
    assert len(ratios) == 1 and m.decode_steps > 0
    streams = [r.tokens for r in reqs[0]]
    # the JAX paged engine on the same prompts, all submitted at once: the
    # schedule differs, every request's stream does not
    jeng = JaxEngine(jcfg, jparams, block_size=a.block_size,
                     num_blocks=a.num_blocks, max_batch=a.max_batch,
                     max_len=slot_width, prefix_cache=False)
    hs = [jeng.submit(w.prompt, a.max_new) for w in wl]
    res = jeng.run()
    assert streams == [res[h.req_id].tokens for h in hs]
    # static slots: each padded row through the JAX static engine
    _, _, sstreams = static()
    jst = JaxServeEngine(jcfg, jparams, max_len=a.max_prompt + a.max_new)
    rows = np.ones((slots, a.max_prompt), np.int32)
    want = []
    for i in range(0, len(wl), slots):
        batch = rows.copy()
        for j, w in enumerate(wl[i:i + slots]):
            batch[j, :len(w.prompt)] = w.prompt
        out = np.asarray(jst.generate(batch, a.max_new).tokens)
        want += [out[j].tolist() for j in range(len(wl[i:i + slots]))]
    assert sstreams == want


@pytest.mark.parametrize("bench", ["prefill", "kv_int8"])
def test_bench_records_carry_reference_fields_and_passed_commit(
        bench, monkeypatch):
    monkeypatch.setenv(provenance.COMMIT_ENV, "0123abc")
    if bench == "prefill":
        args = prefill_paged_bench.parse_args(["--smoke", "--device", "cpu"])
        rec = prefill_paged_bench.record(args, torch.device("cpu"), 0.5,
                                         0.2)
        want = {"bench", "provenance", "workload", "backend", "dense",
                "chunked", "ratio_dense_over_chunked", "greedy_equal"}
        assert rec["ratio_dense_over_chunked"] == 2.5
    else:
        args = kv_int8_bench.parse_args(["--smoke", "--device", "cpu"])
        rec = kv_int8_bench.record(
            args, torch.device("cpu"), 49152, 11, 11 / 6,
            {"bf16": [0.03], "int8": [0.02]}, {"bf16": 1000.0, "int8": 1500.0},
            1.5, False, 0.75, 1, 0.0018, 0.0261)
        want = {"bench", "provenance", "workload", "backend",
                "hbm_budget_bytes", "capacity_ratio_int8_over_bf16", "bf16",
                "int8", "tok_s_ratio_int8_over_bf16", "greedy_equal",
                "greedy_agreement", "divergences_excused_as_near_ties",
                "max_excused_flip_gap", "max_prefill_logit_error"}
        assert rec["capacity_ratio_int8_over_bf16"] == 1.833
    # the reference's record keys, by its source
    src = open({"prefill": jax_prefill,
                "kv_int8": jax_int8}[bench].__file__).read()
    assert all(f'"{k}":' in src for k in want)
    assert set(rec) == want and rec["backend"] == "cpu"
    prov = rec["provenance"]
    assert prov["git_commit"] == "0123abc"
    assert prov["measurement_mode"] == "cpu-plain"
    assert {"timestamp_utc", "torch_version", "cuda_version", "card_name",
            "card_power_limit", "platform", "python"} <= set(prov)
    monkeypatch.delenv(provenance.COMMIT_ENV)
    assert provenance.git_commit() != "0123abc"
