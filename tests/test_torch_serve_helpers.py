"""The serving engine's reporting helpers against the JAX package's, and
the launcher's summary.

* Pool and radix tree: both packages' ``PagedKVCache`` and ``RadixCache``
  are driven in lockstep through one seeded sequence of admit (plan,
  admit with a copy-on-write tail, alloc, insert), publish-longer (decode
  growth by ``append_block``, then insert), share, plain alloc, release,
  ``evict(n)`` and ``purge`` (then release) calls. After every call the
  return value, ``lookup`` of probe prompts, ``CacheStats`` (with
  ``hit_rate`` and ``purged_blocks``), ``evictable_blocks``,
  ``num_shared``, ``can_alloc``, both ``utilization``s, the block tables,
  refcounts and free list are EXACTLY equal, and the port's invariants
  hold.
* ``PagedKVCache.bytes_per_block``: EXACTLY equal for auto/bf16/int8 at a
  reduced config and at llama3.2-3b's full width.
* ``EngineMetrics``: a prefix-sharing run of each package's engine on the
  same (bridged) weights; the counters are EXACTLY equal, and
  ``tok_per_s``, ``prefill_savings`` and ``shared_blocks_peak`` are held
  to their definitions on them (``prefill_savings`` equal to the JAX
  engine's).
  The fields are the reference's minus its seven resilience counters, in
  its order; after a prefix-sharing run of both engines on one
  ``ManualClock`` each and after ``warmup()``, every shared value is
  EXACTLY equal for bfloat16 and int8 pools (the pool's dtype name, token
  capacity and bytes included).
* ``MatchResult.n_full_blocks``: EXACTLY the reference's on matches of
  full, partial, tail-only and missing prefixes.
* The launcher: ``--optimized`` applies ``cfg.with_opts(True)`` (an int8
  pool) and the paged run logs the reference's end-of-run lines; with
  ``--telemetry --metrics-out --trace-out --numerics-every 1 --kv-dtype
  int8`` it writes both files and logs the reference's quantile and
  numerics lines.
"""
import dataclasses
import json
import logging

import jax
import numpy as np
import pytest

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import EngineMetrics as JaxMetrics
from repro.serve import ManualClock as JaxClock
from repro.serve.kv_pool import PagedKVCache as JaxPool
from repro.serve.kv_pool import PoolExhausted as JaxExhausted
from repro.serve.radix_cache import RadixCache as JaxRadix
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import (ContinuousEngine, EngineMetrics, ManualClock,
                               PagedKVCache, PoolExhausted, RadixCache,
                               check_invariants, parse_prometheus_text)

BS, NB = 4, 24


def _reading(pool, cache, probes):
    return dict(
        lookup=[cache.lookup(p) for p in probes],
        stats=dataclasses.asdict(cache.stats),
        hit_rate=cache.stats.hit_rate,
        evictable=cache.evictable_blocks(),
        cached=cache.cached_blocks,
        num_shared=pool.num_shared,
        can_alloc=[pool.can_alloc(k) for k in range(NB + 2)],
        utilization=pool.utilization,
        stats_utilization=pool.stats.utilization,
        pool_stats=dataclasses.asdict(pool.stats),
        tables={r: list(map(int, t)) for r, t in pool._tables.items()},
        refs=[int(x) for x in pool._ref],
        free=list(map(int, pool._free)),
    )


def _admit(pool, cache, exhausted, rid, toks, with_plan):
    need = pool.blocks_for(len(toks))
    plan = cache.plan(toks)
    try:
        hit = cache.admit(rid, toks, ensure_free=need - plan.n_shared,
                          plan=plan if with_plan else None)
    except exhausted:
        return "exhausted"
    spliced = pool.n_blocks_of(rid)
    if need > spliced:
        pool.alloc(rid, need - spliced)
    return hit, cache.insert(rid, toks)


def _grow(pool, cache, rid, toks, extra):
    """Decode growth: blocks appended as the request crosses boundaries,
    then the longer sequence published."""
    for n in range(len(toks) + 1, len(toks) + len(extra) + 1):
        if pool.blocks_for(n) > pool.n_blocks_of(rid):
            pool.append_block(rid)
    return cache.insert(rid, np.concatenate([toks, extra]).astype(np.int32))


@pytest.fixture(scope="module")
def cfgs():
    return (jax_reduce_config(jax_get_config("llama3.2-3b")),
            reduce_config(get_config("llama3.2-3b")))


@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_tree_helpers_match_jax_exactly(cfgs, seed, policy):
    jcfg, tcfg = cfgs
    jpool = JaxPool(jcfg, NB, BS)
    tpool = PagedKVCache(tcfg, NB, BS, device="cpu")
    sides = [(jpool, JaxRadix(jpool, policy), JaxExhausted),
             (tpool, RadixCache(tpool, policy), PoolExhausted)]
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 40, 14).astype(np.int32) for _ in range(3)]
    probes = [np.concatenate([h, [7, 7]]).astype(np.int32) for h in heads]
    running = {}                       # rid -> published tokens
    unpublished = set()                # shared/plain-alloc tables
    next_rid = 0
    kinds = ("admit", "admit", "grow", "share", "alloc", "release",
             "evict", "purge")
    n_kinds = {k: 0 for k in kinds}

    def check(step, kind, outs):
        half = len(outs) // 2
        assert outs[:half] == outs[half:], f"step {step} {kind}: {outs}"
        ja, ta = (_reading(p, c, probes) for p, c, _ in sides)
        assert ta == ja, f"step {step} {kind}"
        check_invariants(tpool, sides[1][1])

    for step in range(80):
        kind = kinds[rng.integers(len(kinds))]
        growable = sorted(set(running) - unpublished)
        if kind in ("grow", "release", "purge") and not growable:
            kind = "admit"
        outs = []
        if kind == "admit":
            h = heads[rng.integers(3)]
            toks = np.concatenate([h[:rng.integers(3, 15)],
                                   rng.integers(1, 40, rng.integers(1, 7))]
                                  ).astype(np.int32)
            with_plan = bool(rng.integers(2))
            for pool, cache, exc in sides:
                outs.append(_admit(pool, cache, exc, next_rid, toks,
                                   with_plan))
            if outs[0] != "exhausted":
                running[next_rid] = toks
            else:
                for pool, cache, _ in sides:
                    if next_rid in pool._tables:
                        cache.release(next_rid)
            next_rid += 1
        elif kind == "grow":
            rid = growable[rng.integers(len(growable))]
            extra = rng.integers(1, 40, rng.integers(1, 6)).astype(np.int32)
            if sides[1][0].num_free < 2:
                kind = "evict"
            else:
                for pool, cache, _ in sides:
                    outs.append(_grow(pool, cache, rid, running[rid], extra))
                running[rid] = np.concatenate([running[rid], extra])
        elif kind == "share" and running:
            src = sorted(running)[rng.integers(len(running))]
            k = int(rng.integers(1, sides[1][0].n_blocks_of(src) + 1))
            for pool, cache, _ in sides:
                pool.share(next_rid, pool.blocks_of(src)[:k])
                outs.append(pool.n_blocks_of(next_rid))
            running[next_rid] = np.zeros((0,), np.int32)
            unpublished.add(next_rid)
            next_rid += 1
        elif kind == "alloc":
            n = int(rng.integers(1, 4))
            for pool, cache, _ in sides:
                outs.append(pool.can_alloc(n))
                if pool.can_alloc(n):
                    outs.append(len(pool.alloc(next_rid, n)))
            if outs[0]:
                running[next_rid] = np.zeros((0,), np.int32)
                unpublished.add(next_rid)
            next_rid += 1
        elif kind == "release":
            rid = sorted(running)[rng.integers(len(running))]
            for pool, cache, _ in sides:
                outs.append(cache.release(rid))
            del running[rid]
        elif kind == "purge":
            rid = sorted(running)[rng.integers(len(running))]
            for pool, cache, _ in sides:
                outs.append((cache.purge(rid), cache.release(rid)))
            del running[rid]
        if kind == "evict" or (kind == "share" and not outs):
            kind = "evict"
            n = int(rng.integers(1, 5))
            for pool, cache, _ in sides:
                outs.append(cache.evict(n))
        n_kinds[kind] += 1
        check(step, kind, outs)
    # drain: every request leaves, then the unpinned tree is evicted
    for rid in sorted(running):
        check("end", "release", [c.release(rid) for _, c, _ in sides])
    while sides[1][1].cached_blocks:
        check("end", "evict", [c.evict(3) for _, c, _ in sides])
    assert tpool.num_free == NB
    # the sequence reached every call, and the counters it reports moved
    assert all(n_kinds.values()), n_kinds
    stats = sides[1][1].stats
    assert stats.hit_tokens and stats.evictions and stats.purged_blocks
    assert tpool.stats.cow_copies and tpool.stats.peak_shared


@pytest.mark.parametrize("arch, reduced", [("llama3.2-3b", True),
                                           ("qwen3-4b", True),
                                           ("llama3.2-3b", False)])
@pytest.mark.parametrize("block_size", [8, 16])
def test_bytes_per_block_matches_jax_exactly(arch, reduced, block_size):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg = jax_reduce_config(jcfg).replace(head_dim=64)
        tcfg = reduce_config(tcfg).replace(head_dim=64)
    for kv in ("auto", "bf16", "int8"):
        want = JaxPool.bytes_per_block(jcfg, block_size, kv)
        assert PagedKVCache.bytes_per_block(tcfg, block_size, kv) == want
    # the unit the int8 bench sizes its pools in: 2 Dh / (Dh + 4)
    Dh = tcfg.head_dim_
    assert PagedKVCache.bytes_per_block(tcfg, block_size, "bf16") / \
        PagedKVCache.bytes_per_block(tcfg, block_size, "int8") == \
        2 * Dh / (Dh + 4)


@pytest.fixture(scope="module")
def metric_runs():
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b"))
    tcfg = reduce_config(get_config("llama3.2-3b"))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(4)
    head = rng.integers(1, tcfg.vocab_size, 19).astype(np.int32)
    waves = [[np.concatenate([head, rng.integers(1, tcfg.vocab_size, n)])
              .astype(np.int32) for n in ns] for ns in ((5, 9), (3, 7, 11))]
    kw = dict(block_size=8, num_blocks=40, max_batch=3, max_len=48)
    engines = (JaxEngine(jcfg, jparams, **kw),
               ContinuousEngine(tcfg, tparams, device="cpu", **kw))
    streams = []
    for eng in engines:
        out = []
        for wave in waves:
            hs = [eng.submit(p, 5) for p in wave]
            res = eng.run()
            out += [res[h.req_id].tokens for h in hs]
        streams.append(out)
    return engines, streams


def test_engine_metrics_match_jax(metric_runs):
    (jeng, teng), (jstreams, tstreams) = metric_runs
    assert tstreams == jstreams
    jm, tm = jeng.metrics, teng.metrics
    for name in ("decode_steps", "prefills", "prefill_chunks",
                 "preemptions", "tokens_out", "tokens_discarded",
                 "peak_blocks", "prefill_tokens", "prefix_hit_tokens",
                 "cow_copies", "shared_blocks_peak"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.prefix_hit_tokens > 0 and tm.shared_blocks_peak > 0
    assert tm.shared_blocks_peak == teng.pool.stats.peak_shared
    assert tm.prefill_savings == jm.prefill_savings
    assert tm.prefill_savings == \
        (tm.prefill_tokens + tm.prefix_hit_tokens) / tm.prefill_tokens > 1
    assert tm.wall_s > 0 and tm.tok_per_s == \
        (tm.tokens_out - tm.tokens_discarded) / tm.wall_s
    assert teng.prefix_cache.stats.hit_rate == \
        jeng.prefix_cache.stats.hit_rate > 0


@pytest.mark.parametrize("counters", [
    dict(),
    dict(tokens_out=10, tokens_discarded=4, wall_s=2.0),
    dict(tokens_out=7, wall_s=0.0, prefill_tokens=0, prefix_hit_tokens=5),
    dict(tokens_out=33, tokens_discarded=1, wall_s=0.37,
         prefill_tokens=96, prefix_hit_tokens=288)])
def test_engine_metrics_properties_match_jax_on_given_counters(counters):
    jm, tm = JaxMetrics(**counters), EngineMetrics(**counters)
    assert tm.tok_per_s == jm.tok_per_s
    assert tm.prefill_savings == jm.prefill_savings


@pytest.mark.parametrize("optimized", [False, True])
def test_launcher_summary_and_optimized(caplog, optimized):
    argv = ["--engine", "paged", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "20", "--max-new", "4", "--block-size",
            "8", "--num-blocks", "24", "--prefill-chunk", "8"]
    assert launch_serve.parse_args(argv).optimized is False
    if optimized:
        argv.append("--optimized")
    caplog.set_level(logging.INFO, logger="repro_torch.launch.serve")
    launch_serve.main(argv)
    text = caplog.text
    assert ("kv pool[int8]" in text) == optimized
    assert ("kv pool[float32]" in text) != optimized
    assert "% of 24), preemptions=0" in text
    assert "chunked prefill[8]: 6 chunks over 2 prefills (40 prompt " \
        "tokens computed)" in text
    assert "prefix cache[lru]: hit 0/40 prompt tokens (0%), " in text
    assert "prefill savings 1.00x" in text


RESILIENCE = ("cancelled", "deadline_misses", "quarantined", "shed",
              "faults_injected", "transient_retries", "readback_audits")


def test_engine_metrics_fields_are_the_references_but_resilience():
    """Every field of the reference's ``EngineMetrics``, in its order, the
    seven resilience counters included since the resilience layer is
    ported."""
    want = [f.name for f in dataclasses.fields(JaxMetrics)]
    assert [f.name for f in dataclasses.fields(EngineMetrics)] == want
    assert set(RESILIENCE) <= set(want)
    for f, jf in zip(dataclasses.fields(EngineMetrics),
                     dataclasses.fields(JaxMetrics)):
        assert (f.type, f.default) == (jf.type, jf.default), f.name


@pytest.fixture(scope="module")
def llama_bridged():
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b"))
    tcfg = reduce_config(get_config("llama3.2-3b"))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_engine_metrics_values_match_jax_exactly(llama_bridged, kv):
    jcfg, tcfg, jparams, tparams = llama_bridged
    rng = np.random.default_rng(4)
    head = rng.integers(1, tcfg.vocab_size, 19).astype(np.int32)
    wave = [np.concatenate([head, rng.integers(1, tcfg.vocab_size, n)])
            .astype(np.int32) for n in (5, 9, 3)]
    kw = dict(block_size=8, num_blocks=40, max_batch=2, max_len=48,
              kv_dtype=kv)
    jeng = JaxEngine(jcfg, jparams, clock=JaxClock(tick=1e-4), **kw)
    teng = ContinuousEngine(tcfg, tparams, clock=ManualClock(tick=1e-4),
                            device="cpu", **kw)

    def shared():
        t = dataclasses.asdict(teng.metrics)
        j = dataclasses.asdict(jeng.metrics)
        return t, {k: j[k] for k in t}

    for eng in (jeng, teng):
        for p in wave:
            eng.submit(p, 5)
        eng.run()
    t, j = shared()
    assert t == j
    assert t["prefix_hit_tokens"] > 0 and t["cache_evictions"] == \
        teng.prefix_cache.stats.evictions
    assert t["kv_dtype"] == {"bf16": "bfloat16", "int8": "int8"}[kv]
    assert t["kv_pool_bytes"] == teng.pool.hbm_bytes
    assert t["pool_token_capacity"] == 40 * 8
    for eng in (jeng, teng):
        eng.warmup()
    t, j = shared()
    assert t == j and t["steps"] == 0 and t["kv_pool_bytes"] > 0


def test_match_result_full_blocks_match_jax(cfgs):
    jcfg, tcfg = cfgs
    jpool, tpool = JaxPool(jcfg, NB, BS), PagedKVCache(tcfg, NB, BS,
                                                       device="cpu")
    jtree, ttree = JaxRadix(jpool), RadixCache(tpool)
    rng = np.random.default_rng(9)
    a = rng.integers(1, 40, 18).astype(np.int32)
    b = np.concatenate([a[:6], rng.integers(1, 40, 7)]).astype(np.int32)
    for rid, toks in enumerate((a, b)):
        for pool, tree in ((jpool, jtree), (tpool, ttree)):
            tree.admit(rid, toks, ensure_free=pool.blocks_for(len(toks)))
            pool.alloc(rid, pool.blocks_for(len(toks)) -
                       pool.n_blocks_of(rid))
            tree.insert(rid, toks)
    probes = [a, a[:9], a[:4], b, np.concatenate([b, [5, 5, 5]]),
              rng.integers(41, 60, 12)]
    got = [ttree.plan(p.astype(np.int32)).match.n_full_blocks
           for p in probes]
    assert got == [jtree.plan(p.astype(np.int32)).match.n_full_blocks
                   for p in probes]
    assert got[0] > 0 and got[-1] == 0 and len(set(got)) > 2


def test_launcher_telemetry_sinks(caplog, capsys, tmp_path):
    prom, trace = tmp_path / "x.prom", tmp_path / "t.json"
    argv = ["--engine", "paged", "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "20", "--max-new", "4", "--block-size",
            "8", "--num-blocks", "24", "--telemetry", "--metrics-out",
            str(prom), "--trace-out", str(trace), "--numerics-every", "1",
            "--kv-dtype", "int8"]
    caplog.set_level(logging.INFO, logger="repro_torch.launch.serve")
    launch_serve.main(argv)
    text = caplog.text
    for nm in ("ttft", "tpot", "e2e"):
        assert f"{nm}: p50 " in text and " p99 " in text
    assert "tpot: p50 " in text and "(n=6)" in text
    assert "numerics: max |full - int8| logit delta " in text
    assert "over 2 probes" in text
    assert "kernel cost: " in text and "MiB gather DMA" in text
    assert f"metrics -> {prom}" in text and f"step timeline -> {trace}" \
        in text
    fams = parse_prometheus_text(prom.read_text())
    assert fams["numerics_probes_total"]["samples"][0][2] == 2.0
    assert fams["serve_requests_finished_total"]["samples"][0][2] == 2.0
    events = json.loads(trace.read_text())["traceEvents"]
    assert {e["name"] for e in events if e["ph"] == "X"} >= \
        {"step", "prefill", "decode", "drain"}
    assert "# final metric registry" not in capsys.readouterr().out
    # no sink: the exposition goes to stdout
    launch_serve.main(argv[:15] + ["--telemetry"])
    out = capsys.readouterr().out
    assert out.startswith("# final metric registry")
    assert "serve_ttft_seconds_count 2" in out
