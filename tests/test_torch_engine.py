"""The port's ContinuousEngine on the CPU against the JAX package's
ContinuousEngine: the same weights (the JAX init, bridged through numpy),
the same prompts, driven step for step.

Held EXACTLY equal: greedy token streams, every request's block table,
every block's refcount and the free-list size after every step; the port's
pool/tree invariants hold after every step. Paths: one-shot prefill,
chunked prefill (``prefill_chunk=8``), prefix-cache hits (a shared-prefix
resubmit whose matched tail block is copied on write, and a multi-turn
follow-up), and preempt-readmit (the youngest decoding request is
preempted in both engines and recomputed on readmission). Pools: the
config's float32, bfloat16 and int8.
"""
import jax
import numpy as np
import pytest

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ContinuousEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import (ContinuousEngine, check_invariants,
                               leaked_blocks)

BS = 8


@pytest.fixture(scope="module", params=["llama3.2-3b", "qwen3-4b"])
def model(request):
    jcfg = jax_reduce_config(jax_get_config(request.param))
    tcfg = reduce_config(get_config(request.param))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _preempt_youngest(eng):
    victims = [r for r in eng.sched.running if r.state == "decoding"]
    eng.sched._preempt(victims[-1])
    return victims[-1].req_id


def _lockstep(jeng, teng, preempt_at=None):
    """Step both engines together, holding the pool bookkeeping equal."""
    step = 0
    while jeng.sched.has_work():
        assert teng.sched.has_work()
        if step == preempt_at:
            assert _preempt_youngest(jeng) == _preempt_youngest(teng)
        jeng.step()
        teng.step()
        assert jeng.pool._tables == teng.pool._tables, f"step {step}"
        np.testing.assert_array_equal(jeng.pool._ref, teng.pool._ref)
        assert jeng.pool.num_free == teng.pool.num_free
        check_invariants(teng.pool, teng.prefix_cache)
        step += 1
    assert not teng.sched.has_work()
    return jeng.run(), teng.run()


def _assert_same_streams(jres, tres):
    assert sorted(jres) == sorted(tres)
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, f"request {rid}"
        assert len(tres[rid].tokens) == tres[rid].max_new


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8"])
@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_greedy_streams_and_tables_match_jax(model, kv_dtype, prefill_chunk):
    jcfg, tcfg, jparams, tparams = model
    kw = dict(block_size=BS, num_blocks=40, max_batch=4, max_len=64,
              prefill_chunk=prefill_chunk, kv_dtype=kv_dtype)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    rng = np.random.default_rng(11)
    V = tcfg.vocab_size
    prompts = [rng.integers(1, V, n).astype(np.int32)
               for n in (13, 21, 9, 30)]

    # one-shot or chunked cold prefills, with a preemption mid-decode
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, 8)
    jres, tres = _lockstep(jeng, teng, preempt_at=3)
    _assert_same_streams(jres, tres)

    # prefix hits: a resubmit sharing 11 tokens (its partial tail block is
    # copied on write), a full-prompt hit with a new suffix, and a
    # multi-turn follow-up extending [prompt ‖ reply]
    turn = np.concatenate([prompts[1], np.asarray(tres[1].tokens[:-1],
                                                  np.int32),
                           rng.integers(1, V, 3).astype(np.int32)])
    second = [np.concatenate([prompts[0][:11],
                              rng.integers(1, V, 6).astype(np.int32)]),
              np.concatenate([prompts[3],
                              rng.integers(1, V, 4).astype(np.int32)]),
              turn]
    for eng in (jeng, teng):
        for p in second:
            eng.submit(p, 6)
    jres, tres = _lockstep(jeng, teng)
    _assert_same_streams(jres, tres)
    assert teng.metrics.prefix_hit_tokens == jeng.metrics.prefix_hit_tokens
    assert teng.metrics.prefix_hit_tokens > 0
    assert teng.metrics.cow_copies == jeng.metrics.cow_copies > 0
    assert leaked_blocks(teng.pool, teng.prefix_cache) == 0


def test_warmup_leaves_a_fresh_engine(model):
    """warmup() runs a synthetic request and resets: the metrics start at
    zero and the greedy streams equal those of an engine without warmup."""
    _, tcfg, _, tparams = model
    kw = dict(block_size=BS, num_blocks=40, max_batch=4, max_len=64,
              prefill_chunk=8, device="cpu")
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (9, 17)]
    streams = []
    for warm in (False, True):
        eng = ContinuousEngine(tcfg, tparams, **kw)
        if warm:
            eng.warmup()
            assert eng.metrics.steps == 0 and eng.pool.num_free == 40
        for p in prompts:
            eng.submit(p, 5)
        streams.append([r.tokens for _, r in sorted(eng.run().items())])
    assert streams[0] == streams[1]


def test_temperature_sampling_reproducible_from_the_seed(model):
    """Sampled streams cannot be held to JAX's (different generators); they
    are reproducible from the engine's seed and stay in the vocabulary."""
    _, tcfg, _, tparams = model
    runs = []
    for seed in (5, 5, 6):
        eng = ContinuousEngine(tcfg, tparams, block_size=BS, num_blocks=40,
                               max_batch=2, max_len=64, seed=seed,
                               device="cpu")
        eng.submit(np.arange(1, 12, dtype=np.int32), 12, temperature=1.0)
        eng.submit(np.arange(3, 9, dtype=np.int32), 12)
        runs.append([r.tokens for _, r in sorted(eng.run().items())])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(0 <= t < tcfg.vocab_size for r in runs for s in r for t in s)


@pytest.mark.parametrize("kv_dtype", [None, "bf16"])
def test_flash_one_shot_prefill_matches_jax(model, kv_dtype):
    """``attention_impl="flash"``: one-shot prefill runs the dense
    flash-attention op (the JAX side its Pallas kernel in interpret mode,
    the port its plain version on CPU tensors); greedy streams and block
    tables are exactly equal, with a float32 and a bfloat16 pool."""
    jcfg, tcfg, jparams, tparams = model
    jcfg = jcfg.replace(attention_impl="flash", interpret_kernels=True)
    tcfg = tcfg.replace(attention_impl="flash")
    kw = dict(block_size=BS, num_blocks=40, max_batch=4, max_len=48,
              kv_dtype=kv_dtype)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in (13, 21, 30)]
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, 6)
    jres, tres = _lockstep(jeng, teng)
    _assert_same_streams(jres, tres)
