"""The port's paged and static engines serving the MoE family on the CPU,
against the JAX package's engines: reduced moonshot-v1-16b-a3b (8 experts
of 32, top-2), the JAX init bridged through numpy, the same prompts.

Held EXACTLY equal, step for step (``tests/test_torch_engine.py``'s
``_lockstep``): greedy token streams, every request's block table, every
block's refcount and the free-list size, with float32, bfloat16 and int8
pools, one-shot and chunked prefill (``prefill_chunk`` 0 and 8), a
preemption and a prefix-hit resubmit. The capacity of a MoE call couples
its tokens (padding rows included), so these equalities also hold the
port to the reference's row layout at every call site; one run at a
capacity factor of 0.5 drops assignments in every prefill (T·k > E·C,
checked), and its streams are equal too. The static engine's greedy
streams equal the JAX static engine's (float32 and int8 caches).
``paged_prefill_audit`` of the MoE model: both logits within 1e-5 of
their largest magnitude, the counters and the ceil'd IntMax EXACTLY
equal, ``kv_amax_max`` within 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.paged_step import paged_prefill_audit as jax_audit
from repro_torch.bridge import params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.models.schema import unstack_layers
from repro_torch.serve import (ContinuousEngine, ServeEngine,
                               check_invariants, leaked_blocks)
from repro_torch.serve import paged_step

ARCH = "moonshot-v1-16b-a3b"
BS = 8


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    tcfg = reduce_config(get_config(ARCH))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _lockstep(jeng, teng, preempt_at=None):
    """Step both engines together, holding the pool bookkeeping equal."""
    step = 0
    while jeng.sched.has_work():
        assert teng.sched.has_work()
        if step == preempt_at:
            for eng in (jeng, teng):
                victims = [r for r in eng.sched.running
                           if r.state == "decoding"]
                eng.sched._preempt(victims[-1])
        jeng.step()
        teng.step()
        assert jeng.pool._tables == teng.pool._tables, f"step {step}"
        np.testing.assert_array_equal(jeng.pool._ref, teng.pool._ref)
        assert jeng.pool.num_free == teng.pool.num_free
        check_invariants(teng.pool, teng.prefix_cache)
        step += 1
    assert not teng.sched.has_work()
    jres, tres = jeng.run(), teng.run()
    assert sorted(jres) == sorted(tres)
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, f"request {rid}"
        assert len(tres[rid].tokens) == tres[rid].max_new
    return tres


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
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, 6)
    _lockstep(jeng, teng, preempt_at=3)

    # prefix hits: a resubmit sharing 11 tokens (its tail block copied on
    # write) and a full-prompt hit with a new suffix
    second = [np.concatenate([prompts[0][:11],
                              rng.integers(1, V, 6).astype(np.int32)]),
              np.concatenate([prompts[3],
                              rng.integers(1, V, 4).astype(np.int32)])]
    for eng in (jeng, teng):
        for p in second:
            eng.submit(p, 4)
    _lockstep(jeng, teng)
    assert teng.metrics.prefix_hit_tokens == \
        jeng.metrics.prefix_hit_tokens > 0
    assert teng.metrics.cow_copies == jeng.metrics.cow_copies > 0
    assert leaked_blocks(teng.pool, teng.prefix_cache) == 0


@pytest.mark.parametrize("prefill_chunk", [0, 40])
def test_dropping_capacity_matches_jax(model, prefill_chunk):
    """capacity_factor 0.5: every prefill call of these prompts has more
    assignments than slots, so the reference drops some; the streams and
    tables are still EXACTLY equal."""
    jcfg, tcfg, jparams, tparams = model
    jcfg, tcfg = (c.replace(moe=dataclasses.replace(c.moe,
                                                    capacity_factor=0.5))
                  for c in (jcfg, tcfg))
    m = tcfg.moe
    rng = np.random.default_rng(5)
    lens = (72, 45)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    for n in lens:       # every call's T: the padded prompt, or a chunk
        T = prefill_chunk or -(-n // BS) * BS
        assert T * m.top_k > m.n_experts * tmoe.capacity(T, tcfg)
    kw = dict(block_size=BS, num_blocks=24, max_batch=2, max_len=80,
              prefill_chunk=prefill_chunk)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, 5)
    _lockstep(jeng, teng)


@pytest.mark.parametrize("over", [{}, {"opt_int8_kv": True}],
                         ids=["f32", "int8"])
def test_static_engine_matches_jax(model, over):
    jcfg, tcfg, jparams, tparams = model
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    prompts = np.random.default_rng(3).integers(
        1, tcfg.vocab_size, (3, 20)).astype(np.int32)
    want = JaxServeEngine(jcfg, jparams, max_len=28).generate(prompts, 8)
    got = ServeEngine(tcfg, tparams, max_len=28, device="cpu").generate(
        prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("n", [1, 16])
def test_paged_prefill_audit_matches_jax(model, n):
    jcfg, tcfg, jparams, tparams = model
    toks = np.random.default_rng(n).integers(1, tcfg.vocab_size, (1, n)) \
        .astype(np.int32)
    jref, jq, jstats = jax_audit(jparams, jnp.asarray(toks),
                                 jnp.asarray([n - 1], jnp.int32), jcfg)
    tref, tq, tstats = paged_step.paged_prefill_audit(
        unstack_layers(tparams), torch.as_tensor(toks),
        torch.tensor([n - 1], dtype=torch.int32), tcfg)
    for got, want in ((tref, jref), (tq, jq)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert set(tstats) == set(jstats)
    for k in ("intmax_overflow_rows", "score_inp_clip_vals",
              "kv_scale_sat_rows", "score_intmax_max"):
        assert float(tstats[k]) == float(jstats[k]), k
    assert float(tstats["kv_amax_max"]) == pytest.approx(
        float(jstats["kv_amax_max"]), rel=1e-6)
