"""Each step function of the port's ``serve/paged_step`` against the JAX
package's, on the same weights (the JAX init bridged through numpy), the
same pools and the same tables, for reduced llama3.2-3b and reduced
qwen3-4b (the QK-norm branch).

Tolerances: logits ``atol`` 1e-4 (float32 through several layers, sums in
another order); computed K/V rows and float32 pools after a write within
``max(1e-5, 4e-6 * max|reference|)`` (rows reach magnitudes of ~20, and a
small entry of a sum of such terms carries their float32 rounding, ~2e-6
each); int8 pool codes equal except ±1 where a row's
value sits at a rounding tie, on at most 0.1% of the entries (counted and
asserted), int8 scales ``rtol`` 1e-5.
The JAX steps return new pools; the port's write the same pools in place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import paged_step as jstep
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import paged_step as tstep

BS, N = 8, 12


@pytest.fixture(scope="module", params=["llama3.2-3b", "qwen3-4b"])
def model(request):
    jcfg = jax_reduce_config(jax_get_config(request.param))
    tcfg = reduce_config(get_config(request.param))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(rng, cfg, int8):
    """Random (k, v[, k_scale, v_scale]) pools as numpy arrays."""
    shape = (cfg.n_layers, N + 1, cfg.n_kv_heads, BS, cfg.head_dim_)
    if not int8:
        return [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    codes = [rng.integers(-127, 128, shape).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
              for _ in range(2)]
    return codes + scales


def _split(pools):
    return pools[:2], (dict(k_scale=pools[2], v_scale=pools[3])
                       if len(pools) == 4 else {})


def _assert_pools_close(tpools, jpools):
    for t, j in zip(tpools, jpools):
        t, j = t.numpy(), np.asarray(j)
        if t.dtype == np.int8:
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1
            assert np.count_nonzero(diff) <= 1e-3 * diff.size
        elif t.ndim == 4:                       # int8 scale pools
            np.testing.assert_allclose(t, j, rtol=1e-5)
        else:
            _close_kv(t, j)


def _close_kv(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert np.abs(t - j).max() <= max(1e-5, 4e-6 * np.abs(j).max())


def _close_logits(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


@pytest.mark.parametrize("kv_quantize", [False, True])
def test_prefill_and_scatter_match_jax(model, kv_quantize):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, tcfg.vocab_size, (1, 2 * BS)).astype(np.int32)
    last = np.array([2 * BS - 3], np.int32)
    jlg, jks, jvs = jstep.paged_prefill(jp, jnp.asarray(tokens),
                                        jnp.asarray(last), jcfg,
                                        kv_quantize=kv_quantize)
    tlg, tks, tvs = tstep.paged_prefill(tp, _t(tokens), _t(last), tcfg,
                                        kv_quantize=kv_quantize)
    _close_logits(tlg, jlg)
    _close_kv(tks, jks)
    _close_kv(tvs, jvs)

    pools = _pools(rng, tcfg, kv_quantize)
    blocks = np.array([7, 3], np.int32)
    (jk, jv), jsc = _split([jnp.asarray(p) for p in pools])
    jout = jstep.scatter_prefill(jk, jv, jks, jvs, jnp.asarray(blocks),
                                 **jsc)
    tpools = [_t(p) for p in pools]
    (tk, tv), tsc = _split(tpools)
    tstep.scatter_prefill(tk, tv, _t(np.asarray(jks)), _t(np.asarray(jvs)),
                          _t(blocks), **tsc)
    _assert_pools_close(tpools, jout)


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_suffix_and_offset_scatter_match_jax(model, int8):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(2)
    pools = _pools(rng, tcfg, int8)
    m = 11                                      # cached prefix, mid-block
    tokens = rng.integers(1, tcfg.vocab_size, (1, BS)).astype(np.int32)
    table = np.array([[4, 9]], np.int32)
    plen = np.array([m], np.int32)
    last = np.array([5], np.int32)
    (jk, jv), jsc = _split([jnp.asarray(p) for p in pools])
    jlg, jks, jvs = jstep.paged_prefill_suffix(
        jp, jnp.asarray(tokens), jnp.asarray(m, jnp.int32),
        jnp.asarray(last), jk, jv, jnp.asarray(table), jnp.asarray(plen),
        jcfg, **jsc)
    tpools = [_t(p) for p in pools]
    (tk, tv), tsc = _split(tpools)
    tlg, tks, tvs = tstep.paged_prefill_suffix(
        tp, _t(tokens), m, _t(last), tk, tv, _t(table), _t(plen), tcfg,
        **tsc)
    _close_logits(tlg, jlg)
    _close_kv(tks, jks)
    _close_kv(tvs, jvs)

    pos = m + np.arange(BS)
    blk = np.where(pos < 2 * BS, np.array([4, 9])[pos // BS % 2], 0)
    blk = blk.astype(np.int32)
    off = (pos % BS).astype(np.int32)
    blk[6:] = 0                                 # pad rows -> block 0
    jout = jstep.scatter_prefill_offset(jk, jv, jks, jvs, jnp.asarray(blk),
                                        jnp.asarray(off), **jsc)
    tstep.scatter_prefill_offset(tk, tv, _t(np.asarray(jks)),
                                 _t(np.asarray(jvs)), _t(blk), _t(off),
                                 **tsc)
    # block 0 takes duplicate pad writes in either order: compare the rest
    _assert_pools_close([p[:, 1:] for p in tpools],
                        [np.asarray(p)[:, 1:] for p in jout])


@pytest.mark.parametrize("int8", [False, True])
def test_prefill_chunk_matches_jax(model, int8):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    pools = _pools(rng, tcfg, int8)
    C, pos0 = 2 * BS, 3 * BS                    # a chunk after 3 blocks
    tokens = rng.integers(1, tcfg.vocab_size, (1, C)).astype(np.int32)
    table = np.array([[2, 8, 5, 11, 6]], np.int32)
    cover = -(-(pos0 + C - 3) // BS)
    table = np.concatenate([table[:, :cover],
                            np.zeros((1, 6 - cover), np.int32)], 1)
    pos = pos0 + np.arange(C)
    blk = table[0][pos // BS].astype(np.int32)
    off = (pos % BS).astype(np.int32)
    blk[C - 3:] = 0                             # ragged final chunk
    last = np.array([C - 4], np.int32)
    (jk, jv), jsc = _split([jnp.asarray(p) for p in pools])
    jout = jstep.paged_prefill_chunked(
        jp, jnp.asarray(tokens), jnp.asarray(pos0, jnp.int32),
        jnp.asarray(last), jk, jv, jnp.asarray(table), jnp.asarray(blk),
        jnp.asarray(off), jcfg, **jsc)
    tpools = [_t(p) for p in pools]
    (tk, tv), tsc = _split(tpools)
    tlg = tstep.paged_prefill_chunked(
        tp, _t(tokens), pos0, _t(last), tk, tv, _t(table), _t(blk),
        _t(off), tcfg, **tsc)
    _close_logits(tlg, jout[0])
    _assert_pools_close([p[:, 1:] for p in tpools],
                        [np.asarray(p)[:, 1:] for p in jout[1:]])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tile,split", [(1, 1), (2, 3)])
def test_decode_step_matches_jax(model, int8, tile, split):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(4)
    pools = _pools(rng, tcfg, int8)
    tokens1 = rng.integers(1, tcfg.vocab_size, 3).astype(np.int32)
    bt = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [5, 2, 9, 10]], np.int32)
    lengths = np.array([19, 0, 31], np.int32)   # row 1: a zombie
    (jk, jv), jsc = _split([jnp.asarray(p) for p in pools])
    jout = jstep.paged_decode_step(
        jp, jnp.asarray(tokens1), jk, jv, jnp.asarray(bt),
        jnp.asarray(lengths), jcfg, kv_tile_blocks=tile,
        decode_split_k=split, **jsc)
    tpools = [_t(p) for p in pools]
    (tk, tv), tsc = _split(tpools)
    tlg = tstep.paged_decode_step(tp, _t(tokens1), tk, tv, _t(bt),
                                  _t(lengths), tcfg, kv_tile_blocks=tile,
                                  decode_split_k=split, **tsc)
    _close_logits(tlg[[0, 2]], np.asarray(jout[0])[[0, 2]])
    _assert_pools_close([p[:, 1:] for p in tpools],
                        [np.asarray(p)[:, 1:] for p in jout[1:]])


def test_table_width_bucket_matches_jax():
    for need in range(1, 40):
        for nb_max in (None, 8, 33):
            assert tstep.table_width_bucket(need, nb_max=nb_max) == \
                jstep.table_width_bucket(need, nb_max=nb_max)
        for cq in (1, 2, 3, 16):
            assert tstep.table_width_bucket(need, chunk_blocks=cq) == \
                jstep.table_width_bucket(need, chunk_blocks=cq)
    with pytest.raises(ValueError):
        tstep.table_width_bucket(4, chunk_blocks=0)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen3-4b", "granite-3-8b",
                                  "hymba-1.5b", "rwkv6-7b", "whisper-base",
                                  "deepseek-v2-236b"])
def test_paged_support_matches_jax(arch):
    """The port serves what the JAX package serves, except the MoE family,
    which it refuses until ``moe_apply`` is ported."""
    jcfg = jax_reduce_config(jax_get_config(arch))
    tcfg = reduce_config(get_config(arch))
    try:
        jstep.check_paged_support(jcfg)
        jax_ok = True
    except ValueError:
        jax_ok = False
    if jax_ok:
        tstep.check_paged_support(tcfg)
    else:
        with pytest.raises(ValueError):
            tstep.check_paged_support(tcfg)


def test_paged_support_refuses_moe_until_ported():
    cfg = reduce_config(get_config("moonshot-v1-16b-a3b"))
    with pytest.raises(NotImplementedError, match="moe_apply"):
        tstep.check_paged_support(cfg)
