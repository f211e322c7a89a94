"""K5's plain version and the static engine's model steps on the CPU
against the JAX package.

* ``decode_ref`` (K5's plain version) against the JAX Pallas kernel
  ``flash_decode`` in interpret mode and the JAX ``decode_ref``: odd cache
  lengths S, lengths 1 and S, GQA groups 1, 2 and 4, IntMax on and off;
  and at the lengths around a tile of K5's bulk-copy route.
* K5's dispatch rule ``bulk_route`` (dtype pairs, row bytes, head dim,
  group, K and V alignment), the route's tile rows ``bulk_tile_rows`` and
  the split geometry ``split_lanes``, as plain functions.
* ``attention_decode`` against the JAX ``attention_decode``, branch by
  branch: the linear cache with ``interpret_kernels`` off (``_masked_decode``)
  and on (the kernel's plain version), a sliding window, a ring buffer, an
  int8 cache, ``opt_dus_cache`` (linear and ring), QK-norm (qwen3-4b).
* ``lm_prefill`` and ``lm_decode_step`` (logits and caches) against the
  JAX ones for reduced llama3.2-3b and qwen3-4b, float32 and int8 caches.

Weights come from the JAX init through the numpy bridge; inputs from numpy
seeds. Tolerance: float32 values within 1e-5 (sums in another order; every
IntMax rescale is an exact power of two); through a whole model (prefill and
decode steps) within 1e-5 of the tensor's largest magnitude, as logits reach
~25 and carry float32 rounding of that size (seen: 6.1e-5 at |logit| ~25,
2.4e-6 of it); int8 codes exactly equal. An int8 row's scale is amax / 127
of the K/V row the model projects, and the two packages' float32
projections sum in another order, so the scales of the rows a step writes
differ in their last bits (seen: 1 ulp after one projection, 9.1e-7
relative after a two-layer prefill): scales are held to ``rtol`` 1e-5, as
``test_torch_paged_step.py`` holds the pool's (``quantize_kv`` itself is
held exactly on equal inputs in ``test_torch_core.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import decode_ref as jax_decode_ref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels.flash_decode import (bulk_route, bulk_tile_rows,
                                              decode_ref, flash_decode_op,
                                              split_lanes)
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_map

ATOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL)


def _close_scaled(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def _same_int8(name, got, want):
    """int8 codes (and int32 lengths) exactly; scales to rtol 1e-5."""
    got, want = np.asarray(got), np.asarray(want)
    if name.endswith("scale"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("S", [37, 64])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_ref_matches_jax(G, S, intmax):
    rng = np.random.default_rng(7 * G + S)
    B, Hkv, D = 4, 2, 16
    q = (rng.normal(size=(B, G * Hkv, D)) / np.sqrt(D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    lens = np.array([1, S, 17, S - 2], np.int32)
    got = decode_ref(*(torch.from_numpy(a) for a in (q, k, v, lens)),
                     intmax=intmax)
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    _close(got, jax_flash_decode(*jargs, intmax=intmax, block_k=16,
                                 interpret=True))
    _close(got, jax_decode_ref(*jargs, intmax=intmax))
    # on CPU tensors the dispatcher is the plain version
    assert torch.equal(flash_decode_op(
        *(torch.from_numpy(a) for a in (q, k, v, lens)), intmax=intmax), got)


@pytest.mark.parametrize("pairs,S", [(64, 1056), (64, 37), (2, 1056),
                                     (16, 1056), (1, 5000), (4096, 1056),
                                     (8, 128), (264, 129)])
def test_split_lanes_cover_the_cache(pairs, S):
    lane_rows, n = split_lanes(pairs, S)
    assert lane_rows % 128 == 0 and n >= 1
    assert n * lane_rows >= S > (n - 1) * lane_rows


# (D, cache itemsize) -> rows of a bulk-route tile: a lane holds 8 values
# of a row, so lpr lanes cover a row; four warps take 4 / (chunks a lane)
# steps of 32 / lpr rows: at most 8 KB of K
TILE_ROWS = [((128, 2), 32), ((128, 4), 16), ((256, 4), 8), ((256, 2), 16),
             ((64, 2), 64), ((40, 2), 64), ((8, 2), 512), ((36, 4), 32),
             ((32, 4), 64), ((4, 4), 256)]


@pytest.mark.parametrize("geom,rows", TILE_ROWS, ids=str)
def test_bulk_tile_rows(geom, rows):
    D, itemsize = geom
    assert bulk_tile_rows(D, itemsize) == rows
    assert rows * D * itemsize <= 8192


def _operands(qdt, kdt, D, G, shift_k=0, shift_v=0):
    """CPU operands of the route rule; a shift moves K or V off a 16-byte
    boundary by that many elements."""
    B, Hkv, S = 2, 2, 5

    def cache(shift):
        n = B * Hkv * S * D
        return torch.zeros(n + 16, dtype=kdt)[shift:shift + n].view(
            B, Hkv, S, D)

    return torch.zeros(B, G * Hkv, D, dtype=qdt), cache(shift_k), \
        cache(shift_v)


F32, BF16 = torch.float32, torch.bfloat16


# (q dtype, cache dtype, D, G, K shift, V shift) -> bulk-copy route?
ROUTES = [
    ((BF16, BF16, 128, 3, 0, 0), True),       # the main path
    ((F32, F32, 128, 3, 0, 0), True),
    ((BF16, F32, 128, 3, 0, 0), True),
    ((F32, BF16, 128, 3, 0, 0), True),
    ((BF16, BF16, 8, 1, 0, 0), True),         # a row of 16 bytes
    ((BF16, BF16, 36, 3, 0, 0), False),       # 72 bytes: the earlier kernel
    ((BF16, BF16, 40, 3, 0, 0), True),        # 80 bytes
    ((F32, F32, 36, 3, 0, 0), True),          # 144 bytes
    ((F32, F32, 6, 3, 0, 0), False),          # 24 bytes
    ((BF16, BF16, 256, 8, 0, 0), True),       # the largest D and G
    ((F32, F32, 256, 8, 0, 0), True),
    ((BF16, BF16, 264, 8, 0, 0), False),      # past D 256 (the wrapper
    ((BF16, BF16, 128, 9, 0, 0), False),      # raises on both)
    ((BF16, BF16, 128, 3, 1, 0), False),      # K off 16 bytes
    ((BF16, BF16, 128, 3, 0, 4), False),      # V off 16 bytes
    ((F32, F32, 128, 3, 4, 4), True),         # 16 bytes on
    ((F32, F32, 128, 3, 2, 0), False),
]


@pytest.mark.parametrize("case,bulk", ROUTES, ids=str)
def test_bulk_route_rule(case, bulk):
    qdt, kdt, D, G, sk, sv = case
    assert bulk_route(*_operands(qdt, kdt, D, G, sk, sv)) is bulk


@pytest.mark.parametrize("pairs,S,tile", [
    (64, 1056, 32), (64, 37, 32), (2, 1056, 16), (16, 1056, 64),
    (1, 5000, 8), (4096, 1056, 32), (8, 128, 256), (264, 129, 32),
    (64, 1, 512), (3, 33, 32)])
def test_split_lanes_cover_the_cache_in_tiles(pairs, S, tile):
    lane_rows, n = split_lanes(pairs, S, tile)
    assert lane_rows % tile == 0 and n >= 1
    assert n * lane_rows >= S > (n - 1) * lane_rows
    # about two blocks an SM: no more lanes than 264 blocks ask for
    assert n <= -(-264 // pairs)
    if (pairs, S, tile) == (64, 1056, 32):      # the full-width decode
        assert (lane_rows, n) == (224, 5)


@pytest.mark.parametrize("intmax", [True, False])
def test_decode_ref_matches_jax_at_tile_edges(intmax):
    """Lengths one short of, at and one past a bulk-route tile (64 rows at
    D 32, f32), and the whole cache."""
    B, Hkv, G, D = 4, 2, 3, 32
    tile = bulk_tile_rows(D, 4)
    S = 2 * tile + 3
    rng = np.random.default_rng(31)
    q = (rng.normal(size=(B, G * Hkv, D)) / np.sqrt(D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    lens = np.array([tile - 1, tile, tile + 1, S], np.int32)
    got = decode_ref(*(torch.from_numpy(a) for a in (q, k, v, lens)),
                     intmax=intmax)
    jargs = [jnp.asarray(a) for a in (q, k, v, lens)]
    _close(got, jax_flash_decode(*jargs, intmax=intmax, block_k=64,
                                 interpret=True))
    _close(got, jax_decode_ref(*jargs, intmax=intmax))


@pytest.fixture(scope="module", params=["llama3.2-3b", "qwen3-4b"])
def model(request):
    jcfg = jax_reduce_config(jax_get_config(request.param))
    tcfg = reduce_config(get_config(request.param))
    jparams = jax_model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


# name: (cfg overrides, window, ring, cache S, cache_len per row)
BRANCHES = {
    "linear": ({}, 0, False, 24, [3, 0, 17]),
    "linear_interpret": ({"interpret_kernels": True}, 0, False, 24,
                         [3, 0, 23 - 1]),
    "window": ({}, 5, False, 24, [3, 0, 17]),
    "ring": ({}, 0, True, 8, [5, 12, 30]),
    "int8": ({"opt_int8_kv": True}, 0, False, 24, [3, 0, 17]),
    "int8_interpret": ({"opt_int8_kv": True, "interpret_kernels": True}, 0,
                       False, 24, [3, 9, 17]),
    "dus": ({"opt_dus_cache": True}, 0, False, 24, [11, 11, 11]),
    "dus_ring": ({"opt_dus_cache": True}, 0, True, 8, [13, 13, 13]),
    "dus_int8": ({"opt_dus_cache": True, "opt_int8_kv": True}, 0, False,
                 24, [6, 6, 6]),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_attention_decode_matches_jax(model, branch):
    jcfg, tcfg, jparams, tparams = model
    over, window, ring, S, lens = BRANCHES[branch]
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    layer = 1
    jmix = jax.tree.map(lambda a: a[layer], jparams["blocks"]["mixer"])
    tmix = tree_map(lambda a: a[layer], tparams["blocks"]["mixer"])
    rng = np.random.default_rng(sum(map(ord, branch)))
    B, Hkv, Dh = len(lens), tcfg.n_kv_heads, tcfg.head_dim_
    x1 = rng.normal(size=(B, tcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(B, Hkv, S, Dh)).astype(np.float32)
    cv = rng.normal(size=(B, Hkv, S, Dh)).astype(np.float32)
    clen = np.asarray(lens, np.int32)
    caches = [ck, cv]
    if tcfg.opt_int8_kv:
        (kq, ks), (vq, vs) = jattn.quantize_kv(ck), jattn.quantize_kv(cv)
        caches = [np.asarray(a) for a in (kq, vq, ks, vs)]
    names = ("cache_k", "cache_v", "cache_k_scale", "cache_v_scale")
    jout = jattn.attention_decode(
        jmix, jnp.asarray(x1), jcfg, cache_len=jnp.asarray(clen),
        window=window, ring=ring,
        **{n: jnp.asarray(c) for n, c in zip(names, caches)})
    tout = tattn.attention_decode(
        tmix, torch.from_numpy(x1), tcfg, cache_len=torch.from_numpy(clen),
        window=window, ring=ring,
        **{n: torch.from_numpy(c.copy()) for n, c in zip(names, caches)})
    assert len(tout) == len(jout)
    _close(tout[0], jout[0])                                   # y1
    for name, got, want in zip(names, tout[1:], jout[1:]):
        if tcfg.opt_int8_kv:
            _same_int8(name, got, want)
        else:
            _close(got, want)


def _jax_steps(jcfg, jparams, tokens, max_len, n):
    lg, cache = jlm.lm_prefill(jparams, jnp.asarray(tokens), jcfg, max_len)
    out = [(lg, cache)]
    for _ in range(n):
        tok = jnp.argmax(lg[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        lg, cache = jlm.lm_decode_step(jparams, tok, cache, jcfg)
        out.append((lg, cache))
    return out


@pytest.mark.parametrize("over", [{}, {"opt_int8_kv": True},
                                  {"interpret_kernels": True}],
                         ids=["f32", "int8", "interpret"])
def test_prefill_and_decode_steps_match_jax(model, over):
    jcfg, tcfg, jparams, tparams = model
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, tcfg.vocab_size, (3, 11)).astype(np.int32)
    max_len = 16
    want = _jax_steps(jcfg, jparams, tokens, max_len, 3)
    lg, cache = tlm.lm_prefill(tparams, torch.from_numpy(tokens), tcfg,
                               max_len)
    for step, (jlg, jcache) in enumerate(want):
        if step:
            tok = jnp.argmax(want[step - 1][0][:, :jcfg.vocab_size], -1)
            lg, cache = tlm.lm_decode_step(
                tparams, torch.from_numpy(np.array(tok, np.int32)), cache,
                tcfg)
        _close_scaled(lg, jlg)
        assert sorted(cache) == sorted(jcache)
        for name, t in cache.items():
            jt = np.asarray(jcache[name])
            assert t.shape == jt.shape
            if t.dtype in (torch.int8, torch.int32) or name.endswith(
                    "_scale"):
                _same_int8(name, t, jt)
            else:
                _close_scaled(t, jt)


def test_cache_spec_and_model_fns_match_jax(model):
    jcfg, tcfg, _, _ = model
    for over in ({}, {"opt_int8_kv": True}):
        jspec = jlm.cache_spec(jcfg.replace(**over), 3, 40)
        tspec = model_fns(tcfg.replace(**over)).cache_spec(3, 40)
        assert sorted(tspec) == sorted(jspec)
        for name, (shape, dtype) in tspec.items():
            assert shape == jspec[name][0]
            assert str(dtype).split(".")[-1] == jnp.dtype(jspec[name][1]).name
    fns = model_fns(tcfg)
    assert all(callable(getattr(fns, f)) for f in ("prefill", "decode_step",
                                                   "cache_spec"))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_other_families_raise_not_implemented(arch):
    """The hybrid and rwkv families have their static cache (held to the
    reference in ``tests/test_torch_{hymba,rwkv6}.py``); the decoder-only
    cache refuses the encoder-decoder family, whose cache is
    ``models/whisper.py``'s (``tests/test_torch_whisper.py``)."""
    assert "len" in tlm.cache_spec(reduce_config(get_config(arch)), 2, 16)
    with pytest.raises(NotImplementedError, match="models/whisper.py"):
        tlm.cache_spec(reduce_config(get_config("whisper-base")), 2, 16)
