"""The port's Softermax core and layers against the JAX package.

Merge laws of ``softermax_merge`` (split == whole, commutative,
associative, identity-exact with fully masked rows) within 1e-5 relative
(fp reassociation of the sums; every rescale is an exact power of two
under IntMax), and equal to the JAX merge on the same states. Layers and
``chunked_attention`` within ``atol`` 1e-5 of the JAX functions on the
same numpy inputs (float32, different summation orders); ``quantize_kv``
codes exactly equal, scales within ``rtol`` 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import softermax as jsm
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduce_config as jax_reduce_config
from repro_torch.core.numerics import NEG_INF
from repro_torch.core.softermax import (softermax, softermax_finalize,
                                        softermax_merge, softmax_base2)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.registry import get_config, reduce_config

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _state(scores, intmax, vals=None):
    """Closed-form partial state (m, d, acc) of a score segment against
    values ``vals`` (cols, 2); an empty segment is the merge identity."""
    rows, cols = scores.shape
    if cols == 0:
        return (np.full((rows, 1), NEG_INF, np.float32),
                np.zeros((rows, 1), np.float32),
                np.zeros((rows, 2), np.float32))
    if vals is None:
        vals = np.stack([np.ones(cols), np.arange(cols)], 1)
    m = np.max(scores, axis=-1, keepdims=True)
    m = np.ceil(m) if intmax else m
    p = np.exp2(scores - m).astype(np.float32)
    return (m.astype(np.float32), p.sum(-1, keepdims=True),
            p @ vals.astype(np.float32))


def _merge(states):
    m, d, acc = (torch.stack([_t(s[i]) for s in states]) for i in range(3))
    return softermax_merge(m, d, acc, axis=0)


def _segments(rng, n, cols, rows=3):
    return [rng.uniform(-30, 30, (rows, c)).astype(np.float32)
            for c in rng.integers(0, cols + 1, n)]


@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_merge_of_partials_equals_whole(intmax, seed):
    rng = np.random.default_rng(seed)
    segs = _segments(rng, 4, 9)
    segs[0] = rng.uniform(-30, 30, (3, 5)).astype(np.float32)  # non-empty
    whole = np.concatenate(segs, axis=-1)
    vals = np.stack([np.ones(whole.shape[1]),
                     np.arange(whole.shape[1])], 1)
    bounds = np.cumsum([0] + [s.shape[1] for s in segs])
    states = [_state(s, intmax, vals[a:b])
              for s, a, b in zip(segs, bounds[:-1], bounds[1:])]
    m, d, acc = _merge(states)
    wm, wd, wacc = _state(whole, intmax, vals)
    np.testing.assert_array_equal(_np(m), wm)
    np.testing.assert_allclose(_np(d), wd, rtol=1e-5)
    np.testing.assert_allclose(_np(acc), wacc, rtol=1e-5)
    # and the same numbers as the JAX merge
    jm = jsm.softermax_merge(*(jnp.stack([s[i] for s in states])
                               for i in range(3)), axis=0)
    for a, b in zip((m, d, acc), jm):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("intmax", [True, False])
def test_merge_commutative_and_associative(intmax):
    rng = np.random.default_rng(5)
    a, b, c = (_state(s, intmax) for s in _segments(rng, 3, 7))
    ab = tuple(_np(x) for x in _merge([a, b]))
    ba = tuple(_np(x) for x in _merge([b, a]))
    for x, y in zip(ab, ba):
        np.testing.assert_allclose(x, y, rtol=1e-6)
    ab_c = _merge([tuple(np.asarray(x) for x in (ab[0], ab[1], ab[2])), c])
    bc = tuple(_np(x) for x in _merge([b, c]))
    a_bc = _merge([a, bc])
    for x, y in zip(ab_c, a_bc):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-5)


@pytest.mark.parametrize("intmax", [True, False])
def test_merge_identity_is_exact(intmax):
    rng = np.random.default_rng(9)
    seg = rng.uniform(-30, 30, (3, 6)).astype(np.float32)
    s = _state(seg, intmax)
    ident = _state(np.zeros((3, 0), np.float32), intmax)
    for x, y in zip(_merge([s, ident]), s):
        assert np.array_equal(_np(x), y)
    # fully masked rows: every partition empty → d == 0 → output 0
    m, d, acc = _merge([ident, ident])
    assert np.all(_np(d) == 0)
    assert np.all(_np(softermax_finalize(acc, d)) == 0)


def test_finalize_and_softmax_forms_match_jax():
    rng = np.random.default_rng(2)
    acc = rng.normal(size=(4, 8)).astype(np.float32)
    d = np.array([[0.0], [1.5], [0.0], [3.0]], np.float32)
    np.testing.assert_array_equal(
        _np(softermax_finalize(_t(acc), _t(d))),
        np.asarray(jsm.softermax_finalize(acc, d)))
    x = rng.normal(size=(3, 17)).astype(np.float32) * 8
    x[1] = NEG_INF                                       # fully masked row
    np.testing.assert_allclose(_np(softermax(_t(x))),
                               np.asarray(jsm.softermax(x)), atol=ATOL)
    np.testing.assert_allclose(
        _np(softmax_base2(_t(x[[0, 2]]), fold_log2e=True)),
        np.asarray(jsm.softmax_base2(x[[0, 2]], fold_log2e=True)),
        atol=ATOL)


def test_quantize_kv_codes_exact():
    rng = np.random.default_rng(4)
    t = (rng.normal(size=(5, 3, 7, 16)) * rng.uniform(
        0.01, 10, (5, 3, 7, 1))).astype(np.float32)
    q, s = tattn.quantize_kv(_t(t))
    jq, js = jattn.quantize_kv(jnp.asarray(t))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(
        _np(tattn.dequantize_kv(q, s, torch.float32)),
        np.asarray(jattn.dequantize_kv(jq, js, jnp.float32)), rtol=1e-6)


@pytest.fixture(scope="module")
def cfgs():
    return (jax_reduce_config(jax_get_config("qwen3-4b")),
            reduce_config(get_config("qwen3-4b")))


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_layers_match_jax(cfgs, activation):
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlayers.rmsnorm({"scale": _t(scale)}, _t(x))),
        np.asarray(jlayers.rmsnorm({"scale": scale}, x)), atol=ATOL)
    p = {k: (rng.normal(size=sh) / np.sqrt(sh[0])).astype(np.float32)
         for k, sh in (("wi", (64, 128)), ("wg", (64, 128)),
                       ("wo", (128, 64)))}
    if activation == "relu2":
        del p["wg"]
    np.testing.assert_allclose(
        _np(tlayers.mlp({k: _t(v) for k, v in p.items()}, _t(x),
                        activation)),
        np.asarray(jlayers.mlp(p, x, activation)), atol=ATOL)
    emb = (rng.normal(size=(jcfg.padded_vocab, 64)) / 8).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlayers.logits({"embedding": _t(emb)}, _t(x),
                           tcfg.replace(tie_embeddings=True))),
        np.asarray(jlayers.logits({"embedding": emb}, x,
                                  jcfg.replace(tie_embeddings=True))),
        atol=ATOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 1, 9)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tlayers.rope(_t(x), _t(pos), theta)),
        np.asarray(jlayers.rope(x, pos, theta)), atol=ATOL)


@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("Sq,Sk,chunk", [(7, 7, 4), (5, 37, 16)])
def test_chunked_attention_matches_jax(intmax, Sq, Sk, chunk):
    rng = np.random.default_rng(Sq * Sk)
    q = (rng.normal(size=(2, 4, Sq, 16)) / 4).astype(np.float32)
    k = rng.normal(size=(2, 2, Sk, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, Sk, 16)).astype(np.float32)
    kw = dict(causal=True, intmax=intmax, chunk=chunk, q_offset=Sk - Sq)
    np.testing.assert_allclose(
        _np(tattn.chunked_attention(_t(q), _t(k), _t(v), **kw)),
        np.asarray(jattn.chunked_attention(q, k, v, **kw)), atol=ATOL)
