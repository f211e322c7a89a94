"""The port's encoder-decoder family (``models/whisper.py``, its layers in
``models/layers.py`` and the cross branch of ``models/attention.py``) on
the CPU against the JAX package.

Reduced whisper-base: 2 encoder and 2 decoder layers, d 64, 4/2 heads of
16, d_ff 128, 16 frames, vocab 512, float32. Weights come from the
reference's ``model_fns(cfg).init(PRNGKey(0))`` through the numpy bridge;
frames, tokens and activations from numpy seeds.

Tolerances: the layers (layernorm, the sinusoidal table, cross attention
under each impl) within 1e-5 of each tensor's largest magnitude in
float32 (the float32 sum-order rule of ROADMAP Queue 3); the schema, the
cache spec and the float32 greedy token streams of the prefill/decode
loop EXACTLY equal. Each whole-model test (the encoder output, logits,
loss, gradients, cache entries, the streams) runs on the reference's init
as drawn and, as its ``*_at_true_fan_in`` twin, on the same weights with
the attention projections rescaled to their true fan-in
(``_at_true_fan_in``, as the card's full-width runs draw them). At true
fan-in every tensor and gradient is
held within 1e-5 (they read 2e-7-1.3e-6 over batch seeds 1, 2, 7 and
13). The reference's init draws the projections 4-8x too large (ROADMAP
Queue 3), so the residual stream reaches ~50 and the scores ~85, which
amplifies float32 rounding: there tensors are held within ``MODEL_TOL`` =
2e-4 and gradients within ``GRAD_TOL`` = 1e-3 (the two float32 runs read
up to 5.9e-5 and 9.0e-4 over the same seeds; against float64 the
reference's logits lie 2.1e-5-2.3e-5 away, the port's 3.5e-5-4.4e-5).

bfloat16 decode is held on its logits, not its stream: both sides decode
the reference's greedy tokens (teacher forced), each step's logits
within ``BF16_LOGIT_TOL`` of the row's largest logit, and the port's
argmax is the reference's wherever the reference's top-2 gap exceeds
twice that bound (no two logits within the gate's reach can swap). The
two frameworks round bf16 products otherwise, and ``jax.nn.gelu`` rounds
after each op where torch's fused form rounds once.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import whisper as jwh
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.models.schema import init_params as jax_init_params
from repro.optim import adamw as jax_adamw
from repro.train import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as twh
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.optim import adamw
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.train import make_loss_and_grad, make_train_step

ARCH = "whisper-base"
TOL = 1e-5
# whole-model tensors and gradients (see the module docstring)
MODEL_TOL, GRAD_TOL = 2e-4, 1e-3
# bf16 decode logits, of the row's largest: about 3x the largest reading
# over frame seeds 11-14 (4.3%-10.7% at the reference's init, 0.78%-0.98%
# at true fan-in)
BF16_LOGIT_TOL = {"init": 0.3, "fan_in": 3e-2}
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.fixture(scope="module")
def whisper():
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    tcfg = reduce_config(get_config(ARCH))
    np_params = jax.tree.map(np.asarray,
                             jax_model_fns(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, np_params, params_from_numpy(np_params, tcfg)


def _at_true_fan_in(np_params):
    """The reference's weights with each attention projection (stacked
    (L, d, H, dh) for q/k/v, (L, H, dh, d) for ``wo``) rescaled from the
    init's fan-in, shape[-2], to its true one: d, or H·dh for ``wo``."""
    def walk(tree, mixer):
        out = {}
        for k, w in tree.items():
            if isinstance(w, dict):
                out[k] = walk(w, k)
            elif mixer in ("attn", "self_attn", "cross_attn") and \
                    k in ("wq", "wk", "wv", "wo"):
                fan = w.shape[1] * (w.shape[2] if k == "wo" else 1)
                out[k] = (w * np.sqrt(w.shape[-2] / fan)).astype(w.dtype)
            else:
                out[k] = w
        return out
    return walk(np_params, None)


# the whole-model tests' weight sets: (jcfg, tcfg, numpy params, the
# port's params, the whole-model tolerance, the gradients' tolerance, the
# set's name)
@pytest.fixture(scope="module")
def at_init(whisper):
    return (*whisper, MODEL_TOL, GRAD_TOL, "init")


@pytest.fixture(scope="module")
def at_fan_in(whisper):
    jcfg, tcfg, np_params, _ = whisper
    np_params = _at_true_fan_in(np_params)
    return (jcfg, tcfg, np_params, params_from_numpy(np_params, tcfg), TOL,
            TOL, "fan_in")


def _batch(cfg, seed, B=2, S=10):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(size=(B, cfg.enc_positions, cfg.d_model))
            .astype(np.float32),
            "tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _spec_tree(schema):
    if isinstance(schema, dict):
        return {k: _spec_tree(v) for k, v in schema.items()}
    return (tuple(schema.shape), tuple(schema.logical), schema.init,
            schema.std)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """fp32 statistics, the fp32 scale and bias, cast back to x's dtype."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    want = jlayers.layernorm(jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x).astype(dtype), 1e-5)
    got = tlayers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x).to(getattr(torch, dtype)),
                            1e-5)
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    _close(got, want, what="layernorm")
    assert _spec_tree(tlayers.layernorm_schema(64)) == \
        _spec_tree(jlayers.layernorm_schema(64))


@pytest.mark.parametrize("n,d", [(1500, 512), (16, 64)])
def test_sinusoidal_positions_match_jax(n, d):
    _close(tlayers.sinusoidal_positions(n, d),
           jlayers.sinusoidal_positions(n, d), what="sinusoidal table")


def test_schema_cache_spec_and_interface_match_jax(whisper):
    """The schema leaf for leaf (shape, logical axes, init, std) at the
    registry's 33,024 decoder positions, and at the module's default; the
    cache spec's shapes and dtypes; the interface's functions."""
    jcfg, tcfg, np_params, tparams = whisper
    assert _spec_tree(model_fns(tcfg).schema) == \
        _spec_tree(jax_model_fns(jcfg).schema)
    full_j, full_t = jax_get_config(ARCH), get_config(ARCH)
    assert _spec_tree(twh.whisper_schema(full_t)) == \
        _spec_tree(jwh.whisper_schema(full_j))
    assert _spec_tree(model_fns(full_t).schema) == \
        _spec_tree(jax_model_fns(full_j).schema)
    assert tparams["embed"]["dec_pos"].shape == (33024, 64)
    ours = tree_leaves(model_fns(tcfg).init(torch.Generator().manual_seed(0)))
    assert [tuple(a.shape) for a in ours] == \
        [a.shape for a in jax.tree_util.tree_leaves(np_params)]
    for cfg_j, cfg_t in ((jcfg, tcfg), (jcfg.replace(
            compute_dtype="bfloat16"), tcfg.replace(
            compute_dtype="bfloat16")), (full_j, full_t)):
        jspec = jax_model_fns(cfg_j).cache_spec(3, 40)
        tspec = model_fns(cfg_t).cache_spec(3, 40)
        assert sorted(tspec) == sorted(jspec) == \
            ["k", "len", "v", "xk", "xv"]
        for name, (shape, dtype) in tspec.items():
            assert shape == jspec[name][0], name
            assert str(dtype).split(".")[-1] == \
                jnp.dtype(jspec[name][1]).name, name
    assert tspec["xk"][0] == (6, 3, 8, 1500, 64)
    fns = model_fns(tcfg)
    assert all(callable(getattr(fns, f)) for f in (
        "init", "forward", "loss", "prefill", "decode_step", "cache_spec"))


def _cross_case(whisper, variant):
    """(jcfg, tcfg, numpy attention params): decoder layer 0's cross
    attention, or an attention with qk-norm and RoPE (its own init)."""
    jcfg, tcfg, np_params, _ = whisper
    if variant == "whisper":
        return jcfg, tcfg, jax.tree.map(
            lambda a: np.array(a[0]), np_params["dec_blocks"]["cross_attn"])
    jcfg, tcfg = (c.replace(qk_norm=True, rope_theta=10000.0)
                  for c in (jcfg, tcfg))
    p = jax_init_params(jax.random.PRNGKey(3), jattn.attention_schema(jcfg))
    return jcfg, tcfg, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("impl,variant,with_kv_pos", [
    ("chunked", "whisper", True), ("naive", "whisper", True),
    ("flash", "whisper", True), ("chunked", "qk_norm_rope", True),
    ("chunked", "qk_norm_rope", False), ("flash", "qk_norm_rope", True)])
def test_cross_attention_matches_jax(whisper, impl, variant, with_kv_pos):
    """``attention_apply`` with ``x_kv``: q from x (8 rows), k and v from
    x_kv (40 rows: the chunked path's second chunk of 32 and the
    plain flash version's tile of 128 ragged), never causal; qk-norm and RoPE
    under the reference's conditions (the keys roped only with
    ``kv_positions``). The JAX flash path in interpret mode; the port on
    the plain versions. Also ``causal=True`` passed in, which the cross
    branch overrides."""
    jcfg, tcfg, p = _cross_case(whisper, variant)
    jcfg = jcfg.replace(attention_impl=impl,
                        interpret_kernels=impl == "flash")
    tcfg = tcfg.replace(attention_impl=impl)
    rng = np.random.default_rng(5)
    B, S, F = 2, 8, 40
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    xkv = rng.normal(size=(B, F, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kpos = np.broadcast_to(np.arange(F, dtype=np.int32), (B, F)).copy() \
        if with_kv_pos else None
    want = jax.jit(lambda p, x, xkv, pos, kpos: jattn.attention_apply(
        p, x, jcfg, positions=pos, causal=True, x_kv=xkv,
        kv_positions=kpos))(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jnp.asarray(xkv), jnp.asarray(pos),
                            None if kpos is None else jnp.asarray(kpos))
    got = tattn.attention_apply(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), tcfg,
        positions=torch.from_numpy(pos), causal=True,
        x_kv=torch.from_numpy(xkv),
        kv_positions=None if kpos is None else torch.from_numpy(kpos))
    _close(got, want, what=f"cross attention {impl} {variant}")


def _check_encode_forward_and_loss(weights, impl):
    jcfg, tcfg, np_params, tparams, model_tol, _, _ = weights
    jcfg = jcfg.replace(attention_impl=impl,
                        interpret_kernels=impl == "flash")
    tcfg = tcfg.replace(attention_impl=impl)
    batch = _batch(tcfg, 1)
    jp = jax.tree.map(jnp.asarray, np_params)
    enc_j = jax.jit(jwh.whisper_encode, static_argnums=2)(
        jp, jnp.asarray(batch["frames"]), jcfg)
    _close(twh.whisper_encode(tparams, torch.from_numpy(batch["frames"]),
                              tcfg), enc_j, model_tol, "encode")
    lg_j = jax.jit(jax_model_fns(jcfg).forward)(jp, batch)
    lg_t = model_fns(tcfg).forward(tparams, _t(batch))
    assert lg_t.dtype == torch.float32 and \
        lg_t.shape == (2, 10, tcfg.padded_vocab)
    _close(lg_t, lg_j, model_tol, "forward")
    loss_j, m_j = jax.jit(jax_model_fns(jcfg).loss)(jp, batch)
    loss_t, m_t = model_fns(tcfg).loss(tparams, _t(batch))
    for got, want in ((loss_t, loss_j), (m_t["ce"], m_j["ce"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(m_t["aux"]) == float(m_j["aux"]) == 0.0


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encode_forward_and_loss_match_jax(at_init, impl):
    _check_encode_forward_and_loss(at_init, impl)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encode_forward_and_loss_match_jax_at_true_fan_in(at_fan_in, impl):
    _check_encode_forward_and_loss(at_fan_in, impl)


def _check_loss_gradients(weights):
    """Every leaf's gradient within the weights' gradient tolerance of its
    largest magnitude (the chunked path; the trainer's test below takes
    flash with the layers checkpointed)."""
    jcfg, tcfg, np_params, _, _, grad_tol, _ = weights
    batch = _batch(tcfg, 2)
    gj = jax.jit(jax.grad(lambda p: jax_model_fns(jcfg).loss(p, batch)[0]))(
        jax.tree.map(jnp.asarray, np_params))
    leaves = jax.tree.map(lambda a: a.requires_grad_(),
                          params_from_numpy(np_params, tcfg))
    model_fns(tcfg).loss(leaves, _t(batch))[0].backward()
    paths = jax.tree_util.tree_flatten_with_path(gj)[0]
    for (path, want), got in zip(paths, tree_leaves(leaves)):
        _close(got.grad, want, grad_tol, jax.tree_util.keystr(path))


def test_loss_gradients_match_jax(at_init):
    _check_loss_gradients(at_init)


def test_loss_gradients_match_jax_at_true_fan_in(at_fan_in):
    _check_loss_gradients(at_fan_in)


TRAIN_TC = dict(total_steps=4, warmup_steps=1, learning_rate=1e-3)


@pytest.fixture(scope="module")
def jax_flash_remat(whisper):
    """The reference's loss gradient and train step under ``flash`` (in
    interpret mode) with ``remat="full"``, jitted once for both weight
    sets."""
    jcfg = whisper[0].replace(remat="full", attention_impl="flash",
                              interpret_kernels=True)
    jfns = jax_model_fns(jcfg)
    return (jax.jit(jax.grad(lambda p, b: jfns.loss(p, b)[0])),
            jax.jit(jax_make_train_step(jfns.loss, JaxTrainConfig(
                **TRAIN_TC))))


def _check_train_step(weights, jax_flash_remat):
    """The port's trainer over both layer stacks (per-layer autograd
    leaves, ``remat="full"``, flash on the plain versions) against the
    reference's jitted step (flash in interpret mode): the accumulated
    gradients within the weights' gradient tolerance of each leaf's
    largest magnitude, the loss within 1e-5 and the gradient norm within
    the whole-model tolerance; after one
    AdamW step every parameter within 2.5 learning rates of the
    reference's (Adam's first step is ``lr · g / |g|`` per element, so a
    gradient element at the noise level may take the other sign)."""
    _, tcfg, np_params, _, model_tol, grad_tol, _ = weights
    tcfg = tcfg.replace(remat="full", attention_impl="flash")
    batch = _batch(tcfg, 7)
    tc = TRAIN_TC
    jax_grad, jax_step = jax_flash_remat
    jp = jax.tree.map(jnp.asarray, np_params)
    gj = jax_grad(jp, batch)
    tparams = params_from_numpy(np_params, tcfg)
    loss, _, grads = make_loss_and_grad(model_fns(tcfg).loss, TrainConfig(
        **tc))(tparams, _t(batch))
    paths = jax.tree_util.tree_flatten_with_path(gj)[0]
    for (path, want), got in zip(paths, tree_leaves(grads)):
        _close(got, want, grad_tol, jax.tree_util.keystr(path))
    pj, _, mj = jax_step(jp, jax_adamw.init_state(jp), batch)
    pt, opt, mt = make_train_step(model_fns(tcfg).loss, TrainConfig(**tc))(
        tparams, adamw.init_state(tparams), _t(batch))
    assert int(opt.step) == 1 and float(mt["loss"]) == float(loss)
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=model_tol)
    paths = jax.tree_util.tree_flatten_with_path(pj)[0]
    for (path, want), got in zip(paths, tree_leaves(pt)):
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err <= 2.5 * tc["learning_rate"], \
            (jax.tree_util.keystr(path), err)


def test_train_step_matches_jax(at_init, jax_flash_remat):
    _check_train_step(at_init, jax_flash_remat)


def test_train_step_matches_jax_at_true_fan_in(at_fan_in, jax_flash_remat):
    _check_train_step(at_fan_in, jax_flash_remat)


def _check_prefill_and_decode_steps(weights):
    """``prefill``: the cross K/V of every decoder layer, an empty self
    cache, ``len`` 0, no logits; then six ``decode_step``s on fed tokens,
    the rows at different lengths from the second step on: the logits and
    every cache entry after each."""
    jcfg, tcfg, np_params, tparams, model_tol, _, _ = weights
    batch = _batch(tcfg, 4)
    B, max_len = 2, 12
    jp = jax.tree.map(jnp.asarray, np_params)
    none_j, cj = jax.jit(jax_model_fns(jcfg).prefill, static_argnums=2)(
        jp, {"frames": jnp.asarray(batch["frames"])}, max_len)
    none_t, ct = model_fns(tcfg).prefill(
        tparams, {"frames": torch.from_numpy(batch["frames"])}, max_len)
    assert none_j is None and none_t is None
    assert sorted(ct) == sorted(cj) == ["k", "len", "v", "xk", "xv"]
    assert ct["xk"].shape == (2, B, 2, 16, 16)
    step = jax.jit(jax_model_fns(jcfg).decode_step)
    rng = np.random.default_rng(9)
    for t in range(7):
        for name in cj:
            if name == "len":
                np.testing.assert_array_equal(ct[name].numpy(), cj[name])
            else:
                _close(ct[name], cj[name], model_tol, f"{name} step {t}")
        if t == 6:
            break
        tok = rng.integers(1, tcfg.vocab_size, (B,)).astype(np.int32)
        lg_j, cj = step(jp, jnp.asarray(tok), cj)
        lg_t, ct = model_fns(tcfg).decode_step(tparams, torch.from_numpy(tok),
                                               ct)
        _close(lg_t, lg_j, model_tol, f"decode logits step {t}")
        if t == 0:        # from here on row 1 runs one position ahead
            cj = {**cj, "len": cj["len"].at[1].add(1)}
            ct["len"] = ct["len"] + torch.tensor([0, 1], dtype=torch.int32)


def test_prefill_and_decode_steps_match_jax(at_init):
    _check_prefill_and_decode_steps(at_init)


def test_prefill_and_decode_steps_match_jax_at_true_fan_in(at_fan_in):
    _check_prefill_and_decode_steps(at_fan_in)


def _greedy(fns, params, frames, start, steps, max_len, V, feed=None):
    """The serving loop over ``prefill`` and ``decode_step``: one start
    token per row, then ``steps`` greedy tokens over the unpadded vocab V,
    or, with ``feed`` (B, steps), those tokens fed in their place. Returns
    the argmax tokens (B, steps) and the logits (B, steps, V) as float32
    numpy."""
    as_input = torch.from_numpy if isinstance(start, torch.Tensor) else \
        jnp.asarray
    _, cache = fns.prefill(params, {"frames": frames}, max_len)
    tok, toks, lgs = start, [], []
    for s in range(steps):
        lg, cache = fns.decode_step(params, tok, cache)
        lg = np.asarray(lg[:, :V].float() if isinstance(
            lg, torch.Tensor) else lg[:, :V].astype(jnp.float32))
        toks.append(lg.argmax(-1).astype(np.int32))
        lgs.append(lg)
        tok = as_input(toks[-1] if feed is None else feed[:, s])
    return np.stack(toks, 1), np.stack(lgs, 1)


def _check_greedy_streams(weights, dtype):
    """12 greedy tokens from a start token into a 16-slot self cache. In
    float32: EXACTLY the reference's streams. In bfloat16 (see the module
    docstring): the port fed the reference's tokens, each step's logits
    within ``BF16_LOGIT_TOL`` of the row's largest, and its argmax the
    reference's token wherever the reference's top-2 gap is wider than
    twice that."""
    jcfg, tcfg, np_params, tparams, _, _, name = weights
    jcfg, tcfg = (c.replace(compute_dtype=dtype) for c in (jcfg, tcfg))
    frames = _batch(tcfg, 11, B=3)["frames"]
    start = np.array([3, 50, 7], np.int32)
    jfns, tfns = jax_model_fns(jcfg), model_fns(tcfg)
    jfns.prefill = jax.jit(jfns.prefill, static_argnums=2)
    jfns.decode_step = jax.jit(jfns.decode_step)
    V = tcfg.vocab_size
    want, want_lg = _greedy(jfns, jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(frames), jnp.asarray(start), 12, 16, V)
    if dtype == "float32":
        got, _ = _greedy(tfns, tparams, torch.from_numpy(frames),
                         torch.from_numpy(start), 12, 16, V)
        np.testing.assert_array_equal(got, want)
        return
    got, got_lg = _greedy(tfns, tparams, torch.from_numpy(frames),
                          torch.from_numpy(start), 12, 16, V, feed=want)
    tol = BF16_LOGIT_TOL[name]
    top = np.abs(want_lg).max(-1)
    err = np.abs(got_lg - want_lg).max(-1) / top
    assert err.max() <= tol, (err.max(), np.unravel_index(err.argmax(),
                                                          err.shape))
    two = np.sort(want_lg, -1)[..., -2:]
    decisive = two[..., 1] - two[..., 0] > 2 * tol * top
    np.testing.assert_array_equal(got[decisive], want[decisive])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_streams_match_jax(at_init, dtype):
    _check_greedy_streams(at_init, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_streams_match_jax_at_true_fan_in(at_fan_in, dtype):
    _check_greedy_streams(at_fan_in, dtype)


def test_refusals(whisper):
    """The engines and the launchers take prompts alone: each refuses the
    family with a ValueError naming the step functions that serve it; the
    decoder-only LM's functions refuse it too."""
    _, tcfg, _, tparams = whisper
    for make in (lambda: ServeEngine(tcfg, tparams, device="cpu"),
                 lambda: ContinuousEngine(tcfg, tparams, device="cpu")):
        with pytest.raises(ValueError, match=r"model_fns\(cfg\)\.prefill"):
            make()
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu"]
    for main in (launch_serve.main, launch_train.main):
        with pytest.raises(ValueError, match="decode_step"):
            main(argv)
    with pytest.raises(ValueError, match="decode_step"):
        launch_serve.main(argv + ["--engine", "paged"])
    for fn in (tlm.lm_schema, lambda c: tlm.cache_spec(c, 2, 16)):
        with pytest.raises(NotImplementedError, match="models/whisper.py"):
            fn(tcfg)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_draws_whisper_at_true_fan_in():
    """``chip_smoke._fan_in`` reads the fan-in of whisper's three attention
    stacks (d for the q/k/v projections, H·dh for ``wo``), and
    ``_card_params`` (on the CPU here) draws the schema with layernorm
    scales at 1, biases at 0 and every projection near its true fan-in."""
    cs = _chip_smoke()
    cfg = get_config(ARCH)
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim_
    for mixer in ("attn", "self_attn", "cross_attn"):
        for w in ("wq", "wk", "wv"):
            assert cs._fan_in((mixer, w), (d, H, dh)) == d
        assert cs._fan_in((mixer, "wo"), (H, dh, d)) == H * dh
    assert cs._fan_in(("mlp", "wi"), (d, cfg.d_ff)) is None
    small = reduce_config(cfg).replace(d_model=256, d_ff=512)
    p = cs._card_params(small, torch.device("cpu"))
    assert set(p) == set(model_fns(small).schema)
    for stack, ln in (("enc_blocks", "ln1"), ("dec_blocks", "ln_x")):
        assert bool((p[stack][ln]["scale"] == 1).all())
        assert bool((p[stack][ln]["bias"] == 0).all())
    for stack, mixer in (("enc_blocks", "attn"), ("dec_blocks", "self_attn"),
                         ("dec_blocks", "cross_attn")):
        for w, fan in (("wq", 256), ("wo", small.n_heads * 16)):
            std = p[stack][mixer][w].float().std().item()
            assert abs(std * fan ** 0.5 - 1) < 0.1, (stack, mixer, w, std)
    std = p["embed"]["dec_pos"].float().std().item()
    assert abs(std / 0.02 - 1) < 0.1
