"""The port's hybrid family (``models/hymba.py`` and its hooks in
``models/lm.py``) on the CPU against the JAX package.

Reduced hymba-1.5b: 2 layers, d 64, 4/2 heads of 16, a sliding window of
16, a Mamba branch of d_inner 128, state 8, conv width 4. Weights come
from the reference's ``model_fns(cfg).init`` through the numpy bridge;
inputs from numpy seeds.

Tolerances: module outputs, states, logits and every cache entry within
1e-5 of each tensor's largest magnitude in float32 (the float32 sum-order
rule of ROADMAP Queue 3); gradients within 1e-4 relative L2 per leaf; the
static engines' greedy streams EXACTLY equal, in float32 and bfloat16
compute, past the window (the ring buffer wraps).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import hymba as jhy
from repro.models import lm as jlm
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import hymba as thy
from repro_torch.models import lm as tlm
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.serve import ContinuousEngine, ServeEngine

ARCH = "hymba-1.5b"
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.fixture(scope="module")
def hymba():
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    tcfg = reduce_config(get_config(ARCH))
    np_params = jax.tree.map(np.asarray,
                             jax_model_fns(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, np_params, params_from_numpy(np_params, tcfg)


def _layer0(np_params, *path):
    tree = np_params["blocks"]
    for k in path:
        tree = tree[k]
    p = jax.tree.map(lambda a: np.array(a[0]), tree)
    return jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_causal_conv_and_mamba_match_jax(hymba, carried):
    """``_causal_conv`` and ``mamba_apply`` (with ``return_state``), from
    zero states or from carried ones, and a sequence cut in two carrying
    the states across the cut equals it whole."""
    jcfg, tcfg, np_params, _ = hymba
    p = jax.tree.map(lambda a: np.array(a[0]),
                     np_params["blocks"]["mixer"]["mamba"])
    p["a_log"] = np.random.default_rng(2).normal(
        scale=0.5, size=p["a_log"].shape).astype(np.float32)
    pj, pt = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
    rng = np.random.default_rng(3)
    B, S, di, st = 2, 10, tcfg.ssm.d_inner, tcfg.ssm.state
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(B, di, st)).astype(np.float32) if carried else None
    c0 = rng.normal(size=(B, 3, di)).astype(np.float32) if carried else None
    u = rng.normal(size=(B, S, di)).astype(np.float32)
    oj, sj = jhy._causal_conv(jnp.asarray(u), pj["conv_w"], pj["conv_b"],
                              None if c0 is None else jnp.asarray(c0))
    ot, s_t = thy._causal_conv(torch.from_numpy(u), pt["conv_w"],
                               pt["conv_b"],
                               None if c0 is None else torch.from_numpy(c0))
    _close(ot, oj, what="conv out")
    _close(s_t, sj, tol=0, what="conv state")

    def opt(a):
        return None if a is None else jnp.asarray(a)

    yj, hj, cj = jax.jit(lambda p, x, h, c: jhy.mamba_apply(
        p, x, jcfg, ssm_state=h, conv_state=c, return_state=True))(
        pj, jnp.asarray(x), opt(h0), opt(c0))

    def topt(a):
        return None if a is None else torch.from_numpy(a)

    yt, ht, ct = thy.mamba_apply(pt, torch.from_numpy(x), tcfg,
                                 ssm_state=topt(h0), conv_state=topt(c0),
                                 return_state=True)
    _close(yt, yj, what="mamba y")
    _close(ht, hj, what="ssm state")
    _close(ct, cj, what="conv state")
    y1, h1, c1 = thy.mamba_apply(pt, torch.from_numpy(x[:, :6]), tcfg,
                                 ssm_state=topt(h0), conv_state=topt(c0),
                                 return_state=True)
    y2, h2, c2 = thy.mamba_apply(pt, torch.from_numpy(x[:, 6:]), tcfg,
                                 ssm_state=h1, conv_state=c1,
                                 return_state=True)
    _close(torch.cat([y1, y2], 1), yt.numpy(), what="split sequence")
    _close(h2, ht.numpy(), what="split ssm state")


def test_softplus_is_logaddexp():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.5, 20.5, 30.0, 80.0])
    np.testing.assert_allclose(
        thy.softplus(x).numpy(), np.asarray(jax.nn.softplus(
            jnp.asarray(x.numpy()))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("S", [5, 16, 23])
def test_ring_place_matches_jax(S):
    k = np.random.default_rng(S).normal(size=(2, 3, S, 4)).astype(np.float32)
    for W in (8, 16, 30):
        np.testing.assert_array_equal(
            tlm._ring_place(torch.from_numpy(k), W).numpy(),
            np.asarray(jlm._ring_place(jnp.asarray(k), W)))


def test_mixer_apply_and_decode_past_the_window(hymba):
    """``hymba_mixer_apply`` over a sequence, and ``hymba_mixer_decode``
    against a ring buffer of the window's 16 slots with ``cache_len`` past
    it (the new row overwrites the oldest), every state carried."""
    jcfg, tcfg, np_params, _ = hymba
    pj, pt = _layer0(np_params, "mixer")
    rng = np.random.default_rng(6)
    B, S = 2, 20
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    yj = jax.jit(lambda p, x, pos: jhy.hymba_mixer_apply(
        p, x, jcfg, positions=pos))(pj, jnp.asarray(x), jnp.asarray(pos))
    yt = thy.hymba_mixer_apply(pt, torch.from_numpy(x), tcfg,
                               positions=torch.from_numpy(pos.copy()))
    _close(yt, yj, what="mixer apply")
    W, Hkv, D = tcfg.window, tcfg.n_kv_heads, tcfg.head_dim_
    di, st = tcfg.ssm.d_inner, tcfg.ssm.state
    k = rng.normal(size=(B, Hkv, W, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, W, D)).astype(np.float32)
    h = rng.normal(size=(B, di, st)).astype(np.float32)
    c = rng.normal(size=(B, 3, di)).astype(np.float32)
    x1 = rng.normal(size=(B, tcfg.d_model)).astype(np.float32)
    lens = np.array([16, 37], np.int32)
    out_j = jax.jit(lambda p, *a: jhy.hymba_mixer_decode(
        p, a[0], jcfg, cache_k=a[1], cache_v=a[2], cache_len=a[3],
        ssm_state=a[4], conv_state=a[5]))(
        pj, *(jnp.asarray(a) for a in (x1, k, v, lens, h, c)))
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out_t = thy.hymba_mixer_decode(
        pt, torch.from_numpy(x1), tcfg, cache_k=kt, cache_v=vt,
        cache_len=torch.from_numpy(lens), ssm_state=torch.from_numpy(h),
        conv_state=torch.from_numpy(c))
    assert out_t[1] is kt and out_t[2] is vt
    for name, got, want in zip(("y1", "k", "v", "ssm", "conv"), out_t,
                               out_j):
        _close(got, want, what=name)


def test_lm_schema_forward_and_loss_match_jax(hymba):
    jcfg, tcfg, np_params, tparams = hymba
    ours = tree_leaves(model_fns(tcfg).init(torch.Generator().manual_seed(0)))
    assert [tuple(a.shape) for a in ours] == \
        [a.shape for a in jax.tree_util.tree_leaves(np_params)]
    assert tparams["blocks"]["mixer"]["mamba"]["dt_a"].shape == (2, 128, 16)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(1, tcfg.vocab_size, (2, 24)).astype(np.int32)
             for k in ("tokens", "labels")}
    jp = jax.tree.map(jnp.asarray, np_params)
    lg_j, aux_j = jax.jit(jlm.lm_forward, static_argnums=2)(
        jp, jnp.asarray(batch["tokens"]), jcfg)
    lg_t, aux_t = tlm.lm_forward(tparams, torch.from_numpy(batch["tokens"]),
                                 tcfg)
    _close(lg_t, lg_j, what="logits")
    assert float(aux_t) == float(aux_j) == 0.0
    loss_j, m_j = jax.jit(jax_model_fns(jcfg).loss)(jp, batch)
    loss_t, m_t = model_fns(tcfg).loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    for got, want in ((loss_t, loss_j), (m_t["ce"], m_j["ce"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_lm_loss_gradients_match_jax(hymba):
    """Every leaf's gradient, relative L2 difference ≤ 1e-4."""
    jcfg, tcfg, np_params, _ = hymba
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(1, tcfg.vocab_size, (2, 20)).astype(np.int32)
             for k in ("tokens", "labels")}
    gj = jax.jit(jax.grad(lambda p: jax_model_fns(jcfg).loss(p, batch)[0]))(
        jax.tree.map(jnp.asarray, np_params))
    leaves = jax.tree.map(lambda a: a.requires_grad_(),
                          params_from_numpy(np_params, tcfg))
    model_fns(tcfg).loss(leaves, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})[0].backward()
    paths = jax.tree_util.tree_flatten_with_path(gj)[0]
    for (path, want), got in zip(paths, tree_leaves(leaves)):
        want = np.asarray(want)
        err = np.linalg.norm(got.grad.numpy() - want)
        assert err <= 1e-4 * np.linalg.norm(want), \
            (jax.tree_util.keystr(path), err)


def test_prefill_and_decode_match_jax(hymba):
    """``lm_prefill``'s logits and every cache entry (the ring placed from
    a 12-token prompt), then eight ``lm_decode_step``s on fed tokens, the
    ring wrapping at the fifth: logits and every entry after each."""
    jcfg, tcfg, np_params, tparams = hymba
    rng = np.random.default_rng(4)
    B, S, max_len = 2, 12, 40
    tokens = rng.integers(1, tcfg.vocab_size, (B, S)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, np_params)
    lg_j, cj = jax.jit(jlm.lm_prefill, static_argnums=(2, 3))(
        jp, jnp.asarray(tokens), jcfg, max_len)
    lg_t, ct = tlm.lm_prefill(tparams, torch.from_numpy(tokens), tcfg,
                              max_len)
    assert sorted(ct) == sorted(cj) == ["conv", "k", "len", "ssm", "v"]
    assert ct["k"].shape[3] == tcfg.window
    assert ct["ssm"].dtype == torch.float32
    _close(lg_t, lg_j, what="prefill logits")
    step = jax.jit(jlm.lm_decode_step, static_argnums=3)
    for t in range(9):
        for name in cj:
            if name == "len":
                np.testing.assert_array_equal(ct[name].numpy(), cj[name])
            else:
                _close(ct[name], cj[name], what=f"{name} step {t}")
        if t == 8:
            break
        tok = rng.integers(1, tcfg.vocab_size, (B,)).astype(np.int32)
        lg_j, cj = step(jp, jnp.asarray(tok), cj, jcfg)
        lg_t, ct = tlm.lm_decode_step(tparams, torch.from_numpy(tok), ct,
                                      tcfg)
        _close(lg_t, lg_j, what=f"decode logits step {t}")


@pytest.mark.parametrize("over", [{}, {"compute_dtype": "bfloat16",
                                       "opt_dus_cache": True}],
                         ids=["f32", "bf16_dus"])
def test_greedy_streams_match_jax(hymba, over):
    """20-token prompts and 10 new tokens: the ring of 16 wraps from the
    first decode step."""
    jcfg, tcfg, np_params, tparams = hymba
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    prompts = np.random.default_rng(3).integers(
        1, tcfg.vocab_size, (3, 20)).astype(np.int32)
    want = JaxServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                          max_len=30).generate(prompts, 10)
    got = ServeEngine(tcfg, tparams, max_len=30, device="cpu").generate(
        prompts, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_paged_engine_refuses(hymba):
    _, tcfg, _, tparams = hymba
    with pytest.raises(ValueError, match="paged serving"):
        ContinuousEngine(tcfg, tparams, device="cpu")


def _served(caplog, argv):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve"):
        launch_serve.main(argv)
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("seq")]


def test_launchers_serve_and_train(caplog):
    """``launch.serve --engine static`` serves the reduced model,
    ``--engine paged`` refuses it; ``launch.train`` takes its steps."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--max-new", "4"]
    seqs = _served(caplog, argv)
    assert len(seqs) == 2
    with pytest.raises(ValueError, match="paged serving"):
        launch_serve.main(argv + ["--engine", "paged"])
    out = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
