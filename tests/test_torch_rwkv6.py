"""The port's RWKV6 family (``models/rwkv6.py`` and its hooks in
``models/lm.py``) on the CPU against the JAX package.

Reduced rwkv6-7b: 2 layers, d 64, 4 heads of 16, mix LoRA 8, decay LoRA
8, d_ff 128. Weights come from the reference's ``model_fns(cfg).init``
through the numpy bridge (its zero-initialized ``mu``, ``w0`` and ``u``
are redrawn where a module test needs them live); inputs from numpy
seeds.

Tolerances: module outputs, states, logits and every cache entry within
1e-5 of each tensor's largest magnitude in float32 (the float32 sum-order
rule of ROADMAP Queue 3); gradients within 1e-4 relative L2 per leaf; the
static engines' greedy streams EXACTLY equal, in float32 and bfloat16
compute.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import rwkv6 as jrw
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv6 as trw
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.serve import ContinuousEngine, ServeEngine

ARCH = "rwkv6-7b"
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.fixture(scope="module")
def rwkv():
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    tcfg = reduce_config(get_config(ARCH))
    np_params = jax.tree.map(np.asarray,
                             jax_model_fns(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, np_params, params_from_numpy(np_params, tcfg)


def _live(np_params, part):
    """Layer 0's time- or channel-mix parameters with the zero-initialized
    mixing, decay base and bonus leaves redrawn, as numpy."""
    p = jax.tree.map(lambda a: np.array(a[0]), np_params["blocks"][part])
    rng = np.random.default_rng(11)
    for name in ("mu", "w0", "u", "mu_k", "mu_r"):
        if name in p:
            p[name] = rng.normal(scale=0.5, size=p[name].shape).astype(
                np.float32)
    return p


def _both(p):
    return jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)


def test_ddlerp_decay_head_norm_and_scan_match_jax(rwkv):
    jcfg, tcfg, np_params, _ = rwkv
    pj, pt = _both(_live(np_params, "mixer"))
    rng = np.random.default_rng(3)
    B, S, d = 2, 9, tcfg.d_model
    H, n = d // tcfg.ssm.head_size, tcfg.ssm.head_size
    x, xx = (rng.normal(size=(B, S, d)).astype(np.float32) for _ in "ab")
    _close(trw._ddlerp(pt, torch.from_numpy(x), torch.from_numpy(xx)),
           jrw._ddlerp(pj, jnp.asarray(x), jnp.asarray(xx)), what="ddlerp")
    _close(trw._decay(pt, torch.from_numpy(x)),
           jrw._decay(pj, jnp.asarray(x)), what="decay")
    y = rng.normal(size=(B, S, H, n)).astype(np.float32)
    _close(trw._head_norm(pt, torch.from_numpy(y), tcfg.norm_eps),
           jrw._head_norm(pj, jnp.asarray(y), jcfg.norm_eps), what="norm")
    r, k, v = (rng.normal(size=(B, S, H, n)).astype(np.float32)
               for _ in "rkv")
    w = rng.uniform(0.05, 0.99, (B, S, H, n)).astype(np.float32)
    s0 = rng.normal(size=(B, H, n, n)).astype(np.float32)
    u = np.asarray(pj["u"])
    yj, sj = jax.jit(jrw._wkv_scan)(*(jnp.asarray(a)
                                      for a in (r, k, v, w, u, s0)))
    yt, st = trw._wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u,
                                                            s0)))
    _close(yt, yj, what="wkv y")
    _close(st, sj, what="wkv state")


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_time_and_channel_mix_match_jax(rwkv, carried):
    """Time and channel mix over a sequence (with ``return_state``), from
    zero states or carried ones, and their one-token decodes from the
    states the sequence left."""
    jcfg, tcfg, np_params, _ = rwkv
    tj, tt = _both(_live(np_params, "mixer"))
    cj, ct = _both(_live(np_params, "ffn"))
    rng = np.random.default_rng(5)
    B, S, d = 2, 7, tcfg.d_model
    H, n = d // tcfg.ssm.head_size, tcfg.ssm.head_size
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    x1 = rng.normal(size=(B, d)).astype(np.float32)
    sh = rng.normal(size=(B, d)).astype(np.float32) if carried else None
    wk = rng.normal(size=(B, H, n, n)).astype(np.float32) if carried \
        else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    oj, shj, wkj = jax.jit(lambda p, x, s, w: jrw.rwkv_time_apply(
        p, x, jcfg, shift_state=s, wkv_state=w, return_state=True))(
        tj, jnp.asarray(x), j(sh), j(wk))
    ot, sht, wkt = trw.rwkv_time_apply(tt, torch.from_numpy(x), tcfg,
                                       shift_state=t(sh), wkv_state=t(wk),
                                       return_state=True)
    for name, got, want in (("time out", ot, oj), ("shift", sht, shj),
                            ("wkv", wkt, wkj)):
        _close(got, want, what=name)
    dj = jax.jit(lambda p, x, s, w: jrw.rwkv_time_decode(
        p, x, jcfg, shift_state=s, wkv_state=w))(tj, jnp.asarray(x1), shj,
                                                 wkj)
    dt = trw.rwkv_time_decode(tt, torch.from_numpy(x1), tcfg,
                              shift_state=sht, wkv_state=wkt)
    for name, got, want in zip(("time decode", "shift", "wkv"), dt, dj):
        _close(got, want, what=name)
    oj, shj = jax.jit(lambda p, x, s: jrw.rwkv_channel_apply(
        p, x, jcfg, shift_state=s, return_state=True))(
        cj, jnp.asarray(x), j(sh))
    ot, sht = trw.rwkv_channel_apply(ct, torch.from_numpy(x), tcfg,
                                     shift_state=t(sh), return_state=True)
    _close(ot, oj, what="channel out")
    _close(sht, shj, tol=0, what="channel shift")
    dj = jrw.rwkv_channel_decode(cj, jnp.asarray(x1), jcfg, shift_state=shj)
    dt = trw.rwkv_channel_decode(ct, torch.from_numpy(x1), tcfg,
                                 shift_state=sht)
    _close(dt[0], dj[0], what="channel decode")
    _close(dt[1], dj[1], tol=0, what="channel decode shift")


def test_lm_schema_forward_and_loss_match_jax(rwkv):
    jcfg, tcfg, np_params, tparams = rwkv
    ours = tree_leaves(model_fns(tcfg).init(torch.Generator().manual_seed(0)))
    assert [tuple(a.shape) for a in ours] == \
        [a.shape for a in jax.tree_util.tree_leaves(np_params)]
    assert tparams["blocks"]["mixer"]["mu"].shape == (2, 5, 64)
    assert tparams["blocks"]["mixer"]["wr"].shape == (2, 64, 4, 16)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(1, tcfg.vocab_size, (2, 24)).astype(np.int32)
             for k in ("tokens", "labels")}
    jp = jax.tree.map(jnp.asarray, np_params)
    lg_j, _ = jax.jit(jlm.lm_forward, static_argnums=2)(
        jp, jnp.asarray(batch["tokens"]), jcfg)
    lg_t, aux_t = tlm.lm_forward(tparams, torch.from_numpy(batch["tokens"]),
                                 tcfg)
    _close(lg_t, lg_j, what="logits")
    assert float(aux_t) == 0.0
    loss_j, m_j = jax.jit(jax_model_fns(jcfg).loss)(jp, batch)
    loss_t, m_t = model_fns(tcfg).loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    for got, want in ((loss_t, loss_j), (m_t["ce"], m_j["ce"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_lm_loss_gradients_match_jax(rwkv):
    """Every leaf's gradient, relative L2 difference ≤ 1e-4 (the
    zero-initialized ``mu``, ``w0`` and ``u`` get gradients too)."""
    jcfg, tcfg, np_params, _ = rwkv
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


def test_prefill_and_decode_match_jax(rwkv):
    """``lm_prefill``'s logits and every cache entry, then four
    ``lm_decode_step``s on fed tokens: logits and every entry after
    each."""
    jcfg, tcfg, np_params, tparams = rwkv
    rng = np.random.default_rng(4)
    B, S, max_len = 2, 12, 20
    tokens = rng.integers(1, tcfg.vocab_size, (B, S)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, np_params)
    lg_j, cj = jax.jit(jlm.lm_prefill, static_argnums=(2, 3))(
        jp, jnp.asarray(tokens), jcfg, max_len)
    lg_t, ct = tlm.lm_prefill(tparams, torch.from_numpy(tokens), tcfg,
                              max_len)
    assert sorted(ct) == sorted(cj) == ["len", "shift_c", "shift_t", "wkv"]
    assert ct["wkv"].dtype == torch.float32
    _close(lg_t, lg_j, what="prefill logits")
    step = jax.jit(jlm.lm_decode_step, static_argnums=3)
    for t in range(5):
        for name in cj:
            if name == "len":
                np.testing.assert_array_equal(ct[name].numpy(), cj[name])
            else:
                _close(ct[name], cj[name], what=f"{name} step {t}")
        if t == 4:
            break
        tok = rng.integers(1, tcfg.vocab_size, (B,)).astype(np.int32)
        lg_j, cj = step(jp, jnp.asarray(tok), cj, jcfg)
        lg_t, ct = tlm.lm_decode_step(tparams, torch.from_numpy(tok), ct,
                                      tcfg)
        _close(lg_t, lg_j, what=f"decode logits step {t}")


@pytest.mark.parametrize("over", [{}, {"compute_dtype": "bfloat16"},
                                  {"opt_bf16_params": True,
                                   "compute_dtype": "bfloat16"}],
                         ids=["f32", "bf16", "bf16_params"])
def test_greedy_streams_match_jax(rwkv, over):
    jcfg, tcfg, np_params, tparams = rwkv
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    prompts = np.random.default_rng(3).integers(
        1, tcfg.vocab_size, (3, 20)).astype(np.int32)
    want = JaxServeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                          max_len=28).generate(prompts, 8)
    got = ServeEngine(tcfg, tparams, max_len=28, device="cpu").generate(
        prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_engine_keeps_the_fp32_leaves(rwkv):
    """In bfloat16 compute the static engine casts the matrices once at
    load but keeps the leaves the reference reads in fp32 (``u``,
    ``out_norm``) in fp32."""
    _, tcfg, _, tparams = rwkv
    eng = ServeEngine(tcfg.replace(compute_dtype="bfloat16"), tparams,
                      max_len=8, device="cpu")
    mixer = eng.params["blocks"][0]["mixer"]
    assert mixer["wr"].dtype == torch.bfloat16
    assert mixer["u"].dtype == mixer["out_norm"].dtype == torch.float32


def test_paged_engine_refuses(rwkv):
    _, tcfg, _, tparams = rwkv
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
