"""The port's MLA family (``models/mla.py`` and its hooks in ``models/lm.py``)
on the CPU against the JAX package.

Reduced deepseek-v2-236b: 2 layers (one ``first_dense`` head block with a
dense FFN of 64, one MoE block of 8 experts of 32, top-2, 2 shared
experts), d 64, 4 heads, q_lora 32, kv_lora 24, qk 16+8, v 16. Weights
come from the reference's ``model_fns(cfg).init`` through the numpy
bridge; inputs from numpy seeds.

Tolerances: module outputs, logits and every cache entry within 1e-5 of
each tensor's largest magnitude in float32 (the float32 sum-order rule of
ROADMAP Queue 3); gradients within 1e-4 relative L2 per leaf; the static
engines' greedy streams EXACTLY equal, in float32 and bfloat16 compute.
"""
import dataclasses

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.models.schema import init_params as jax_init_params
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.serve import ContinuousEngine, ServeEngine

ARCH = "deepseek-v2-236b"
TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.fixture(scope="module")
def deepseek():
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    tcfg = reduce_config(get_config(ARCH))
    np_params = jax.tree.map(np.asarray,
                             jax_model_fns(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, np_params, params_from_numpy(np_params, tcfg)


def _schema_shapes(schema):
    if isinstance(schema, dict):
        return {k: _schema_shapes(v) for k, v in schema.items()}
    return tuple(schema.shape)


def _mixer(form, deepseek):
    """(jcfg, tcfg, numpy MLA params) of the q_lora form (layer 0 of the
    reduced model's body stack) or the wq form (q_lora 0, its own init)."""
    jcfg, tcfg, np_params, _ = deepseek
    if form == "q_lora":
        return jcfg, tcfg, jax.tree.map(lambda a: np.array(a[0]),
                                        np_params["blocks"]["mixer"])
    jcfg, tcfg = (c.replace(mla=dataclasses.replace(c.mla, q_lora=0))
                  for c in (jcfg, tcfg))
    p = jax_init_params(jax.random.PRNGKey(1), jmla.mla_schema(jcfg))
    return jcfg, tcfg, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("form", ["q_lora", "wq"])
def test_mla_schema_and_apply_match_jax(deepseek, form):
    """Both forms of ``mla_apply`` (expanded, absorbed) against the JAX
    function and against each other, over two attention chunks; the
    cache entries of ``mla_prefill_cache`` against the JAX function's
    ``return_cache`` ones and its ``mla_prefill_cache``."""
    jcfg, tcfg, p = _mixer(form, deepseek)
    assert _schema_shapes(tmla.mla_schema(tcfg)) == \
        _schema_shapes(jmla.mla_schema(jcfg))
    assert ("wq" in p) == (form == "wq")
    rng = np.random.default_rng(5)
    B, S = 2, 40
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    pj = jax.tree.map(jnp.asarray, p)
    pt = jax.tree.map(torch.from_numpy, p)
    ys = {}
    for absorbed in (False, True):
        jc = jcfg.replace(opt_mla_absorbed=absorbed)
        tc = tcfg.replace(opt_mla_absorbed=absorbed)
        yj, cj, kj = jax.jit(lambda p, x, pos: jmla.mla_apply(
            p, x, jc, positions=pos, return_cache=True))(
            pj, jnp.asarray(x), jnp.asarray(pos))
        yt = tmla.mla_apply(pt, torch.from_numpy(x), tc,
                            positions=torch.from_numpy(pos.copy()))
        _close(yt, yj, what=f"y absorbed={absorbed}")
        ys[absorbed] = yt
    _close(ys[True], ys[False].numpy(), what="absorbed vs expanded")
    ct, kt = tmla.mla_prefill_cache(pt, torch.from_numpy(x), tcfg,
                                    torch.from_numpy(pos.copy()))
    _close(ct, cj, what="c_kv")
    _close(kt, kj, what="k_rope")
    cj2, kj2 = jmla.mla_prefill_cache(pj, jnp.asarray(x), jcfg,
                                      jnp.asarray(pos))
    _close(ct, np.asarray(cj2), what="c_kv vs mla_prefill_cache")
    _close(kt, np.asarray(kj2), what="k_rope vs mla_prefill_cache")


@pytest.mark.parametrize("dus", [False, True], ids=["onehot", "dus"])
def test_mla_decode_matches_jax(deepseek, dus):
    """The absorbed decode against a latent cache with live rows, its new
    latent row written at ``cache_len`` (one-hot add in the reference,
    ``dynamic_update_slice`` under ``opt_dus_cache``)."""
    jcfg, tcfg, np_params, _ = deepseek
    jcfg, tcfg = (c.replace(opt_dus_cache=dus) for c in (jcfg, tcfg))
    p = jax.tree.map(lambda a: np.array(a[0]), np_params["blocks"]["mixer"])
    rng = np.random.default_rng(9)
    B, S, a = 3, 24, tcfg.mla
    lens = np.array([11, 11, 11] if dus else [0, 7, 23], np.int32)
    ckv = rng.normal(size=(B, S, a.kv_lora)).astype(np.float32)
    krope = rng.normal(size=(B, S, a.qk_rope)).astype(np.float32)
    for b, n in enumerate(lens):
        ckv[b, n:] = 0
        krope[b, n:] = 0
    x1 = rng.normal(size=(B, tcfg.d_model)).astype(np.float32)
    yj, cj, kj = jax.jit(lambda p, x, c, k, n: jmla.mla_decode(
        p, x, jcfg, cache_ckv=c, cache_krope=k, cache_len=n))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x1), jnp.asarray(ckv),
        jnp.asarray(krope), jnp.asarray(lens))
    ct, kt = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    yt, c_out, k_out = tmla.mla_decode(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x1), tcfg,
        cache_ckv=ct, cache_krope=kt, cache_len=torch.from_numpy(lens))
    assert c_out is ct and k_out is kt          # written in place
    _close(yt, yj, what="y1")
    _close(ct, cj, what="ckv")
    _close(kt, kj, what="krope")


def test_lm_schema_forward_and_loss_match_jax(deepseek):
    jcfg, tcfg, np_params, tparams = deepseek
    assert _schema_shapes(tlm.lm_schema(tcfg)) == \
        _schema_shapes(jlm.lm_schema(jcfg))
    assert tparams["head_blocks"]["mixer"]["wq_b"].shape == (1, 32, 4, 24)
    assert tparams["head_blocks"]["ffn"]["wi"].shape == (1, 64, 64)
    assert "shared" in tparams["blocks"]["ffn"]
    ours = tree_leaves(model_fns(tcfg).init(torch.Generator().manual_seed(0)))
    assert [tuple(a.shape) for a in ours] == \
        [a.shape for a in jax.tree_util.tree_leaves(np_params)]
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, tcfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(1, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, np_params)
    lg_j, aux_j = jax.jit(jlm.lm_forward, static_argnums=2)(
        jp, jnp.asarray(tokens), jcfg)
    lg_t, aux_t = tlm.lm_forward(tparams, torch.from_numpy(tokens), tcfg)
    _close(lg_t, lg_j, what="logits")
    assert float(aux_t) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    batch = {"tokens": tokens, "labels": labels}
    loss_j, m_j = jax.jit(jax_model_fns(jcfg).loss)(jp, batch)
    loss_t, m_t = model_fns(tcfg).loss(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    for got, want in ((loss_t, loss_j), (m_t["ce"], m_j["ce"]),
                      (m_t["aux"], m_j["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _grad_check(jcfg, tcfg, np_params, seq=16, seed=2):
    """``lm_loss``'s gradient of every leaf against ``jax.grad``'s: relative
    L2 difference ≤ 1e-4."""
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(1, tcfg.vocab_size, (2, seq)).astype(np.int32)
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
            (jax.tree_util.keystr(path), err, np.linalg.norm(want))


@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
def test_lm_loss_gradients_match_jax(deepseek, absorbed):
    jcfg, tcfg, np_params, _ = deepseek
    _grad_check(jcfg.replace(opt_mla_absorbed=absorbed),
                tcfg.replace(opt_mla_absorbed=absorbed), np_params)


def test_prefill_and_decode_match_jax(deepseek):
    """``lm_prefill``'s logits and every cache entry (``head_ckv`` and
    ``head_krope`` of the dense head block included), then four
    ``lm_decode_step``s on the same fed tokens: logits and every entry
    after each."""
    jcfg, tcfg, np_params, tparams = deepseek
    rng = np.random.default_rng(4)
    B, S, max_len = 2, 12, 20
    tokens = rng.integers(1, tcfg.vocab_size, (B, S)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, np_params)
    lg_j, cj = jax.jit(jlm.lm_prefill, static_argnums=(2, 3))(
        jp, jnp.asarray(tokens), jcfg, max_len)
    lg_t, ct = tlm.lm_prefill(tparams, torch.from_numpy(tokens), tcfg,
                              max_len)
    assert sorted(ct) == sorted(cj) == ["ckv", "head_ckv", "head_krope",
                                        "krope", "len"]
    spec = tlm.cache_spec(tcfg, B, max_len)
    assert {k: v[0] for k, v in spec.items()} == \
        {k: tuple(v.shape) for k, v in cj.items()}
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
                                  {"opt_mla_absorbed": True,
                                   "opt_dus_cache": True}],
                         ids=["f32", "bf16", "absorbed_dus"])
def test_greedy_streams_match_jax(deepseek, over):
    jcfg, tcfg, np_params, tparams = deepseek
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    prompts = np.random.default_rng(3).integers(
        1, tcfg.vocab_size, (3, 20)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    want = JaxServeEngine(jcfg, jparams, max_len=28).generate(prompts, 8)
    got = ServeEngine(tcfg, tparams, max_len=28, device="cpu").generate(
        prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_engine_unstacks_each_stack_by_its_length(deepseek):
    """The static engine keeps the head stack and the body stack as
    per-layer lists of their own lengths (1 and 1 here, against
    ``n_layers`` 2)."""
    _, tcfg, _, tparams = deepseek
    for over in ({}, {"opt_bf16_params": True}):
        eng = ServeEngine(tcfg.replace(**over), tparams, max_len=8,
                          device="cpu")
        assert len(eng.params["head_blocks"]) == 1
        assert len(eng.params["blocks"]) == 1
        assert eng.params["head_blocks"][0]["ffn"]["wi"].shape == (64, 64)
        assert "router" in eng.params["blocks"][0]["ffn"]


def test_refusals(deepseek):
    """The paged engine refuses MLA, as the reference's does; a GQA MoE
    config with head blocks has no static cache (the reference's gives its
    head blocks no attention entries); whisper's family has its own
    ``model_fns`` (``models/whisper.py``): the engines and the launchers,
    which take prompts alone, refuse it, and so does ``lm_schema``."""
    _, tcfg, _, tparams = deepseek
    with pytest.raises(ValueError, match="paged serving"):
        ContinuousEngine(tcfg, tparams, device="cpu")
    gqa = reduce_config(get_config("moonshot-v1-16b-a3b"))
    gqa = gqa.replace(moe=dataclasses.replace(gqa.moe, first_dense=1,
                                              d_ff_dense=64))
    with pytest.raises(NotImplementedError, match="first_dense"):
        tlm.cache_spec(gqa, 2, 16)
    whisper = reduce_config(get_config("whisper-base"))
    wparams = model_fns(whisper).init(torch.Generator().manual_seed(0))
    for refuse in (lambda: ServeEngine(whisper, wparams, device="cpu"),
                   lambda: ContinuousEngine(whisper, wparams, device="cpu"),
                   lambda: launch_serve.main(["--arch", "whisper-base",
                                              "--reduced", "--device",
                                              "cpu"]),
                   lambda: launch_train.main(["--arch", "whisper-base",
                                              "--reduced", "--device",
                                              "cpu"])):
        with pytest.raises(ValueError, match=r"model_fns\(cfg\)\.prefill"):
            refuse()
    with pytest.raises(NotImplementedError, match="models/whisper.py"):
        tlm.lm_schema(whisper)


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
    # --optimized turns on opt_mla_absorbed (and the others): in float32
    # the absorbed form serves the same greedy tokens here
    assert _served(caplog, argv + ["--optimized"]) == seqs
    with pytest.raises(ValueError, match="paged serving"):
        launch_serve.main(argv + ["--engine", "paged"])
    out = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
