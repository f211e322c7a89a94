"""The port's naive attention path, its fixed-point serving and the Table III
finetuning workflow on the CPU against the JAX package.

* ``attention_apply(attention_impl="naive")`` for every softmax impl,
  causal and bidirectional, with a sliding window, GQA (reduced
  llama3.2-3b, 4 query heads on 2 KV heads) and QK-norm (reduced
  qwen3-4b), the JAX init bridged through numpy. Float impls: within 1e-5
  of the largest |output| (the two packages' float32 products sum in
  another order). ``softermax_fixed``: on identical scores the fixed-point
  ``p`` is EXACTLY the reference's; end to end a score within fp32 noise
  of a Q(6,2) rounding boundary may round the other way, which moves one
  ``p`` entry by one Q(1,7) step, so the attention output is held within
  2^-7 · max|v| (+ 1e-5 relative) and the projected output within that
  step through the largest row sum of |wo|.
* Greedy streams of reduced llama3.2-3b in float32 with
  ``softmax_impl="softermax_fixed"`` (every prefill forced onto the naive
  path; decode on the float IntMax) and with ``attention_impl="naive"``:
  the port's static engine and its paged engine (one-shot prefill) emit
  EXACTLY the JAX ``ServeEngine``'s.
* The weight bridge carries bert-base (gelu, tied embeddings; MHA at full
  width, 4 query on 2 KV heads in the reduced config): the
  port's ``lm_loss`` of the bridged JAX init equals the reference's within
  1e-5 relative, with the float and the fixed-point Softermax.
* Softermax-aware finetuning with K7's forward: on the card the
  ``softermax_fixed`` path runs K7 (numerators recomputed against the
  final max), on the CPU ``softermax_fixed`` (quantized at the running
  max); the two differ by one Q(1,7) step at ties. Three QAT steps of
  reduced bert-base with the kernel's mirror as the forward (the trainable
  ``softermax_quant_op``) against ``softermax_fixed``: losses within 1e-3
  relative, the grad norm within 1e-3 at step 0 and 2e-2 after, every
  parameter leaf within 1e-3 in relative L2 — the bounds ``chip_smoke.py``
  holds the card's QAT steps to against the CPU's.
* The Table III workflow (``table3_accuracy.finetune_variants``, what the
  port's ``run`` calls on its own init) against the reference's
  ``benchmarks/table3_accuracy.py::run`` at 3 pretrain and 2 finetune
  steps from the same initial weights: the four eval losses within 1e-4
  relative. As ``tests/test_torch_train.py`` sets
  out, AdamW divides each element's moment by its own root mean square,
  so float32 gradient noise becomes element-wise trajectory noise up to
  ~lr on noise-floor elements; at lr <= 3e-3 over 5 steps that moved a loss of
  ~24 by up to 2.3e-5 relative (``softermax_fixed``; 2.8e-6 for softmax),
  and a score on a Q(6,2) rounding boundary may flip one Q(1,7) step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import table3_accuracy as jax_table3
from repro.models import attention as JA
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.benchmarks import table3_accuracy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.core.softermax import attention_softmax
from repro_torch.data import SyntheticLMData
from repro_torch.kernels.softermax_quant import softermax_quant_op
from repro_torch.models import attention as TA
from repro_torch.models.registry import (get_config, init_lm_params,
                                         model_fns, reduce_config)
from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.train import make_train_step

IMPLS = ["softmax", "base2", "base2_folded", "softermax", "softermax_fixed"]
Q17 = 2.0 ** -7


def _jit_unoptimized(fn):
    """``jax.jit`` with XLA's backend optimization off: the reference's
    inits and losses compile in less than half the CPU time. Not for the
    Table III trajectories: their float32 sums run in another order, and a
    Q(6,2) flip there moves ``softermax_fixed``'s loss by up to 1e-4."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module", params=["llama3.2-3b", "qwen3-4b"])
def mixer(request):
    """One layer's attention parameters of the JAX init, in both
    packages."""
    jcfg = jax_reduce_config(jax_get_config(request.param))
    tcfg = reduce_config(get_config(request.param))
    jp = _jit_unoptimized(jax_model_fns(jcfg).init)(jax.random.PRNGKey(1))
    mp = jax.tree.map(lambda a: np.asarray(a)[0], jp["blocks"]["mixer"])
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), mp)
    return jcfg, tcfg, mp, tp


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)],
                         ids=["causal", "bidirectional", "window"])
@pytest.mark.parametrize("impl", IMPLS)
def test_naive_attention_matches_jax(mixer, impl, causal, window):
    jcfg, tcfg, mp, tp = mixer
    jcfg = jcfg.replace(attention_impl="naive", softmax_impl=impl)
    tcfg = tcfg.replace(attention_impl="naive", softmax_impl=impl)
    rng = np.random.default_rng(len(impl))
    B, S = 2, 19
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = np.asarray(JA.attention_apply(
        mp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), causal=causal,
        window=window))
    got = TA.attention_apply(tp, torch.from_numpy(x), tcfg,
                             positions=torch.from_numpy(pos), causal=causal,
                             window=window).numpy()
    scale = np.abs(want).max()
    if impl != "softermax_fixed":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
        return
    # one Q(1,7) step of p times max|v|, through the output projection
    step = Q17 * np.abs(np.einsum("bsd,dhk->bhsk", x, mp["wv"])).max()
    wo = mp["wo"].reshape(-1, mp["wo"].shape[-1])
    assert np.abs(got - want).max() <= \
        step * np.abs(wo).sum(0).max() + 1e-5 * scale


_jax_fixed_softmax = jax.jit(
    lambda a: JA.attention_softmax(a, "softermax_fixed"))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)],
                         ids=["causal", "bidirectional", "window"])
def test_naive_fixed_point_p_and_output(causal, window):
    """softermax_fixed: p EXACTLY the reference's on identical scores; the
    attention output within one Q(1,7) step of p times max|v|."""
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b")).replace(
        softmax_impl="softermax_fixed")
    tcfg = reduce_config(get_config("llama3.2-3b")).replace(
        softmax_impl="softermax_fixed")
    rng = np.random.default_rng(17)
    B, S = 2, 19
    q = rng.normal(size=(B, 4, S, 16)).astype(np.float32)
    k = rng.normal(size=(B, 2, S, 16)).astype(np.float32)
    v = rng.normal(size=(B, 2, S, 16)).astype(np.float32)
    s = torch.from_numpy(q).reshape(B, 2, 2, S, 16) @ \
        torch.from_numpy(k)[:, :, None].transpose(-1, -2)
    s = (s * 3.0).numpy()
    np.testing.assert_array_equal(
        attention_softmax(torch.from_numpy(s), "softermax_fixed").numpy(),
        np.asarray(_jax_fixed_softmax(jnp.asarray(s))))
    o_want = np.asarray(JA._naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, causal=causal,
        window=window, q_offset=0))
    o_got = TA._naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tcfg, causal=causal,
                                window=window).numpy()
    step = Q17 * np.abs(v).max()
    assert np.abs(o_got - o_want).max() <= step + 1e-5 * np.abs(o_want).max()


def test_naive_base_e_folds_log2e_twice_as_the_reference():
    """A property of the reference, kept by the port: ``_mode``
    premultiplies q by log2(e) for the base-e impls, and the naive path's
    ``attention_softmax`` then takes e^s ("softmax") or folds log2(e) again
    ("base2_folded"), so both compute 2^(log2(e)^2 · q·k) — not the e-base
    softmax of the chunked and flash paths."""
    cfg = reduce_config(get_config("llama3.2-3b"))
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    for impl in ("softmax", "base2_folded"):
        c = cfg.replace(softmax_impl=impl)
        qs = TA.q_scale(q, c)
        naive = TA._naive_attention(qs, k, v, c, causal=True, window=0)
        once = TA.chunked_attention(qs, k, v, causal=True, intmax=False)
        twice = TA.chunked_attention(qs * TA.LOG2_E, k, v, causal=True,
                                     intmax=False)
        torch.testing.assert_close(naive, twice, rtol=0, atol=1e-5)
        assert (naive - once).abs().max().item() > 1e-2


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b"))
    tcfg = reduce_config(get_config("llama3.2-3b"))
    jparams = _jit_unoptimized(jax_model_fns(jcfg).init)(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("over", [{"softmax_impl": "softermax_fixed"},
                                  {"attention_impl": "naive"}],
                         ids=["softermax_fixed", "naive_softermax"])
def test_engines_match_jax(llama, over):
    jcfg, tcfg, jparams, tparams = llama
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    prompts = np.random.default_rng(3).integers(
        1, tcfg.vocab_size, (3, 20)).astype(np.int32)
    want = JaxServeEngine(jcfg, jparams, max_len=28).generate(prompts, 8)
    static = ServeEngine(tcfg, tparams, max_len=28, device="cpu").generate(
        prompts, 8)
    np.testing.assert_array_equal(static.tokens, want.tokens)
    eng = ContinuousEngine(tcfg, tparams, block_size=8, num_blocks=32,
                           max_batch=4, max_len=32, device="cpu")
    handles = [eng.submit(p, 8) for p in prompts]
    res = eng.run()
    for h, row in zip(handles, want.tokens):
        assert res[h.req_id].tokens == row.tolist()


@pytest.mark.parametrize("impl", ["softermax", "softermax_fixed"])
def test_bridge_carries_bert_base(impl):
    jcfg = jax_reduce_config(jax_get_config("bert-base")).replace(
        causal=True, softmax_impl=impl)
    tcfg = reduce_config(get_config("bert-base")).replace(
        causal=True, softmax_impl=impl)
    full = get_config("bert-base")
    assert (full.activation, full.tie_embeddings, full.n_heads,
            full.n_kv_heads) == ("gelu", True, 12, 12)      # MHA at width
    jparams = _jit_unoptimized(jax_model_fns(jcfg).init)(
        jax.random.PRNGKey(2))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    assert "unembed" not in tparams["embed"]
    batch = {k: v[:4, :24] for k, v in next(jax_table3.SyntheticLMData(
        tcfg.vocab_size, 32, 4, seed=5)).items()}
    want = float(_jit_unoptimized(jax_model_fns(jcfg).loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})[0])
    with torch.no_grad():
        got = float(model_fns(tcfg).loss(
            tparams, {k: torch.from_numpy(v.copy())
                      for k, v in batch.items()})[0])
    assert abs(got - want) <= 1e-5 * abs(want)


def _qat_steps(cfg, init, steps=3):
    params = tree_map(lambda a: a.clone(), init)
    opt = adamw.init_state(params)
    step = make_train_step(model_fns(cfg).loss, TrainConfig(
        total_steps=steps, warmup_steps=1, learning_rate=1e-4))
    data = SyntheticLMData(cfg.vocab_size, 64, 16, seed=0)
    rows = []
    for _ in range(steps):
        params, opt, m = step(params, opt, next(data))
        rows.append({k: float(v) for k, v in m.items()})
    return rows, params


def test_qat_with_the_kernels_forward(monkeypatch):
    cfg = reduce_config(get_config("bert-base")).replace(
        causal=True, softmax_impl="softermax_fixed")
    init = init_lm_params(cfg, torch.Generator().manual_seed(0))
    plain_rows, plain = _qat_steps(cfg, init)

    calls = []

    def kernel_forward(scores, impl="softermax", axis=-1):
        assert impl == "softermax_fixed" and axis == -1
        calls.append(scores.shape)
        return softermax_quant_op(scores)

    monkeypatch.setattr(TA, "attention_softmax", kernel_forward)
    rows, params = _qat_steps(cfg, init)
    for s, (a, b) in enumerate(zip(rows, plain_rows)):
        for key in ("loss", "ce", "grad_norm"):
            tol = 2e-2 if key == "grad_norm" and s > 0 else 1e-3
            assert abs(a[key] - b[key]) <= tol * abs(b[key]), (s, key, a, b)
    assert len(calls) == 3 * cfg.n_layers
    for a, b in zip(tree_leaves(params), tree_leaves(plain)):
        assert torch.linalg.vector_norm(a - b) <= \
            1e-3 * torch.linalg.vector_norm(b)


_FNS = {}


def _jitted_fns(cfg):
    """The reference's model interface with its loss compiled once for each
    configuration, so that the reference's eager evaluation loop runs
    compiled (the same function)."""
    if cfg not in _FNS:
        _FNS[cfg] = jax_model_fns(cfg)
        _FNS[cfg].loss = jax.jit(_FNS[cfg].loss)
    return _FNS[cfg]


def test_table3_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_table3, "model_fns", _jitted_fns)
    want = jax_table3.run(pretrain_steps=3, finetune_steps=2)
    jcfg = jax_reduce_config(jax_get_config("bert-base")).replace(
        causal=True, softmax_impl="softmax")
    init = jax.tree.map(np.array, jax_model_fns(jcfg).init(
        jax.random.PRNGKey(0)))
    tcfg = table3_accuracy.table3_config()
    params = params_from_numpy(init, tcfg)
    got = table3_accuracy.finetune_variants(tcfg, params, pretrain_steps=3,
                                            finetune_steps=2)
    assert list(got) == list(want)
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    assert max(rel.values()) <= 1e-4, (got, want, rel)
    # the workflow leaves the caller's weights as they were
    torch.testing.assert_close(params["embed"]["embedding"],
                               torch.from_numpy(init["embed"]["embedding"]),
                               rtol=0, atol=0)
    text = table3_accuracy.report(got)
    assert "fixed-point drop-in penalty" in text
    assert all(name in text for name in want)


def test_table3_run_on_the_cpu():
    """``run`` draws its own init and returns the four finite losses."""
    got = table3_accuracy.run(pretrain_steps=1, finetune_steps=1,
                              device="cpu")
    assert list(got) == ["softmax", "softermax", "softermax_fixed",
                         "softermax_fixed_no_finetune"]
    assert all(np.isfinite(v) for v in got.values())
