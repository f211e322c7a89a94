"""The port's MoE layer and MoE LM on the CPU against the JAX package.

Reduced moonshot-v1-16b-a3b (2 layers, d 64, 4/2 heads, 8 experts of 32,
top-2) with the JAX init bridged through numpy, and a GQA variant with a
leading dense block and a shared expert (``first_dense=1, d_ff_dense=64,
n_shared=1, d_shared=32``). Inputs come from numpy seeds.

Held EXACTLY equal to the reference: the capacity C, and the routing of
``moe_apply`` (the selected experts ``sel``, ``keep`` and ``slot`` of every
assignment, from the reference's own ``_local_dispatch``) in float32 and
bfloat16 compute — with no drop, with a capacity that drops, on router
logits that tie exactly (duplicated router columns, dyadic inputs: the
reference breaks a tie toward the lower expert id), with a shared expert
and with ``opt_moe_shard_map`` and no process group (the global path, as
the reference takes without a mesh).

Tolerances: ``y`` within 1e-5 (float32) and 2e-2 (bfloat16, one rounding
of the output's scale) of the largest |y|; ``aux`` 1e-5 relative (the
jitted reference fuses its reductions); the
gradients of x, router, wi, wg and wo within 1e-4 of each one's largest
entry; logits 1e-4 of their largest entry, ``ce`` and ``aux`` 1e-5
relative. A three-step training trajectory is held as
``tests/test_torch_train.py`` holds the dense one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.softermax import attention_softmax as jax_softmax
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.train import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.train import make_train_step

ARCH = "moonshot-v1-16b-a3b"
VARIANT = dict(first_dense=1, d_ff_dense=64, n_shared=1, d_shared=32)


def _configs(**moe):
    jcfg = jax_reduce_config(jax_get_config(ARCH))
    tcfg = reduce_config(get_config(ARCH))
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe)),
            tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe)))


def _bridge(variant):
    jcfg, tcfg = _configs(**(VARIANT if variant else {}))
    jparams = jax_model_fns(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, np_params, params_from_numpy(np_params, tcfg)


@pytest.fixture(scope="module")
def moonshot():
    return _bridge(False)


@pytest.fixture(scope="module")
def variant():
    return _bridge(True)


def _ffn_params(np_params, stack="blocks"):
    """Layer 0's MoE parameters: numpy for JAX, tensors for the port."""
    tree = jax.tree.map(lambda a: np.array(a[0]), np_params[stack]["ffn"])
    return tree, jax.tree.map(torch.from_numpy, tree)


def _reference_capacity(T, k, E, cf):
    """The reference's capacity (``models/moe.py:94-95``)."""
    C = int(max(8, -(-T * k // E) * cf))
    return -(-C // 8) * 8


def test_capacity_is_the_references():
    for E, k in ((8, 2), (64, 6), (160, 6)):
        for cf in (0.5, 1.0, 1.25, 2.0):
            _, tcfg = _configs(n_experts=E, top_k=k, capacity_factor=cf)
            for T in list(range(1, 300)) + [1024, 4096, 8192]:
                assert tmoe.capacity(T, tcfg) == \
                    _reference_capacity(T, k, E, cf), (E, k, cf, T)
    _, tcfg = _configs()
    assert tmoe.capacity(4096, get_config(ARCH)) == 480


def test_top_k_stable_breaks_ties_toward_the_lower_index():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (64, 64)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 6)
    got_v, got_i = tmoe.top_k_stable(torch.from_numpy(scores), 6)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _case(name, moonshot, variant):
    """(jcfg, tcfg, numpy layer params, x (B, S, d) numpy) of one case."""
    jcfg, tcfg, np_params, _ = variant if name == "shared" else moonshot
    rng = np.random.default_rng(7)
    B, S = (2, 64) if name == "drop" else (2, 8)
    if name == "drop":
        jcfg, tcfg = (c.replace(moe=dataclasses.replace(
            c.moe, capacity_factor=0.5)) for c in (jcfg, tcfg))
    if name == "shard_map":
        jcfg, tcfg = (c.replace(opt_moe_shard_map=True)
                      for c in (jcfg, tcfg))
    p, _ = _ffn_params(np_params)
    p = dict(p)
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    if name == "ties":
        # dyadic inputs: every logit is exact in any summation order and
        # dtype; pairs of equal router columns tie exactly
        x = rng.integers(-1, 2, x.shape).astype(np.float32)
        r = rng.integers(-1, 2, p["router"].shape).astype(np.float32) / 8
        r[:, 1::2] = r[:, 0::2]
        p["router"] = r
    return jcfg, tcfg, p, x


CASES = ["no_drop", "drop", "ties", "shared", "shard_map"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_moe_apply_matches_jax(moonshot, variant, name, dtype):
    jcfg, tcfg, p, x = _case(name, moonshot, variant)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    pj = jax.tree.map(jnp.asarray, p)
    pt = jax.tree.map(torch.from_numpy, p)
    m = tcfg.moe
    B, S, d = x.shape
    T = B * S
    C = tmoe.capacity(T, tcfg)
    assert C == _reference_capacity(T, m.top_k, m.n_experts,
                                    m.capacity_factor)

    # the reference's routing: its router, softmax and _local_dispatch
    xf = xj.reshape(T, d)
    rl = (xf @ pj["router"].astype(jdt)).astype(jnp.float32)
    probs = jax_softmax(rl, impl=m.router_softmax, axis=-1)
    _, slot, keep, weights, sel = jmoe._local_dispatch(
        xf, probs, m.top_k, m.n_experts, C, jdt)
    got = tmoe.route(pt["router"], xt.reshape(T, d), tcfg, C)
    np.testing.assert_array_equal(got.sel.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(slot))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(weights),
                               rtol=1e-6, atol=1e-7)
    keep = np.asarray(keep)
    if name == "drop":
        assert not keep.all()
    else:
        assert keep.all()
    if name == "ties":
        # the k-th and (k+1)-th probabilities tie on some rows, so the
        # tie rule decides the selection there
        srt = -np.sort(-np.asarray(probs), axis=-1)
        assert (srt[:, m.top_k - 1] == srt[:, m.top_k]).any()

    ref = jmoe.moe_apply if name == "shard_map" else jmoe._moe_apply_global
    yj, auxj = jax.jit(ref, static_argnums=2)(pj, xj, jcfg)
    yt, auxt = tmoe.moe_apply(pt, xt, tcfg)
    assert yt.dtype == tdt and yt.shape == x.shape
    yj = np.asarray(yj.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.abs(yt.float().numpy() - yj).max() <= tol * np.abs(yj).max()
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)


def test_moe_gradients_match_jax(moonshot):
    jcfg, tcfg, np_params, _ = moonshot
    p, _ = _ffn_params(np_params)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    names = ("router", "wi", "wg", "wo")

    def jloss(x, *ws):
        y, aux = jmoe._moe_apply_global(dict(zip(names, ws)), x, jcfg)
        return jnp.sum(y * g) + aux

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        jnp.asarray(x), *(jnp.asarray(p[n]) for n in names))
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(p[n]).requires_grad_() for n in names]
    y, aux = tmoe.moe_apply(dict(zip(names, leaves[1:])), leaves[0], tcfg)
    (torch.sum(y * torch.from_numpy(g)) + aux).backward()
    for name, t, want in zip(("x",) + names, leaves, jg):
        want = np.asarray(want)
        err = np.abs(t.grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def _schema_shapes(schema):
    if isinstance(schema, dict):
        return {k: _schema_shapes(v) for k, v in schema.items()}
    return tuple(schema.shape)


@pytest.mark.parametrize("which", ["moonshot", "variant"])
def test_lm_schema_matches_jax(which, request):
    jcfg, tcfg, np_params, tparams = request.getfixturevalue(which)
    assert _schema_shapes(tlm.lm_schema(tcfg)) == \
        _schema_shapes(jlm.lm_schema(jcfg))
    assert ("head_blocks" in tparams) == (which == "variant")
    if which == "variant":
        assert "shared" in tparams["blocks"]["ffn"]
        assert tparams["head_blocks"]["ffn"]["wi"].shape == (1, 64, 64)
    ours = tree_leaves(model_fns(tcfg).init(torch.Generator().manual_seed(0)))
    assert [tuple(a.shape) for a in ours] == \
        [a.shape for a in jax.tree_util.tree_leaves(np_params)]


@pytest.mark.parametrize("which", ["moonshot", "variant"])
def test_lm_forward_and_loss_match_jax(which, request):
    jcfg, tcfg, np_params, tparams = request.getfixturevalue(which)
    batch = next(SyntheticLMData(tcfg.vocab_size, 24, 2, seed=1))
    jp = jax.tree.map(jnp.asarray, np_params)
    lg_j, aux_j = jax.jit(jlm.lm_forward, static_argnums=2)(
        jp, jnp.asarray(batch["tokens"]), jcfg)
    lg_t, aux_t = tlm.lm_forward(tparams, torch.as_tensor(batch["tokens"]),
                                 tcfg)
    lg_j = np.asarray(lg_j)
    assert np.abs(lg_t.numpy() - lg_j).max() <= 1e-4 * np.abs(lg_j).max()
    assert float(aux_t) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    (loss_j, m_j) = jax.jit(jax_model_fns(jcfg).loss)(jp, batch)
    loss_t, m_t = model_fns(tcfg).loss(
        tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(m_t) == sorted(m_j) == ["aux", "ce"]
    for got, want in ((loss_t, loss_j), (m_t["ce"], m_j["ce"]),
                      (m_t["aux"], m_j["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # the aux loss is the sum over the MoE layers alone
    assert float(m_t["aux"]) == pytest.approx(float(aux_t), rel=1e-6)


def test_remat_full_equals_none(variant):
    """Checkpointed layers return (x, aux) from the recompute: the same
    loss and gradients as without remat."""
    _, tcfg, np_params, _ = variant
    batch = next(SyntheticLMData(tcfg.vocab_size, 16, 2, seed=2))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = []
    for remat in ("none", "full"):
        params = params_from_numpy(np_params, tcfg)
        leaves = jax.tree.map(lambda a: a.requires_grad_(), params)
        loss, m = model_fns(tcfg.replace(remat=remat)).loss(leaves, batch)
        loss.backward()
        out.append((loss.item(), m["aux"].item(),
                    [a.grad.clone() for a in tree_leaves(leaves)]))
    assert out[0][:2] == out[1][:2]
    for a, b in zip(out[0][2], out[1][2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


STEPS, BATCH, SEQ = 3, 4, 32


@pytest.mark.parametrize("which", ["moonshot", "variant"])
def test_training_trajectory_matches_jax(which, request):
    """Three AdamW steps at lr 1e-3 (``tests/test_torch_train.py``'s
    tolerances at that rate): loss, ce, aux and lr within 1e-5 relative at
    every step, grad_norm within 1e-3 after the first, every final leaf
    within 2e-4 relative in L2 norm."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw
    jcfg, tcfg, np_params, tparams = request.getfixturevalue(which)
    tc = dict(total_steps=STEPS, warmup_steps=1, learning_rate=1e-3)
    keys = ("loss", "ce", "aux", "grad_norm", "lr")
    jstep = jax.jit(jax_make_train_step(jax_model_fns(jcfg).loss,
                                        JaxTrainConfig(**tc)))
    tstep = make_train_step(model_fns(tcfg).loss, TrainConfig(**tc))
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg)
    jopt, topt = jadamw.init_state(jp), tadamw.init_state(tp)
    data = SyntheticLMData(tcfg.vocab_size, SEQ, BATCH, seed=0)
    for s in range(STEPS):
        batch = next(data)
        jp, jopt, jm = jstep(jp, jopt, batch)
        tp, topt, tm = tstep(tp, topt, batch)
        for k in keys:
            rtol = 1e-3 if (k == "grad_norm" and s) else 1e-5
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, err_msg=f"{k} step {s}")
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 2e-4 * np.linalg.norm(b)


def test_first_dense_static_cache_refused(variant):
    """The GQA variant's head blocks have no static cache (the reference's
    gives them no attention entries); MLA's head blocks have theirs
    (``head_ckv``/``head_krope``)."""
    _, tcfg, _, _ = variant
    with pytest.raises(NotImplementedError, match="first_dense"):
        tlm.cache_spec(tcfg, 2, 16)
    spec = tlm.cache_spec(reduce_config(get_config("deepseek-v2-236b")), 2,
                          16)
    assert spec["head_ckv"][0] == (1, 2, 16, 24)
