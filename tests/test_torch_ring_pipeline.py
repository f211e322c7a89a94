"""The port's ring attention and GPipe pipeline against the JAX package, on
gloo process groups on the CPU.

The reference's forwards come from one JAX process with 8 virtual CPU
devices (the cases of ``tests/test_ring_pipeline.py``); the port's from 8
gloo ranks started once for the file (``tests/torch_ranks.py``). The
reference's ``jax.grad`` through ``shard_map`` does not run on this JAX
(it fails since the seed), so the gradients are held against the port's
one-rank paths, which earlier tests hold to the reference:
``chunked_attention`` for the ring, the stages run in sequence for the
pipeline.

Tolerances, and why:

* ring forward at meshes (2, 4) and (1, 8), causal and not: within 2e-5
  of the reference's (its own test's bound against ``chunked_attention``);
  the x8 adversarial scores: within 5e-5 (the same);
* ring gradients (dq, dk, dv of sum(o²)) against ``chunked_attention``'s
  autograd: within 1e-5 of each gradient's largest entry (the two sum the
  blocks' products in other orders; measured up to 1.5e-6);
* ``attention_apply`` under sequence-parallel rules with
  ``opt_ring_attention`` at (2, 4): the ring runs once a call and its
  output is within 1e-6 of the largest entry of the same call without
  the mesh (chunks of 32 against ring blocks of 16; measured 4.4e-7);
* pipeline forward at (4, 2) on reduced llama3.2-3b's 8 blocks: within
  5e-4 relative to the largest entry, as the reference's own test;
* microbatch counts 2, 4 and 8 against each other: within 1e-6 (the
  schedule moves no arithmetic), and each within 1e-6 of the reference's;
* pipeline gradients (every block leaf and the input) against the stages
  run in sequence in one process: within 1e-5 of each gradient's largest
  entry.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import lm as jax_lm
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduce_config as jax_reduce_config
from repro.models.schema import init_params as jax_init_params
from repro_torch.models import lm as tlm
from repro_torch.models.attention import chunked_attention
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.models.schema import layer_params, n_stacked
from torch_ranks import run_jax, run_ranks

RING_CASES = [((2, 4), True), ((2, 4), False), ((1, 8), True),
              ((1, 8), False)]

_STAGE = """
def llama_stage(cfg, lm):
    def stage_fn(blocks, x):
        B, S = x.shape[0], x.shape[1]
        pos = torch.arange(S).expand(B, S)
        for i in range(n_stacked(blocks)):
            x, _ = lm._block_apply(layer_params(blocks, i), x, cfg, pos)
        return x
    return stage_fn

def toy_stage(ws, x):
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x
"""

_JAX = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.models import lm as lm_mod
from repro.models.registry import get_config, reduce_config
from repro.parallel.pipeline import pipeline_apply
from repro.parallel.ring_attention import ring_attention
inp = dict(np.load(sys.argv[1]))
out = {}
q, k, v = (jnp.asarray(inp[n]) for n in ("q", "k", "v"))
for shape in ((2, 4), (1, 8)):
    mesh = jax.make_mesh(shape, ("data", "model"))
    for causal in (True, False):
        out[f"ring_{shape[0]}{shape[1]}_{int(causal)}"] = np.asarray(
            jax.jit(lambda q, k, v: ring_attention(
                q, k, v, mesh, causal=causal))(q, k, v))
    if shape == (1, 8):
        out["ring_adv"] = np.asarray(jax.jit(lambda q, k, v: ring_attention(
            q, k, v, mesh, causal=True))(*(jnp.asarray(inp["adv_" + n])
                                          for n in "qkv")))
mesh = jax.make_mesh((4, 2), ("pod", "data"))
cfg = reduce_config(get_config("llama3.2-3b")).replace(n_layers=8,
                                                       remat="none")
blocks = jax.tree_util.tree_unflatten(
    jax.tree_util.tree_structure(lm_mod.lm_schema(cfg)["blocks"],
        is_leaf=lambda x: hasattr(x, "logical")),
    [jnp.asarray(inp[k]) for k in sorted(
        (k for k in inp if k.startswith("blk/")),
        key=lambda k: int(k.split("/")[1]))])
def stage_fn(layer_params, x):
    S = x.shape[1]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (x.shape[0], S))
    def body(x, bp):
        x, _ = lm_mod._block_apply(bp, x, cfg, pos, False)
        return x, None
    return jax.lax.scan(body, x, layer_params)[0]
out["pipe"] = np.asarray(jax.jit(lambda p, x: pipeline_apply(
    p, x, mesh, stage_fn, microbatches=4))(blocks, jnp.asarray(inp["x"])))
def toy(ws, x):
    def body(x, wi):
        return jnp.tanh(x @ wi), None
    return jax.lax.scan(body, x, ws)[0]
for m in (2, 4, 8):
    out[f"toy_{m}"] = np.asarray(jax.jit(lambda w, x, m=m: pipeline_apply(
        w, x, mesh, toy, microbatches=m))(jnp.asarray(inp["w"]),
                                           jnp.asarray(inp["tx"])))
np.savez(sys.argv[2], **out)
"""

_RANKS = _STAGE + """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.models import lm
from repro_torch.models.attention import attention_apply
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.models.schema import layer_params, n_stacked
from repro_torch.parallel import ring_attention as ring_mod
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import (SEQ_PARALLEL_RULES,
                                           sharding_context)

T = lambda n: torch.from_numpy(inp[n])
for shape in ((2, 4), (1, 8)):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    cases = [(True, "qkv"), (False, "qkv")] + \\
        ([(True, "adv")] if shape == (1, 8) else [])
    for causal, src in cases:
        names = ("q", "k", "v") if src == "qkv" else \\
            ("adv_q", "adv_k", "adv_v")
        q, k, v = (T(n).requires_grad_() for n in names)
        o = ring_mod.ring_attention(q, k, v, mesh, causal=causal)
        (o ** 2).sum().backward()
        tag = f"ring_{shape[0]}{shape[1]}_{int(causal)}" if src == "qkv" \\
            else "ring_adv"
        out[tag] = o.detach()
        for n, t in zip("qkv", (q, k, v)):
            out[f"{tag}_d{n}"] = t.grad

    if shape == (2, 4):
        cfg = reduce_config(get_config("llama3.2-3b")).replace(
            opt_ring_attention=True)
        ap = {n: T("attn/" + n) for n in ("wq", "wk", "wv", "wo")}
        x = T("ax")
        pos = torch.arange(x.shape[1]).expand(x.shape[0], x.shape[1])
        calls = []
        inner = ring_mod.ring_attention
        ring_mod.ring_attention = lambda *a, **kw: (calls.append(1),
                                                    inner(*a, **kw))[1]
        with sharding_context(mesh, SEQ_PARALLEL_RULES):
            out["attn_ring"] = attention_apply(ap, x, cfg, positions=pos)
        out["attn_ring_calls"] = torch.tensor(len(calls))
        ring_mod.ring_attention = inner
        out["attn_plain"] = attention_apply(ap, x, cfg, positions=pos)

mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("pod", "data"))
cfg = reduce_config(get_config("llama3.2-3b")).replace(n_layers=8,
                                                       remat="none")
blocks = lm.lm_schema(cfg)["blocks"]
keys = sorted((k for k in inp if k.startswith("blk/")),
              key=lambda k: int(k.split("/")[1]))
leaves = [T(k).requires_grad_() for k in keys]
paths = []
def walk(t, p):
    if isinstance(t, dict):
        for k in sorted(t):
            walk(t[k], p + (k,))
    else:
        paths.append(p)
walk(blocks, ())
tree = {}
for p, l in zip(paths, leaves):
    node = tree
    for e in p[:-1]:
        node = node.setdefault(e, {})
    node[p[-1]] = l
x = T("x").requires_grad_()
y = pipeline_apply(tree, x, mesh, llama_stage(cfg, lm), microbatches=4)
(y ** 2).sum().backward()
out["pipe"] = y.detach()
out["pipe_dx"] = x.grad
for k, l in zip(keys, leaves):
    out["pipe_d" + k] = l.grad
for m in (2, 4, 8):
    out[f"toy_{m}"] = pipeline_apply(T("w"), T("tx"), mesh, toy_stage,
                                     microbatches=m)
"""


def _blocks_leaves(blocks):
    """Leaves of a blocks tree in sorted-key order (both packages')."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            out.append(np.asarray(t))

    walk(blocks)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_pipeline")
    rng = np.random.default_rng(0)
    inp = {}
    B, Hq, Hkv, S, D = 2, 4, 2, 64, 16
    inp["q"] = (rng.normal(size=(B, Hq, S, D)) / 4).astype(np.float32)
    inp["k"] = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    inp["v"] = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    r1 = np.random.default_rng(1)
    inp["adv_q"] = (r1.normal(size=(1, 2, 64, 16)) * 8).astype(np.float32)
    inp["adv_k"] = (r1.normal(size=(1, 2, 64, 16)) * 8).astype(np.float32)
    inp["adv_v"] = r1.normal(size=(1, 2, 64, 16)).astype(np.float32)
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b")).replace(
        n_layers=8, remat="none")
    params = jax_init_params(jax.random.PRNGKey(0), jax_lm.lm_schema(jcfg))
    for i, a in enumerate(_blocks_leaves(params["blocks"])):
        inp[f"blk/{i}"] = a
    r0 = np.random.default_rng(0)
    inp["x"] = (r0.normal(size=(8, 16, jcfg.d_model)) * 0.1
                ).astype(np.float32)
    inp["w"] = (r0.normal(size=(8, 16, 16)) * 0.1).astype(np.float32)
    inp["tx"] = r0.normal(size=(8, 4, 16)).astype(np.float32)
    attn = params["blocks"]["mixer"]
    for n in ("wq", "wk", "wv", "wo"):
        inp["attn/" + n] = np.asarray(attn[n][0])
    inp["ax"] = rng.normal(size=(2, 64, jcfg.d_model)).astype(np.float32)
    path = tmp / "inputs.npz"
    np.savez(path, **inp)
    ref = run_jax(_JAX.replace("sys.argv[1]", repr(str(path))).replace(
        "sys.argv[2]", repr(str(tmp / "ref.npz"))))
    ranks = run_ranks(_RANKS, 8, tmp / "ranks", path)
    ref.wait()
    return {"inp": inp, "ref": dict(np.load(tmp / "ref.npz")),
            "ranks": ranks.wait()}


def _tag(shape, causal):
    return f"ring_{shape[0]}{shape[1]}_{int(causal)}"


@pytest.mark.parametrize("shape,causal", RING_CASES)
def test_ring_forward_matches_the_reference(runs, shape, causal):
    want = runs["ref"][_tag(shape, causal)]
    for out in runs["ranks"]:
        got = out[_tag(shape, causal)].numpy()
        assert np.abs(got - want).max() < 2e-5


def test_ring_renorm_is_exact_at_adversarial_scores(runs):
    want = runs["ref"]["ring_adv"]
    for out in runs["ranks"]:
        assert np.abs(out["ring_adv"].numpy() - want).max() < 5e-5


def _chunked_grads(q, k, v, causal, chunk):
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = chunked_attention(q, k, v, causal=causal, intmax=True, chunk=chunk)
    (o ** 2).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("shape,causal", RING_CASES + [((1, 8), "adv")])
def test_ring_gradients_match_chunked(runs, shape, causal):
    inp = runs["inp"]
    if causal == "adv":
        tag, qkv, causal = "ring_adv", [inp["adv_" + n] for n in "qkv"], True
    else:
        tag, qkv = _tag(shape, causal), [inp[n] for n in "qkv"]
    want = _chunked_grads(*qkv, causal, 16)
    for out in runs["ranks"]:
        for n, w in zip("qkv", want):
            got = out[f"{tag}_d{n}"].numpy()
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), n


def test_attention_apply_takes_the_ring_under_sequence_parallel_rules(runs):
    for out in runs["ranks"]:
        assert int(out["attn_ring_calls"]) == 1
        plain = out["attn_plain"].numpy()
        assert np.abs(out["attn_ring"].numpy() - plain).max() <= \
            1e-6 * np.abs(plain).max()


def test_pipeline_forward_matches_the_reference(runs):
    want = runs["ref"]["pipe"]
    for out in runs["ranks"]:
        got = out["pipe"].numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 5e-4


def test_pipeline_microbatch_count_invariance(runs):
    ref = runs["ref"]
    for out in runs["ranks"]:
        for m in (2, 4, 8):
            np.testing.assert_allclose(out[f"toy_{m}"].numpy(),
                                       out["toy_2"].numpy(), atol=1e-6)
            np.testing.assert_allclose(out[f"toy_{m}"].numpy(),
                                       ref[f"toy_{m}"], atol=1e-6)


def test_pipeline_gradients_match_sequential_stages(runs):
    inp = runs["inp"]
    cfg = reduce_config(get_config("llama3.2-3b")).replace(n_layers=8,
                                                           remat="none")
    paths = []

    def walk(t, p):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], p + (k,))
        else:
            paths.append(p)

    walk(tlm.lm_schema(cfg)["blocks"], ())
    leaves = [torch.tensor(inp[f"blk/{i}"]).requires_grad_()
              for i in range(len(paths))]
    tree = {}
    for p, leaf in zip(paths, leaves):
        node = tree
        for e in p[:-1]:
            node = node.setdefault(e, {})
        node[p[-1]] = leaf
    x = torch.tensor(inp["x"]).requires_grad_()
    y = x
    pos = torch.arange(x.shape[1]).expand(x.shape[0], x.shape[1])
    for i in range(n_stacked(tree)):
        y, _ = tlm._block_apply(layer_params(tree, i), y, cfg, pos)
    (y ** 2).sum().backward()
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["pipe"].numpy(), y.detach().numpy(),
                                   atol=1e-6 * float(y.detach().abs().max()))
        dx = x.grad.numpy()
        assert np.abs(out["pipe_dx"].numpy() - dx).max() <= \
            1e-5 * np.abs(dx).max()
        for i, leaf in enumerate(leaves):
            g = leaf.grad.numpy()
            got = out[f"pipe_dblk/{i}"].numpy()
            assert np.abs(got - g).max() <= 1e-5 * np.abs(g).max(), paths[i]
