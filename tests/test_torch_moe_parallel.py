"""The port's expert-parallel MoE (``opt_moe_shard_map``) against the JAX
package, on gloo process groups on the CPU.

``moe_apply_shard_map`` on reduced moonshot-v1-16b-a3b at meshes (2, 4)
(8 ranks) and (1, 4) (4 ranks), at capacity factor 50 (no drops, the
reference's own test) and at the config's 1.25 (local drops), against the
reference's ``moe_apply_shard_map`` from one JAX process with 8 virtual
CPU devices; the weights from the reference's init. At (2, 4) and 1.25
the local capacity is 4 slots for a rank's 8 tokens and some rank drops.

Tolerances, and why:

* ``y`` and ``aux``: within 1e-4 of the largest |y| and relative for aux,
  as the reference's test holds its path against the global one;
* each rank's local routing (``sel``, ``keep``, ``slot`` of
  ``_local_dispatch``, and the dispatched buffer): EXACTLY the reference's
  ``_local_dispatch`` on the same tokens and router probabilities; also
  with exact ties and drops in one process;
* ``moe_apply`` under the ambient mesh takes the expert-parallel path
  exactly when the reference's conditions hold (both sides shown), and
  gives the same result bit for bit as the direct call;
* without drops the gradients of sum(y²) for x and every weight equal the
  global path's within 1e-5 of each gradient's largest entry (the same
  function; the expert products run over other slot counts), also with a
  batch of 3 rows that does not split over the data axis (x replicated
  there, so no rank's weight gradient may be summed over it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduce_config as jax_reduce_config
from repro.models.schema import init_params as jax_init_params
from repro.parallel import sharding as jax_sharding
from repro.parallel.compat import abstract_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.parallel.sharding import DEFAULT_RULES, sharding_context
from torch_ranks import run_jax, run_ranks

MESHES = [(2, 4), (1, 4)]
FACTORS = [50.0, 1.25]

_NEST = """
def nest(flat, prefix):
    out = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out
"""

_JAX = _NEST + """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models import moe as moe_mod
from repro.models.registry import get_config, reduce_config
from repro.parallel.sharding import DEFAULT_RULES, sharding_context
inp = dict(np.load(sys.argv[1]))
out = {}
params = jax.tree.map(jnp.asarray, nest(inp, "p/"))
x = jnp.asarray(inp["x"])
base = reduce_config(get_config("moonshot-v1-16b-a3b"))
for shape in ((2, 4), (1, 4)):
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    for cf in (50.0, 1.25):
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   capacity_factor=cf))
        with sharding_context(mesh, DEFAULT_RULES):
            y, aux = jax.jit(lambda p, xx: moe_mod.moe_apply_shard_map(
                p, xx, cfg, mesh))(params, x)
        tag = f"{shape[0]}{shape[1]}_{cf}"
        out["y_" + tag], out["aux_" + tag] = np.asarray(y), np.asarray(aux)
        if shape == (2, 4) and cf == 50.0:
            # 3 rows: the batch does not split over data, x is replicated
            y, aux = jax.jit(lambda p, xx: moe_mod.moe_apply_shard_map(
                p, xx, cfg, mesh))(params, x[:3])
            out["y_rep"], out["aux_rep"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[2], **out)
"""

_RANKS = _NEST + """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.models import moe
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.parallel.sharding import DEFAULT_RULES, sharding_context

shape = (2, 4) if world == 8 else (1, 4)
mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
params = tree_map(torch.from_numpy, nest(inp, "p/"))
x = torch.from_numpy(inp["x"])
base = reduce_config(get_config("moonshot-v1-16b-a3b"))
seen = []
inner = moe._local_dispatch
def spy(xf, probs, k, E, C, dt):
    r = inner(xf, probs, k, E, C, dt)
    seen.append((xf, probs, C, r))
    return r
moe._local_dispatch = spy
for cf in (50.0, 1.25):
    cfg = base.replace(moe=dataclasses.replace(base.moe,
                                               capacity_factor=cf),
                       opt_moe_shard_map=True)
    tag = f"{shape[0]}{shape[1]}_{cf}"
    seen.clear()
    y, aux = moe.moe_apply_shard_map(params, x, cfg, mesh)
    out["y_" + tag], out["aux_" + tag] = y, aux
    xf, probs, C, (buf, slot, keep, weights, sel) = seen[0]
    out.update({f"{n}_{tag}": t for n, t in (
        ("xf", xf), ("probs", probs), ("buf", buf), ("slot", slot),
        ("keep", keep), ("sel", sel), ("weights", weights))})
    out["C_" + tag] = torch.tensor(C)
    with sharding_context(mesh, DEFAULT_RULES):
        y2, aux2 = moe.moe_apply(params, x, cfg)
    out["same_" + tag] = torch.tensor(bool(torch.equal(y, y2)
                                           and torch.equal(aux, aux2)))
    if cf == 50.0:
        for name, rows in (("", 4), ("rep_", 3)):
            if rows == 3 and world != 8:
                continue
            leaves = tree_map(lambda t: t.clone().requires_grad_(), params)
            xg = x[:rows].clone().requires_grad_()
            y, aux = moe.moe_apply_shard_map(leaves, xg, cfg, mesh)
            (y ** 2).sum().backward()
            out[name + "dx"] = xg.grad
            for i, t in enumerate(tree_leaves(leaves)):
                out[f"{name}d{i}"] = t.grad
            if rows == 3:
                out["y_rep"], out["aux_rep"] = y.detach(), aux.detach()
"""


def _cfg(cf):
    base = reduce_config(get_config("moonshot-v1-16b-a3b"))
    return base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_parallel")
    jcfg = jax_reduce_config(jax_get_config("moonshot-v1-16b-a3b"))
    params = jax_init_params(jax.random.PRNGKey(0),
                             jax_moe.moe_schema(jcfg))
    inp = {f"p/{k}": v for k, v in _flat(params).items()}
    inp["x"] = np.random.default_rng(0).normal(
        size=(4, 16, jcfg.d_model)).astype(np.float32)
    path = tmp / "inputs.npz"
    np.savez(path, **inp)
    ref = run_jax(_JAX.replace("sys.argv[1]", repr(str(path))).replace(
        "sys.argv[2]", repr(str(tmp / "ref.npz"))))
    eight = run_ranks(_RANKS, 8, tmp / "eight", path)
    four = run_ranks(_RANKS, 4, tmp / "four", path)
    ref.wait()
    return {"inp": inp, "ref": dict(np.load(tmp / "ref.npz")),
            (2, 4): eight.wait(), (1, 4): four.wait()}


def _tag(shape, cf):
    return f"{shape[0]}{shape[1]}_{cf}"


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("cf", FACTORS)
def test_moe_shard_map_matches_the_reference(runs, shape, cf):
    tag = _tag(shape, cf)
    y_ref, aux_ref = runs["ref"]["y_" + tag], float(runs["ref"]["aux_" + tag])
    for out in runs[shape]:
        y = out["y_" + tag].numpy()
        assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-4
        assert abs(float(out["aux_" + tag]) - aux_ref) <= \
            1e-4 * abs(aux_ref)
        assert bool(out["same_" + tag])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("cf", FACTORS)
def test_local_dispatch_on_each_rank_is_the_references(runs, shape, cf):
    tag = _tag(shape, cf)
    m = _cfg(cf).moe
    drops = 0
    for out in runs[shape]:
        C = int(out["C_" + tag])
        buf, slot, keep, weights, sel = jax_moe._local_dispatch(
            jnp.asarray(out["xf_" + tag].numpy()),
            jnp.asarray(out["probs_" + tag].numpy()), m.top_k,
            m.n_experts, C, jnp.float32)
        np.testing.assert_array_equal(out["sel_" + tag].numpy(),
                                      np.asarray(sel))
        np.testing.assert_array_equal(out["keep_" + tag].numpy(),
                                      np.asarray(keep))
        np.testing.assert_array_equal(out["slot_" + tag].numpy(),
                                      np.asarray(slot))
        np.testing.assert_array_equal(out["buf_" + tag].numpy(),
                                      np.asarray(buf))
        np.testing.assert_allclose(out["weights_" + tag].numpy(),
                                   np.asarray(weights), rtol=1e-6)
        drops += int((~out["keep_" + tag]).sum())
    # at (2, 4) the config's 1.25 gives C = 4 for 8 tokens a rank, and
    # some rank drops; capacity 50 never does
    if shape == (2, 4):
        assert (drops > 0) == (cf == 1.25)
    else:
        assert drops == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_local_dispatch_ties_and_drops_exact(seed):
    """Router probabilities with exact ties (rounded to 1/8) over 8 experts,
    top-2, capacities that drop and that do not."""
    rng = np.random.default_rng(seed)
    T, E, k, d = 24, 8, 2, 4
    probs = (np.round(rng.uniform(size=(T, E)) * 8) / 8).astype(np.float32)
    xf = rng.normal(size=(T, d)).astype(np.float32)
    for C in (2, 4, 8):
        want = jax_moe._local_dispatch(jnp.asarray(xf), jnp.asarray(probs),
                                       k, E, C, jnp.float32)
        got = tmoe._local_dispatch(torch.from_numpy(xf),
                                   torch.from_numpy(probs), k, E, C,
                                   torch.float32)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_moe_shard_map_with_a_batch_that_does_not_split(runs):
    """3 rows over a data axis of 2: x replicated over data, as the
    reference's ``x_spec`` falls back to."""
    y_ref, aux_ref = runs["ref"]["y_rep"], float(runs["ref"]["aux_rep"])
    for out in runs[(2, 4)]:
        y = out["y_rep"].numpy()
        assert y.shape == (3, 16, y_ref.shape[-1])
        assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-4
        assert abs(float(out["aux_rep"]) - aux_ref) <= 1e-4 * abs(aux_ref)


@pytest.mark.parametrize("rows", [4, 3])
def test_ep_gradients_match_the_global_path(runs, rows):
    inp = runs["inp"]
    cfg = _cfg(50.0)

    def nest(prefix):
        out = {}
        for key, a in inp.items():
            if key.startswith(prefix):
                *path, leaf = key[len(prefix):].split("/")
                node = out
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = torch.tensor(a).requires_grad_()
        return out

    params = nest("p/")
    x = torch.tensor(inp["x"][:rows]).requires_grad_()
    y, _ = tmoe._moe_apply_global(params, x, cfg)
    (y ** 2).sum().backward()
    want = [x.grad] + [t.grad for t in tree_leaves(params)]
    name = "" if rows == 4 else "rep_"
    outs = runs[(2, 4)] + (runs[(1, 4)] if rows == 4 else [])
    for out in outs:
        got = [out[name + "dx"]] + [out[f"{name}d{i}"]
                                     for i in range(len(want) - 1)]
        for g, w in zip(got, want):
            assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.parametrize("sizes,S,E,taken", [
    ({"data": 2, "model": 4}, 16, 8, True),
    ({"data": 2, "model": 1}, 16, 8, False),     # no model axis to split
    ({"data": 2, "model": 4}, 18, 8, False),     # seq does not divide
    ({"data": 1, "model": 16}, 16, 8, False),    # experts do not divide
    ({"data": 8}, 16, 8, False),                 # no model axis at all
])
@pytest.mark.parametrize("flag", [True, False])
def test_moe_apply_dispatches_under_the_references_conditions(
        monkeypatch, sizes, S, E, taken, flag):
    """Both packages' ``moe_apply`` under a mesh of these axis sizes (the
    reference's an abstract mesh, the port's a plain mapping): each takes
    its expert-parallel path exactly in the same cases."""
    cfg = _cfg(1.25)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=E),
                      opt_moe_shard_map=flag)
    jcfg = jax_reduce_config(jax_get_config("moonshot-v1-16b-a3b"))
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, n_experts=E),
                        opt_moe_shard_map=flag)
    calls = {"port": 0, "ref": 0}

    def fake(name):
        def f(params, x, cfg, mesh):
            calls[name] += 1
            return x, 0.0
        return f

    monkeypatch.setattr(tmoe, "moe_apply_shard_map", fake("port"))
    monkeypatch.setattr(jax_moe, "moe_apply_shard_map", fake("ref"))
    monkeypatch.setattr(tmoe, "_moe_apply_global", lambda p, x, c: (x, 0.0))
    monkeypatch.setattr(jax_moe, "_moe_apply_global",
                        lambda p, x, c: (x, 0.0))
    x = np.zeros((2, S, 8), np.float32)
    with sharding_context(sizes, DEFAULT_RULES):
        tmoe.moe_apply({}, torch.from_numpy(x), cfg)
    amesh = abstract_mesh(tuple(sizes.values()), tuple(sizes))
    with jax_sharding.sharding_context(amesh, jax_sharding.DEFAULT_RULES):
        jax_moe.moe_apply({}, jnp.asarray(x), jcfg)
    assert calls["port"] == calls["ref"] == int(taken and flag)
