"""The port's sharding rules engine, logical specs, meshes and tree
utilities against the JAX package.

Everything here is EXACT:

* ``model_fns(cfg).specs`` equals the reference's tree of logical-axis
  tuples for every config of the registry (decoder-only, encdec, MLA,
  hybrid, RWKV, MoE), and ``cache_logical`` the third element of the
  reference's ``cache_spec`` entries, with and without
  ``opt_cache_seq_shard``;
* ``logical_to_physical`` gives the reference's ``PartitionSpec`` (as a
  tuple) for every leaf of those trees, under all four rule tables, on
  abstract ``(16, 16)`` and ``(2, 16, 16)`` meshes, and in the six cases of
  ``tests/test_parallel.py::TestShardingRules``;
* ``_ring_applicable`` decides as the reference does over a grid of
  configs, meshes and rules, and ``attention_apply`` takes the ring
  exactly then;
* the tree utilities count, cast and check as the reference's.

The meshes: ``make_host_mesh`` on 2 gloo ranks (a ``FileStore`` under
the test's temporary directory) and on one CPU rank; the production
meshes refuse a process group smaller than 256 / 512 ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attention
from repro.models import lm as jax_lm
from repro.models import whisper as jax_whisper
from repro.models.registry import ARCH_IDS
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.parallel import sharding as jsh
from repro.parallel.compat import abstract_mesh
from repro.utils import tree as jax_tree
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_shape)
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.parallel import sharding as tsh
from repro_torch.utils import tree as ttree
from torch_ranks import run_ranks

RULES = ("DEFAULT_RULES", "LONG_CONTEXT_RULES", "SERVE_RULES",
         "SEQ_PARALLEL_RULES")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _pairs(schema, specs):
    """(shape, logical) of every ParamSpec leaf, in sorted-key order."""
    out = []

    def walk(s, t):
        if isinstance(s, dict):
            assert set(s) == set(t)
            for k in sorted(s):
                walk(s[k], t[k])
        else:
            out.append((s.shape, t))

    walk(schema, specs)
    return out


def _jax_specs_leaves(specs):
    return jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_references(arch):
    jf, tf = jax_model_fns(jax_get_config(arch)), model_fns(get_config(arch))
    got = _pairs(tf.schema, tf.specs)
    assert [spec for _, spec in got] == _jax_specs_leaves(jf.specs)
    assert [tuple(s.shape) for s in jax.tree_util.tree_leaves(
        jf.schema, is_leaf=lambda x: hasattr(x, "logical"))] == \
        [tuple(sh) for sh, _ in got]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("seq_shard", [False, True])
def test_cache_logical_equals_the_references(arch, seq_shard):
    cfg = get_config(arch).replace(opt_cache_seq_shard=seq_shard)
    jcfg = jax_get_config(arch).replace(opt_cache_seq_shard=seq_shard)
    if cfg.family == "encdec":
        want = {k: v[2] for k, v in jax_whisper.whisper_cache_spec(
            jcfg, 2, 16, 8).items()}
        assert model_fns(cfg).cache_logical() == want
        return
    got = model_fns(cfg).cache_logical()
    want = {k: v[2] for k, v in jax_lm.cache_spec(jcfg, 2, 16).items()}
    assert got == want
    if seq_shard and cfg.family not in ("rwkv", "hybrid"):
        assert any("kv_seq" in ax for ax in got.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_logical_to_physical_equals_the_references(mesh, rules):
    shape, names = MESHES[mesh]
    amesh = abstract_mesh(shape, names)
    sizes = dict(zip(names, shape))
    n = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        fns = model_fns(cfg)
        leaves = _pairs(fns.schema, fns.specs)
        if cfg.family != "encdec":
            for seq_shard in (False, True):
                c = cfg.replace(opt_cache_seq_shard=seq_shard)
                spec = tlm.cache_spec(c, 128, 32768)
                axes = tlm.cache_logical(c)
                leaves += [(spec[k][0], axes[k]) for k in spec]
        for sh, logical in leaves:
            want = jsh.logical_to_physical(logical, sh,
                                           getattr(jsh, rules), amesh)
            got = tsh.logical_to_physical(logical, sh, getattr(tsh, rules),
                                          sizes)
            assert got == tuple(want), (arch, logical, sh)
            n += 1
    assert n > 250


@pytest.mark.parametrize("case", [
    # (logical, shape, rules, mesh, want) of TestShardingRules
    (("embed", "mlp"), (4096, 12800), "DEFAULT_RULES", "pod",
     ("data", "model")),
    (("kv_heads",), (8,), "DEFAULT_RULES", "pod", (None,)),
    (("heads", "mlp"), (32, 128), "DEFAULT_RULES", "pod", ("model", None)),
    (("batch", None), (256, 4096), "DEFAULT_RULES", "multipod",
     (("pod", "data"), None)),
    (("batch", "seq", None), (1, 524288, 64), "LONG_CONTEXT_RULES",
     "multipod", (None, ("pod", "data"), None)),
    (("batch",), (16,), "DEFAULT_RULES", "multipod", ("pod",)),
])
def test_the_references_sharding_rule_cases(case):
    logical, shape, rules, mesh, want = case
    sh, names = MESHES[mesh]
    got = tsh.logical_to_physical(logical, shape, getattr(tsh, rules),
                                  dict(zip(names, sh)))
    ref = jsh.logical_to_physical(logical, shape, getattr(jsh, rules),
                                  abstract_mesh(sh, names))
    assert got == want
    assert tuple(ref) in (want, tuple((w,) if isinstance(w, str) else w
                                      for w in want))


def test_rule_tables_equal_the_references():
    for name in RULES:
        assert getattr(tsh, name).rules == getattr(jsh, name).rules


def test_context_and_param_sharding():
    sizes = {"data": 16, "model": 16}
    assert tsh.current_mesh() is None and tsh.param_sharding(
        ("embed", "mlp"), (4096, 12800)) is None
    x = torch.ones(3)
    with tsh.sharding_context(sizes, tsh.SERVE_RULES):
        assert tsh.current_mesh() is sizes
        assert tsh.current_rules() is tsh.SERVE_RULES
        got = tsh.param_sharding(("embed", "mlp"), (4096, 12800))
        assert got == tsh.NamedSharding(sizes, (None, "model"))
        assert got.spec == (None, "model") and got.mesh is sizes
        assert tsh.shard_act(x, ("batch",)) is x
    assert tsh.current_mesh() is None
    assert tsh.current_rules() is tsh.DEFAULT_RULES


RING_GRID = [
    # (opt_ring_attention, window, cross, sizes, rules, Sq, Sk)
    (True, 0, False, {"data": 1, "model": 4}, "SEQ_PARALLEL_RULES", 64, 64),
    (False, 0, False, {"data": 1, "model": 4}, "SEQ_PARALLEL_RULES", 64, 64),
    (True, 16, False, {"data": 1, "model": 4}, "SEQ_PARALLEL_RULES", 64, 64),
    (True, 0, True, {"data": 1, "model": 4}, "SEQ_PARALLEL_RULES", 64, 64),
    (True, 0, False, {"data": 4, "model": 1}, "SEQ_PARALLEL_RULES", 64, 64),
    (True, 0, False, {"data": 4}, "SEQ_PARALLEL_RULES", 64, 64),
    (True, 0, False, {"data": 1, "model": 4}, "DEFAULT_RULES", 64, 64),
    (True, 0, False, {"data": 1, "model": 4}, "SEQ_PARALLEL_RULES", 66, 66),
    (True, 0, False, {"data": 1, "model": 4}, "SEQ_PARALLEL_RULES", 64, 32),
    (True, 0, False, None, "SEQ_PARALLEL_RULES", 64, 64),
]


@pytest.mark.parametrize("case", RING_GRID)
def test_ring_applicable_decides_as_the_reference(monkeypatch, case):
    flag, window, cross, sizes, rules, Sq, Sk = case
    cfg = reduce_config(get_config("llama3.2-3b")).replace(
        opt_ring_attention=flag)
    jcfg = jax_get_config("llama3.2-3b").replace(opt_ring_attention=flag)
    q, k = np.zeros((1, 4, Sq, 16), np.float32), \
        np.zeros((1, 2, Sk, 16), np.float32)
    x_kv = np.zeros((1, Sk, 8), np.float32) if cross else None
    amesh = None if sizes is None else abstract_mesh(
        tuple(sizes.values()), tuple(sizes))
    with jsh.sharding_context(amesh, getattr(jsh, rules)):
        want = jax_attention._ring_applicable(
            jcfg, jnp.asarray(q), jnp.asarray(k), window,
            None if x_kv is None else jnp.asarray(x_kv))
        # self attention's keys are its queries' length
        k_self = k if cross else np.zeros((1, 2, Sq, 16), np.float32)
        want_apply = jax_attention._ring_applicable(
            jcfg, jnp.asarray(q), jnp.asarray(k_self), window,
            None if x_kv is None else jnp.asarray(x_kv))
    with tsh.sharding_context(sizes, getattr(tsh, rules)):
        got = tattn._ring_applicable(
            cfg, torch.from_numpy(q), torch.from_numpy(k), window,
            None if x_kv is None else torch.from_numpy(x_kv))
    assert got == want
    assert want == (case == RING_GRID[0])

    # attention_apply's chunked branch takes the ring exactly then
    from repro_torch.parallel import ring_attention as ring_mod
    calls = []
    monkeypatch.setattr(ring_mod, "ring_attention",
                        lambda q, k, v, mesh, **kw: (calls.append(mesh),
                                                     q)[1])
    d = cfg.d_model
    rng = np.random.default_rng(0)
    ap = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for n, s in (("wq", (d, 4, 16)), ("wk", (d, 2, 16)),
                       ("wv", (d, 2, 16)), ("wo", (4, 16, d)))}
    cfg = cfg.replace(n_heads=4, n_kv_heads=2, head_dim=16)
    xs = torch.from_numpy(rng.normal(size=(1, Sq, d)).astype(np.float32))
    kv = None if not cross else torch.from_numpy(
        rng.normal(size=(1, Sk, d)).astype(np.float32))
    with tsh.sharding_context(sizes, getattr(tsh, rules)):
        tattn.attention_apply(ap, xs, cfg, positions=torch.zeros(
            1, Sq, dtype=torch.long), window=window, x_kv=kv)
    assert len(calls) == int(want_apply)


def test_tree_utilities_equal_the_references():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.integers(0, 5, (7,)).astype(np.int32),
                  "d": rng.normal(size=(2, 2, 5)).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = jax.tree.map(torch.from_numpy, tree)
    assert ttree.tree_num_params(tt) == jax_tree.tree_num_params(jt) == 39
    assert ttree.tree_size_bytes(tt) == jax_tree.tree_size_bytes(jt)
    cast = ttree.tree_cast(tt, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and \
        cast["b"]["c"].dtype == torch.int32
    assert ttree.tree_size_bytes(cast) == jax_tree.tree_size_bytes(
        jax_tree.tree_cast(jt, jnp.bfloat16))
    assert all(float(l.abs().sum()) == 0
               for l in tree_leaves(ttree.tree_zeros_like(tt)))
    assert bool(ttree.tree_allfinite(tt)) is True
    tt["b"]["d"][0, 0, 0] = float("nan")
    jt["b"]["d"] = jt["b"]["d"].at[0, 0, 0].set(jnp.nan)
    assert bool(ttree.tree_allfinite(tt)) is \
        bool(jax_tree.tree_allfinite(jt)) is False
    assert bool(ttree.tree_allfinite({"i": torch.arange(3)})) is True


_RANKS = """
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_shape)
mesh = make_host_mesh(model=2, device="cpu")
out["shape"] = mesh_shape(mesh)
out["model_rank"] = mesh.get_local_rank("model")
try:
    make_production_mesh(device="cpu")
except ValueError as e:
    out["refused"] = str(e)
"""


def test_host_mesh_on_two_ranks(tmp_path):
    outs = run_ranks(_RANKS, 2, tmp_path).wait()
    assert [o["shape"] for o in outs] == [{"data": 1, "model": 2}] * 2
    assert [o["model_rank"] for o in outs] == [0, 1]
    assert all("256 ranks" in o["refused"] and "has 2" in o["refused"]
               for o in outs)


def test_host_and_production_meshes_in_one_process():
    mesh = make_host_mesh(device="cpu")
    n = torch.distributed.get_world_size()
    assert mesh_shape(mesh) == {"data": n, "model": 1}
    assert mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    assert mesh_shape({"data": 2, "model": 4}) == {"data": 2, "model": 4}
