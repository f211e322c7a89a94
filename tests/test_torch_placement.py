"""The port's implicit placement (``parallel/sharding.py`` on DTensor)
against the JAX package, on 8 gloo ranks on the CPU.

The ranks form a (4, 2) ``("data", "model")`` mesh, started once for the
file beside one JAX process with 8 virtual devices on the ``Auto``-axis
mesh ``Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))``;
rank r and device r sit at mesh position (r // 2, r % 2). The weights are
the reference's ``model_fns(cfg).init(PRNGKey(0))`` through ``bridge.py``.

* every parameter leaf of reduced qwen3-4b and reduced deepseek-v2-236b,
  placed under ``DEFAULT_RULES`` and ``SERVE_RULES``: each rank's
  ``to_local()`` EXACTLY the slice the reference's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives device r;
* ``shard_act`` on a DTensor takes the placements of the reference's spec
  and keeps its values EXACTLY; on a plain tensor it returns the same
  object, with and without a mesh;
* the sharded training step of reduced qwen3-4b (``vocab_pad_to=16``,
  ``TrainConfig(learning_rate=1e-3)``) on two batches (the reference
  test's all-ones (8, 32) batch and one from ``default_rng(0)``): loss and
  grad norm within 1e-5 relative of the port's one-rank plain step, the
  reference's one-device step and the reference's step on the Auto mesh;
  every updated leaf's ``full_tensor()`` within 2e-4 relative in L2 norm
  of the one-rank step's (``tests/test_torch_train.py``'s bound at lr
  1e-3: AdamW divides each element by its own moment, so float32 sum
  order reaches elements whose gradient is near zero);
* a placed step of reduced moonshot-v1-16b-a3b (its router through
  ``softermax_op`` on DTensors) against the one-rank step, the same;
* placed steps of reduced hymba-1.5b (the SSM scan on local shards),
  rwkv6-7b (the mix and the WKV scan), deepseek-v2-236b in its expanded
  and absorbed MLA forms and qwen3-4b under ``attention_impl="naive"``
  (the full score matrix), on the ``default_rng(0)`` batch: loss
  and grad norm within 1e-5 relative of the port's one-rank step and the
  reference's one-device step, every updated leaf within 2e-4 in L2 of
  the one-rank step's (a gradient that should be a partial sum over
  shards but is taken as replicated shows here, not on one rank);
* ``flash_attention_op`` and its backward on heads-sharded DTensors EQUAL
  the op on the whole tensors; DTensors sharded along the sequence are
  redistributed (each shard alone would give other values) and equal
  too; ``softermax_op`` and ``softermax_quant_op`` on row-sharded and on
  row-cut DTensors the same;
* a checkpoint saved on one rank restores on 8 through
  ``restore(shardings=)`` with the exact shards, and one saved on 8 ranks
  restores on one with the exact values;
* the launchers' production meshes name the 256 / 512 ranks they need;
  the kernels' pointer and operand checks refuse a DTensor by name.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.parallel import sharding as jsh
from repro.parallel.compat import abstract_mesh
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as tsh
from repro_torch.train import make_train_step
from torch_ranks import run_jax, run_ranks

RTOL = 1e-5          # loss and grad norm
LEAF_RTOL = 2e-4     # updated leaves, relative L2 (test_torch_train.py)
ARCHS = {"qwen3-4b": 16, "deepseek-v2-236b": None}   # vocab_pad_to
MOE = "moonshot-v1-16b-a3b"
FAMILIES = {"hymba": ("hymba-1.5b", {}), "rwkv6": ("rwkv6-7b", {}),
            "deepseek-expanded": ("deepseek-v2-236b", {}),
            "deepseek-absorbed": ("deepseek-v2-236b",
                                  {"opt_mla_absorbed": True}),
            "qwen3-naive": ("qwen3-4b", {"vocab_pad_to": 16,
                                         "attention_impl": "naive"})}
RULES = ("DEFAULT_RULES", "SERVE_RULES")
BATCHES = ("ones", "rng")
SIZES = {"data": 4, "model": 2}


def _cfg(get, reduce, arch):
    cfg = reduce(get(arch))
    pad = ARCHS.get(arch)
    return cfg if pad is None else cfg.replace(vocab_pad_to=pad)


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _nest(flat):
    out = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def _batches(vocab):
    rng = np.random.default_rng(0)
    ones = np.ones((8, 32), np.int32)
    draw = lambda: rng.integers(0, vocab, (8, 32)).astype(np.int32)
    return {"ones": {"tokens": ones, "labels": ones},
            "rng": {"tokens": draw(), "labels": draw()}}


_JAX = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs.base import TrainConfig
from repro.models.registry import get_config, model_fns, reduce_config
from repro.optim import adamw
from repro.parallel import sharding as jsh
from repro.train import make_train_step
inp = dict(np.load(IN))
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
is_spec = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)
out = {}
for arch, pad in ARCHS.items():
    cfg = reduce_config(get_config(arch))
    if pad:
        cfg = cfg.replace(vocab_pad_to=pad)
    fns = model_fns(cfg)
    shapes = jax.eval_shape(fns.init, jax.random.PRNGKey(0))
    specs = jax.tree_util.tree_flatten_with_path(fns.specs,
                                                 is_leaf=is_spec)[0]
    for rules in RULES:
        for path, logical in specs:
            key = "/".join(k.key for k in path)
            shape = shapes
            for k in path:
                shape = shape[k.key]
            shape = shape.shape
            spec = jsh.logical_to_physical(logical, shape,
                                           getattr(jsh, rules), mesh)
            m = NamedSharding(mesh, spec).devices_indices_map(shape)
            out[f"{arch}|{rules}|{key}"] = [
                [[s.start or 0, n if s.stop is None else s.stop]
                 for s, n in zip(m[dev], shape)] for dev in jax.devices()]
cfg = reduce_config(get_config("qwen3-4b")).replace(vocab_pad_to=16)
fns = model_fns(cfg)
params = fns.init(jax.random.PRNGKey(0))
opt = adamw.init_state(params)
step = jax.jit(make_train_step(fns.loss, TrainConfig(learning_rate=1e-3)))
batches = {b: {k: jnp.asarray(inp[f"{b}/{k}"]) for k in ("tokens", "labels")}
           for b in ("ones", "rng")}
for b, batch in batches.items():
    out["ref1|" + b] = [float(step(params, opt, batch)[2][k])
                        for k in ("loss", "grad_norm")]
with jsh.sharding_context(mesh, jsh.DEFAULT_RULES):
    sh = jax.tree_util.tree_map(
        lambda spec, a: NamedSharding(mesh, jsh.logical_to_physical(
            spec, a.shape, jsh.DEFAULT_RULES, mesh)),
        fns.specs, params, is_leaf=is_spec)
    placed = jax.device_put(params, sh)
    mstep = jax.jit(make_train_step(fns.loss,
                                    TrainConfig(learning_rate=1e-3)))
    for b, batch in batches.items():
        out["refmesh|" + b] = [float(mstep(placed, opt, batch)[2][k])
                               for k in ("loss", "grad_norm")]
with open(OUT, "w") as f:
    json.dump(out, f)
"""

# the families' one-device steps, in a process of their own beside _JAX
_JAX_FAMILIES = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import TrainConfig
from repro.models.registry import get_config, model_fns, reduce_config
from repro.optim import adamw
from repro.train import make_train_step
inp = dict(np.load(IN))
batch = {k: jnp.asarray(inp[f"rng/{k}"]) for k in ("tokens", "labels")}
out = {}
for case, (arch, kw) in FAMILIES.items():
    cfg = reduce_config(get_config(arch)).replace(**kw)
    fns = model_fns(cfg)
    params = fns.init(jax.random.PRNGKey(0))
    step = jax.jit(make_train_step(fns.loss, TrainConfig(learning_rate=1e-3)))
    m = step(params, adamw.init_state(params), batch)[2]
    out["fam|" + case] = [float(m[k]) for k in ("loss", "grad_norm")]
with open(OUT, "w") as f:
    json.dump(out, f)
"""

_RANKS = """
import json, os
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.flash_attention import flash_attention_op
from repro_torch.kernels.softermax import softermax_op
from repro_torch.kernels.softermax_quant import softermax_quant_op
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.train import make_train_step

mesh = make_host_mesh(model=2, device="cpu")

def nest(prefix):
    out = {}
    for key, a in inp.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out

def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k],
                                                       prefix + k + "/")]
    return [(prefix[:-1], tree)]

def config(arch):
    cfg = reduce_config(get_config(arch))
    pad = ARCHS.get(arch)
    return cfg if pad is None else cfg.replace(vocab_pad_to=pad)

# (1) parameter placement
for arch in ARCHS:
    cfg = config(arch)
    for rules in RULES:
        with sh.sharding_context(mesh, getattr(sh, rules)):
            placed = sh.place(params_from_numpy(nest(arch + "/"), cfg),
                              model_fns(cfg).specs)
        for key, leaf in paths(placed):
            out[f"{arch}|{rules}|{key}"] = leaf.to_local().clone()

# (2) shard_act
with sh.sharding_context(mesh, sh.DEFAULT_RULES):
    for name, shape, logical in (
            ("act", (8, 32, 64), ("batch", "seq", "act_embed")),
            ("heads", (8, 4, 32, 16), ("batch", "act_heads", "seq",
                                       "head_dim")),
            ("logits", (8, 32, 512), ("batch", "seq", "vocab"))):
        full = torch.arange(float(np.prod(shape))).reshape(shape)
        x = distribute_tensor(full, mesh, [Replicate(), Replicate()])
        y = sh.shard_act(x, logical)
        out["act|" + name] = (repr(tuple(y.placements)),
                              bool(torch.equal(y.full_tensor(), full)))
    plain = torch.ones(8, 32, 64)
    out["act|plain"] = sh.shard_act(plain, ("batch", "seq", "act_embed")) \\
        is plain

# (3) the sharded training step; (5) its checkpoint, saved on 8 ranks
cfg = config("qwen3-4b")
fns = model_fns(cfg)
tc = TrainConfig(learning_rate=1e-3)
for b in ("ones", "rng"):
    batch = {k: torch.from_numpy(inp[f"{b}/{k}"]) for k in ("tokens",
                                                             "labels")}
    with sh.sharding_context(mesh, sh.DEFAULT_RULES):
        params = sh.place(params_from_numpy(nest("qwen3-4b/"), cfg),
                          fns.specs)
        params, _, m = make_train_step(fns.loss, tc)(
            params, adamw.init_state(params), batch)
        out["step|" + b] = [float(m["loss"]), float(m["grad_norm"])]
        full = {k: l.full_tensor() for k, l in paths(params)}
        if rank == 0:
            out["leaves|" + b] = full
    if b == "rng":
        CheckpointManager(os.path.join(os.environ["OUT"], "ckpt8"),
                          async_save=False).save(1, {"params": params})

# a placed MoE step (the router's Softermax on DTensors)
moe = reduce_config(get_config(MOE))
with sh.sharding_context(mesh, sh.DEFAULT_RULES):
    params = sh.place(params_from_numpy(nest("moe/"), moe),
                      model_fns(moe).specs)
    batch = {k: torch.from_numpy(inp[f"rng/{k}"]) for k in ("tokens",
                                                            "labels")}
    params, _, m = make_train_step(model_fns(moe).loss, tc)(
        params, adamw.init_state(params), batch)
    out["moe|step"] = [float(m["loss"]), float(m["grad_norm"])]
    full = {k: l.full_tensor() for k, l in paths(params)}
    if rank == 0:
        out["moe|leaves"] = full

# placed steps of the scan and MLA families
for case, (arch, kw) in FAMILIES.items():
    fcfg = reduce_config(get_config(arch)).replace(**kw)
    with sh.sharding_context(mesh, sh.DEFAULT_RULES):
        params = sh.place(params_from_numpy(nest(arch + "/"), fcfg),
                          model_fns(fcfg).specs)
        params, _, m = make_train_step(model_fns(fcfg).loss, tc)(
            params, adamw.init_state(params), batch)
        out["fam|" + case] = [float(m["loss"]), float(m["grad_norm"])]
        full = {k: l.full_tensor() for k, l in paths(params)}
        if rank == 0:
            out["fam|leaves|" + case] = full

# (4) the kernels' wrappers on DTensors
g = torch.Generator().manual_seed(1)
q = torch.randn(4, 4, 32, 16, generator=g) * 0.25
k, v = (torch.randn(4, 2, 32, 16, generator=g) for _ in range(2))
do = torch.randn(4, 4, 32, 16, generator=g)
leaves = [t.clone().requires_grad_() for t in (q, k, v)]
o = flash_attention_op(*leaves)
o.backward(do)
want = [o.detach()] + [t.grad for t in leaves]
for name, pl in (("heads", [Shard(0), Shard(1)]),
                 ("seq", [Replicate(), Shard(2)])):
    dts = [distribute_tensor(t, mesh, pl).requires_grad_()
           for t in (q, k, v)]
    od = flash_attention_op(*dts)
    od.backward(distribute_tensor(do, mesh, od.placements))
    got = [od.full_tensor()] + [t.grad.full_tensor() for t in dts]
    out["flash|" + name] = (repr(tuple(od.placements)),
                            [float((a - b).abs().max())
                             for a, b in zip(got, want)],
                            [repr(tuple(t.grad.placements)) for t in dts])
# the causal sequence cut in two, each shard alone: not the answer
shards = [t.chunk(2, dim=2)[1] for t in (q, k, v)]
out["flash|alone"] = float((flash_attention_op(*shards)
                            - want[0].chunk(2, dim=2)[1]).abs().max())
x = torch.randn(8, 64, generator=g) * 4
for name, pl in (("rows", [Shard(0), Replicate()]),
                 ("cut", [Replicate(), Shard(1)])):
    for op in (softermax_op, softermax_quant_op):
        y = op(distribute_tensor(x, mesh, pl))
        out[f"{op.__name__}|{name}"] = (
            repr(tuple(y.placements)),
            float((y.full_tensor() - op(x)).abs().max()))

# (5) a one-rank checkpoint restored on 8 ranks
with sh.sharding_context(mesh, sh.DEFAULT_RULES):
    template = params_from_numpy(nest("qwen3-4b/"), cfg)
    shardings = tree_map(lambda a, lg: sh.param_sharding(lg, a.shape),
                         template, fns.specs)
    got = CheckpointManager(os.path.join(os.environ["OUT"], "ckpt1"),
                            async_save=False).restore(
        1, {"params": template}, shardings={"params": shardings})
for key, leaf in paths(got["params"]):
    out["ckpt18|" + key] = (leaf.to_local().clone(),
                            repr(tuple(leaf.placements)))
"""


def _placements(spec, shape):
    return repr(tsh.NamedSharding(SIZES, tuple(spec)).placements)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placement")
    qcfg = _cfg(get_config, reduce_config, "qwen3-4b")
    batches = _batches(qcfg.vocab_size)
    flat = {f"{b}/{k}": a for b, d in batches.items() for k, a in d.items()}
    np.savez(tmp / "batches.npz", **flat)
    # the reference's processes init their own weights: start them first
    consts = (f"ARCHS, RULES, MOE = {ARCHS!r}, {RULES!r}, {MOE!r}\n"
              f"FAMILIES = {FAMILIES!r}\n")
    refs = {name: run_jax(f"IN, OUT = {str(tmp / 'batches.npz')!r}, "
                          f"{str(tmp / name)!r}\n" + consts + code)
            for name, code in (("ref.json", _JAX),
                               ("families.json", _JAX_FAMILIES))}

    trees = {}
    for arch in dict.fromkeys((*ARCHS, MOE, *(a for a, _ in
                                              FAMILIES.values()))):
        jcfg = _cfg(jax_get_config, jax_reduce_config, arch)
        trees[arch] = jax.tree.map(np.asarray, jax_model_fns(jcfg).init(
            jax.random.PRNGKey(0)))
    for arch, tree in trees.items():
        prefix = "moe" if arch == MOE else arch
        flat.update({f"{prefix}/{k}": a for k, a in _paths(tree)})
    np.savez(tmp / "in.npz", **flat)
    CheckpointManager(str(tmp / "ranks" / "ckpt1"), async_save=False).save(
        1, {"params": params_from_numpy(trees["qwen3-4b"], qcfg)})

    ranks = run_ranks(consts + _RANKS, 8, tmp / "ranks",
                      inputs=tmp / "in.npz")

    # the port's one-rank plain steps, meanwhile
    def one_step(cfg, tree, batch):
        params = params_from_numpy(tree, cfg)
        params, _, m = make_train_step(
            model_fns(cfg).loss, TrainConfig(learning_rate=1e-3))(
            params, adamw.init_state(params),
            {k: torch.from_numpy(a) for k, a in batch.items()})
        return ([float(m["loss"]), float(m["grad_norm"])],
                dict(_paths(params)))

    one = {b: one_step(qcfg, trees["qwen3-4b"], batch)
           for b, batch in batches.items()}
    one["moe"] = one_step(reduce_config(get_config(MOE)), trees[MOE],
                          batches["rng"])
    for case, (arch, kw) in FAMILIES.items():
        one["fam|" + case] = one_step(
            reduce_config(get_config(arch)).replace(**kw), trees[arch],
            batches["rng"])

    outs = ranks.wait()
    reference = {}
    for name, ref in refs.items():
        ref.wait()
        with open(tmp / name) as f:
            reference.update(json.load(f))
    return {"ranks": outs, "ref": reference, "one": one, "trees": trees,
            "cfg": qcfg, "ckpt8": str(tmp / "ranks" / "ckpt8")}


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_placed_leaves_are_the_references_device_slices(runs, arch, rules):
    n, leaves = 0, _paths(runs["trees"][arch])
    for key, full in leaves:
        slices = runs["ref"][f"{arch}|{rules}|{key}"]
        for r, out in enumerate(runs["ranks"]):
            want = full[tuple(slice(a, b) for a, b in slices[r])]
            got = out[f"{arch}|{rules}|{key}"].numpy()
            assert got.shape == want.shape and np.array_equal(got, want), \
                (key, r)
            n += 1
    assert n == 8 * len(leaves) and len(leaves) >= 10


def test_shard_act_takes_the_references_spec(runs):
    amesh = abstract_mesh((4, 2), ("data", "model"))
    cases = {"act": ((8, 32, 64), ("batch", "seq", "act_embed")),
             "heads": ((8, 4, 32, 16), ("batch", "act_heads", "seq",
                                        "head_dim")),
             "logits": ((8, 32, 512), ("batch", "seq", "vocab"))}
    for name, (shape, logical) in cases.items():
        spec = jsh.logical_to_physical(logical, shape, jsh.DEFAULT_RULES,
                                       amesh)
        for out in runs["ranks"]:
            placements, same = out["act|" + name]
            assert placements == _placements(spec, shape) and same, name
    assert all(out["act|plain"] for out in runs["ranks"])


def test_shard_act_returns_a_plain_tensor_itself():
    x = torch.ones(4, 8)
    assert tsh.shard_act(x, ("batch", "act_embed")) is x
    with tsh.sharding_context(SIZES, tsh.DEFAULT_RULES):
        assert tsh.shard_act(x, ("batch", "act_embed")) is x
    with pytest.raises(ValueError, match="axis order"):
        tsh.NamedSharding(SIZES, (("model", "data"),)).placements


@pytest.mark.parametrize("batch", BATCHES)
def test_sharded_train_step_matches_one_rank_and_the_reference(runs, batch):
    want = runs["one"][batch][0]
    others = {"port one rank": want, "reference one device":
              runs["ref"]["ref1|" + batch],
              "reference Auto mesh": runs["ref"]["refmesh|" + batch]}
    for out in runs["ranks"]:
        got = out["step|" + batch]
        for name, (loss, gn) in others.items():
            assert abs(got[0] - loss) <= RTOL * abs(loss), (name, got, loss)
            assert abs(got[1] - gn) <= RTOL * abs(gn), (name, got, gn)


@pytest.mark.parametrize("batch", BATCHES)
def test_sharded_train_step_updates_every_leaf(runs, batch):
    want = runs["one"][batch][1]
    got = runs["ranks"][0]["leaves|" + batch]
    assert set(got) == set(want)
    for key, w in want.items():
        err = float((got[key] - w).norm() / w.norm().clamp(min=1e-30))
        assert err <= LEAF_RTOL, (key, err)


def test_placed_moe_step_matches_one_rank(runs):
    (loss, gn), want = runs["one"]["moe"]
    for out in runs["ranks"]:
        got = out["moe|step"]
        assert abs(got[0] - loss) <= RTOL * abs(loss), (got, loss)
        assert abs(got[1] - gn) <= RTOL * abs(gn), (got, gn)
    got = runs["ranks"][0]["moe|leaves"]
    for key, w in want.items():
        err = float((got[key] - w).norm() / w.norm().clamp(min=1e-30))
        assert err <= LEAF_RTOL, (key, err)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_placed_family_step_matches_one_rank_and_the_reference(runs, case):
    (loss, gn), want = runs["one"]["fam|" + case]
    others = {"port one rank": (loss, gn),
              "reference one device": runs["ref"]["fam|" + case]}
    for out in runs["ranks"]:
        got = out["fam|" + case]
        for name, (l, g) in others.items():
            assert abs(got[0] - l) <= RTOL * abs(l), (name, got, l)
            assert abs(got[1] - g) <= RTOL * abs(g), (name, got, g)
    got = runs["ranks"][0]["fam|leaves|" + case]
    assert set(got) == set(want)
    for key, w in want.items():
        err = float((got[key] - w).norm() / w.norm().clamp(min=1e-30))
        assert err <= LEAF_RTOL, (key, err)


def test_kernel_wrappers_on_dtensors(runs):
    for out in runs["ranks"]:
        placements, errs, grads = out["flash|heads"]
        assert placements == "(Shard(dim=0), Shard(dim=1))"
        assert grads == [placements] * 3
        assert errs == [0.0] * 4, errs
        placements, errs, _ = out["flash|seq"]
        assert "Shard" not in placements and errs == [0.0] * 4, errs
        assert out["flash|alone"] > 1e-2
        for op in ("softermax_op", "softermax_quant_op"):
            placements, err = out[op + "|rows"]
            assert placements == "(Shard(dim=0), Replicate())", op
            assert err == 0.0, op
            placements, err = out[op + "|cut"]
            assert placements == "(Replicate(), Replicate())", op
            assert err == 0.0, op


def test_checkpoint_from_one_rank_restores_on_eight(runs):
    amesh = abstract_mesh((4, 2), ("data", "model"))
    specs = dict(_paths(model_fns(runs["cfg"]).specs))
    n, leaves = 0, _paths(runs["trees"]["qwen3-4b"])
    for key, full in leaves:
        slices = runs["ref"][f"qwen3-4b|DEFAULT_RULES|{key}"]
        spec = jsh.logical_to_physical(specs[key], full.shape,
                                       jsh.DEFAULT_RULES, amesh)
        for r, out in enumerate(runs["ranks"]):
            got, placements = out["ckpt18|" + key]
            want = full[tuple(slice(a, b) for a, b in slices[r])]
            assert np.array_equal(got.numpy(), want), (key, r)
            assert placements == _placements(spec, full.shape), key
            n += 1
    assert n == 8 * len(leaves) and len(leaves) >= 10


def test_checkpoint_from_eight_ranks_restores_on_one(runs):
    cfg = runs["cfg"]
    template = params_from_numpy(runs["trees"]["qwen3-4b"], cfg)
    got = CheckpointManager(runs["ckpt8"], async_save=False).restore(
        1, {"params": template})["params"]
    want = runs["ranks"][0]["leaves|rng"]
    for key, leaf in _paths(got):
        assert type(leaf) is torch.Tensor and torch.equal(leaf, want[key])
    assert len(tree_leaves(got)) == len(want)


@pytest.mark.parametrize("flag,ranks", [("--production-mesh", 256),
                                        ("--multi-pod", 512)])
def test_launchers_production_meshes_name_their_size(flag, ranks):
    with pytest.raises(ValueError, match=f"{ranks} ranks"):
        launch_train.main(["--arch", "qwen3-4b", "--reduced", flag,
                           "--device", "cpu"])
    if flag == "--production-mesh":
        with pytest.raises(ValueError, match=f"{ranks} ranks"):
            launch_serve.main([flag, "--device", "cpu"])


def test_launcher_places_and_resumes_placed(tmp_path):
    """``launch.train`` trains placed parameters on the one-rank mesh and
    resumes them placed from its checkpoint."""
    from torch.distributed.tensor import DTensor
    argv = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    first = launch_train.main(argv + ["--steps", "3"])
    again = launch_train.main(argv + ["--steps", "5"])
    assert len(first["history"]) == 3 and len(again["history"]) == 2
    assert np.isfinite(first["history"] + again["history"]).all()
    for out in (first, again):
        assert all(isinstance(t, DTensor) for t in tree_leaves(
            out["params"]) + tree_leaves(out["opt_state"].m))


def test_kernels_refuse_a_dtensor_by_name():
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode.ops import _check
    from repro_torch.kernels.flash_decode_paged.ops import check_operands
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(device="cpu")
    t = distribute_tensor(torch.zeros(2, 4, 8), mesh,
                          [Replicate(), Replicate()])
    plain = torch.zeros(2, 4, 8)
    with pytest.raises(TypeError, match="DTensor"):
        build.ptr(t)
    assert build.ptr(None) is None
    with pytest.raises(TypeError, match="flash_decode_paged.*DTensor"):
        check_operands("flash_decode_paged", t, plain, plain, None, None)
    with pytest.raises(TypeError, match="flash_decode.*DTensor"):
        _check(t, plain, plain, torch.zeros(2, dtype=torch.int32))
