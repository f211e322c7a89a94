"""The port's int8 compressed all-reduce and data-parallel step against the
JAX package, on gloo process groups on the CPU.

The reference's numbers come from one JAX process with 8 virtual CPU
devices (``shard_map`` over a ``(8,)`` data mesh, as
``tests/test_parallel.py`` runs them); the port's from 8 (and 2) gloo
ranks, started once for the file (``tests/torch_ranks.py``). Inputs come
from numpy seeds, the weights from the reference's init of reduced
llama3.2-3b.

Tolerances, and why:

* ``compressed_psum``: the mean and every shard's residual EXACTLY equal
  to the reference's (the same order of operations in float32; round
  half to even in both);
* one DDP step at 8 ranks, with and without int8 compression: the loss
  within 1e-5 relative; every parameter leaf within 1e-5 relative in L2
  norm at lr 1e-5 (AdamW's first step moves an element by ~lr whatever
  its gradient's size, so a code that rounds the other way in the two
  packages moves it by at most 2·lr); under compression every element of
  the mean gradient (AdamW's first moment over 1 - b1) within one code
  step (the shared scale over 8 ranks) of the reference's, and at most
  1e-3 of them a code apart (measured 41 of 106,816: ~1e-6 of float32
  sum-order noise in a gradient moves ``g / scale`` across a rounding
  boundary in about that share of the 8 ranks' 854,528 codes);
* the 2-rank step without compression against the one-rank step on the
  whole batch (the card's check): the loss within 1e-6 relative, every
  parameter leaf within 1e-6 relative in L2 norm.

Since the first step's update does not scale with the gradient, the
uncompressed steps also hold AdamW's first moment (``(1 - b1) g``, the
mean gradient), leaf by leaf, in relative L2 norm: at 8 ranks within
1e-4 of the reference's (``test_torch_train``'s gradient bound; measured
1.7e-5, float32 gradient noise between the two packages), at 2 ranks
within 1e-6 of the one-rank step's (measured 2.9e-7). An all-reduce that
sums where it should average gives 8 times the mean at 8 ranks and
fails either.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro_torch.parallel.collectives import compressed_psum_tree
from torch_ranks import run_jax, run_ranks

B, S, LR = 8, 32, 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


# nested dict from "a/b/c" keys (in the JAX process and in the ranks)
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
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import TrainConfig
from repro.models.registry import get_config, model_fns, reduce_config
from repro.optim import adamw
from repro.parallel.collectives import compressed_psum
from repro.parallel.compat import shard_map
from repro.train.step import make_ddp_train_step
inp = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((8,), ("data",))
for name in ("x_arange", "x_scales"):
    f = jax.jit(shard_map(lambda xs: compressed_psum(xs, "data"),
                          mesh=mesh, in_specs=P("data"),
                          out_specs=(P("data"), P("data"))))
    mean, resid = f(jnp.asarray(inp[name]))
    out[name + "_mean"], out[name + "_resid"] = map(np.asarray,
                                                    (mean, resid))
cfg = reduce_config(get_config("llama3.2-3b"))
params = jax.tree.map(jnp.asarray, nest(inp, "p/"))
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
for comp in (False, True):
    tc = TrainConfig(grad_compression=comp, learning_rate=%(lr)r,
                     warmup_steps=1, total_steps=10)
    step = jax.jit(make_ddp_train_step(model_fns(cfg).loss, tc, mesh))
    errors = jax.tree.map(jnp.zeros_like, params)
    p2, o2, e2, m = step(params, adamw.init_state(params), errors, batch)
    tag = "c" if comp else "u"
    out[tag + "_loss"] = np.asarray(m["loss"])
    for k, a in jax.tree_util.tree_flatten_with_path(p2)[0]:
        out[tag + "_p/" + "/".join(e.key for e in k)] = np.asarray(a)
    for k, a in jax.tree_util.tree_flatten_with_path(o2.m)[0]:
        out[tag + "_m/" + "/".join(e.key for e in k)] = np.asarray(a)
np.savez(sys.argv[2], **out)
""" % {"lr": LR}

_RANKS = _NEST + """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_map
from repro_torch.optim import adamw
from repro_torch.parallel.collectives import compressed_psum
from repro_torch.train.step import make_ddp_train_step, make_train_step

def flat(tree, prefix):
    if isinstance(tree, dict):
        o = {}
        for k in tree:
            o.update(flat(tree[k], prefix + k + "/"))
        return o
    return {prefix[:-1]: tree.detach().clone()}

mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
if world == 8:
    for name in ("x_arange", "x_scales"):
        mean, resid = compressed_psum(torch.from_numpy(inp[name][rank]))
        out[name + "_mean"], out[name + "_resid"] = mean, resid
cfg = reduce_config(get_config("llama3.2-3b"))
fns = model_fns(cfg)
batch = {"tokens": torch.from_numpy(inp["tokens"]),
         "labels": torch.from_numpy(inp["labels"])}
for comp in ((False, True) if world == 8 else (False,)):
    tc = TrainConfig(grad_compression=comp, learning_rate=%(lr)r,
                     warmup_steps=1, total_steps=10)
    params = params_from_numpy(nest(inp, "p/"), cfg)
    errors = tree_map(torch.zeros_like, params)
    step = make_ddp_train_step(fns.loss, tc, mesh)
    p2, o2, e2, m = step(params, adamw.init_state(params), errors, batch)
    tag = "c" if comp else "u"
    out[tag + "_loss"] = m["loss"]
    out.update(flat(p2, tag + "_p/"))
    out.update(flat(o2.m, tag + "_m/"))
    if rank == 0 and world == 2:
        params = params_from_numpy(nest(inp, "p/"), cfg)
        p1, o1, m1 = make_train_step(fns.loss, tc)(
            params, adamw.init_state(params), batch)
        out["one_loss"] = m1["loss"]
        out.update(flat(p1, "one_p/"))
        out.update(flat(o1.m, "one_m/"))
""" % {"lr": LR}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b"))
    params = jax.tree.map(np.asarray,
                          jax_model_fns(jcfg).init(jax.random.PRNGKey(0)))
    inp = {f"p/{k}": v for k, v in _flat(params).items()}
    inp["x_arange"] = (np.arange(8 * 32, dtype=np.float32)
                       .reshape(8, 1, 32) / 77.0)
    # magnitudes over six decades, so codes of 0, ±1 and ±127 all occur
    inp["x_scales"] = (rng.normal(size=(8, 5, 33)) *
                       10.0 ** rng.uniform(-3, 3, (8, 5, 1))
                       ).astype(np.float32)
    inp["tokens"] = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    inp["labels"] = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    path = tmp / "inputs.npz"
    np.savez(path, **inp)
    ref = run_jax(_JAX.replace("sys.argv[1]", repr(str(path))).replace(
        "sys.argv[2]", repr(str(tmp / "ref.npz"))))
    eight = run_ranks(_RANKS, 8, tmp / "eight", path)
    two = run_ranks(_RANKS, 2, tmp / "two", path)
    ref.wait()
    return {"ref": dict(np.load(tmp / "ref.npz")), "eight": eight.wait(),
            "two": two.wait()}


@pytest.mark.parametrize("name", ["x_arange", "x_scales"])
def test_compressed_psum_is_the_references_exactly(runs, name):
    ref = runs["ref"]
    for r, out in enumerate(runs["eight"]):
        np.testing.assert_array_equal(out[name + "_mean"].numpy(),
                                      ref[name + "_mean"][r])
        np.testing.assert_array_equal(out[name + "_resid"].numpy(),
                                      ref[name + "_resid"][r])


def test_compressed_psum_uses_every_code():
    """The scaled input reaches both saturated codes and zero (one rank:
    the shared scale is its own)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        from repro_torch.launch.mesh import make_host_mesh
        make_host_mesh(device="cpu")
    x = torch.tensor([1e-6, -1.0, 1.0, 0.5 / 127, 0.3])
    mean, resid = compressed_psum_tree({"x": x})
    codes = torch.round(mean["x"] / (1.0 / 127))
    assert codes.tolist() == [0.0, -127.0, 127.0, 0.0, 38.0]
    assert torch.equal(mean["x"] + resid["x"], x)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("tag", ["u", "c"])
def test_ddp_step_matches_the_reference_at_8_ranks(runs, tag):
    ref = runs["ref"]
    outs = runs["eight"]
    loss = float(ref[tag + "_loss"])
    keys = [k for k in ref if k.startswith(tag + "_p/")]
    assert keys
    for out in outs:
        assert abs(float(out[tag + "_loss"]) - loss) <= 1e-5 * abs(loss)
        for k in keys:
            assert _rel_l2(out[k].numpy(), ref[k]) <= 1e-5, k
    if tag == "u":
        # the mean gradient through AdamW's first moment, which (unlike
        # the first step's update) scales with it: a sum in place of the
        # mean would be 8x off
        moments = [k for k in ref if k.startswith("u_m/")]
        assert len(moments) == len(keys)
        for out in outs:
            for k in moments:
                assert _rel_l2(out[k].numpy(), ref[k]) <= 1e-4, k
    if tag == "c":
        # the mean gradient: m = (1 - b1) g after one step, a multiple of
        # one code step (the shared scale over 8 ranks, clipped), which the
        # leaf's smallest nonzero |g| is; no element may be further apart
        flips = total = 0
        for k in (k for k in ref if k.startswith("c_m/")):
            g_ref, g = ref[k] / 0.1, outs[0][k].numpy() / 0.1
            step = np.abs(g_ref[g_ref != 0]).min()
            assert np.abs(g - g_ref).max() <= step * 1.001, k
            flips += int((np.abs(g - g_ref) > step / 2).sum())
            total += g.size
        assert flips <= 1e-3 * total, (flips, total)
    # every rank holds the same parameters
    for out in outs[1:]:
        for k in keys:
            assert torch.equal(out[k], outs[0][k]), k


def test_ddp_step_two_ranks_match_one_rank_on_the_whole_batch(runs):
    r0, r1 = runs["two"]
    one = float(r0["one_loss"])
    assert abs(float(r0["u_loss"]) - one) <= 1e-6 * abs(one)
    keys = [k for k in r0 if k.startswith("one_p/")]
    for k in keys:
        got = r0["u_p/" + k[len("one_p/"):]].numpy()
        assert _rel_l2(got, r0[k].numpy()) <= 1e-6, k
        assert torch.equal(r0["u_p/" + k[6:]], r1["u_p/" + k[6:]])
    # the first moment: the two ranks' mean gradient is the whole batch's
    moments = [k for k in r0 if k.startswith("one_m/")]
    assert len(moments) == len(keys)
    for k in moments:
        got = r0["u_m/" + k[len("one_m/"):]].numpy()
        assert _rel_l2(got, r0[k].numpy()) <= 1e-6, k
