"""The port's training path on the CPU against the JAX package.

Slice parity: reduced llama3.2-3b, ``attention_impl`` chunked and flash
(the JAX side with ``interpret_kernels=True``, the port's flash op on its
plain versions), the JAX init weights bridged through numpy, the same
``SyntheticLMData`` batches, three ``make_train_step`` steps in each
package.

Tolerances, and why. This model's float32 gradients sit ~3e-5 (of each
leaf's largest entry) from a float64 evaluation in *either* package: with
tied unit-variance embeddings the logits are large and the per-element
sums cancel. AdamW then divides each element's moment by its own root
mean square, so an element whose gradient is small against that noise
takes a visibly different step in the two packages, and the two
trajectories part element by element (by up to ~lr on the few elements
whose first gradient is at the noise floor). So:

* one forward/backward (step 0, before any update): loss, ce, grad_norm and
  lr within 1e-5 relative; every gradient leaf within 1e-4 of the leaf's
  largest entry;
* three steps at lr 1e-5, where that noise moves no parameter visibly:
  loss, ce, grad_norm and lr within 1e-5 relative at every step, and every
  final parameter leaf within 1e-5 relative in L2 norm;
* three steps at lr 1e-3, where a wrong update would show: loss, ce and lr
  within 1e-5 relative at every step, grad_norm within 1e-3 after the
  first; every final parameter leaf within 2e-4 relative in L2 norm
  (measured up to 7.4e-5);
* the port's flash path against its chunked path (the same BLAS for all
  else), at lr 1e-5: every metric at every step within 1e-5 relative and
  every final leaf within 1e-5 relative in L2 norm (measured 3.9e-7 and
  1.4e-8; at lr 1e-3 the same noise reaches 1.9e-6 and 1.3e-6 here, and
  6e-5 from other random weights).

Also: two microbatches against one, exact checkpoint resume, the NaN
guard, and the launcher.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.train import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.train import make_train_step, train

RTOL = 1e-5
STEPS, BATCH, SEQ = 3, 4, 32
TC = dict(total_steps=STEPS, warmup_steps=1, learning_rate=1e-3)
# learning rate -> (grad_norm rtol after step 0, final leaf rtol in L2)
LR_TOLS = {1e-5: (RTOL, RTOL), 1e-3: (1e-3, 2e-4)}


@pytest.fixture(scope="module")
def jax_init():
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b"))
    return jax.tree.map(np.asarray,
                        jax_model_fns(jcfg).init(jax.random.PRNGKey(0)))


def _configs(impl):
    jcfg = jax_reduce_config(jax_get_config("llama3.2-3b")).replace(
        attention_impl=impl, interpret_kernels=impl == "flash")
    tcfg = reduce_config(get_config("llama3.2-3b")).replace(
        attention_impl=impl)
    return jcfg, tcfg


def _run_jax(jcfg, params, lr):
    step = jax.jit(jax_make_train_step(jax_model_fns(jcfg).loss,
                                       JaxTrainConfig(**{**TC,
                                                         "learning_rate": lr})))
    from repro.optim import adamw
    opt = adamw.init_state(params)
    data = SyntheticLMData(jcfg.vocab_size, SEQ, BATCH, seed=0)
    hist = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, next(data))
        hist.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm",
                                              "lr")})
    return jax.tree.map(np.asarray, params), hist


def _run_torch(tcfg, params, tc=None):
    step = make_train_step(model_fns(tcfg).loss, tc or TrainConfig(**TC))
    from repro_torch.optim import adamw
    opt = adamw.init_state(params)
    data = SyntheticLMData(tcfg.vocab_size, SEQ, BATCH, seed=0)
    hist = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, next(data))
        hist.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm",
                                              "lr")})
    return params, hist


@pytest.fixture(scope="module")
def runs(jax_init):
    """Three steps of each package under each impl and learning rate."""
    out = {}
    for impl in ("chunked", "flash"):
        jcfg, tcfg = _configs(impl)
        for lr in LR_TOLS:
            out["jax", impl, lr] = _run_jax(
                jcfg, jax.tree.map(jax.numpy.asarray, jax_init), lr)
            out["torch", impl, lr] = _run_torch(
                tcfg, params_from_numpy(jax_init, tcfg),
                TrainConfig(**{**TC, "learning_rate": lr}))
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_gradients_match_jax(jax_init):
    """One forward/backward through the flash path (the chunked path's
    step-0 loss and grad norm are held by the three-step test)."""
    from repro_torch.train import make_loss_and_grad
    jcfg, tcfg = _configs("flash")
    batch = next(SyntheticLMData(jcfg.vocab_size, SEQ, BATCH, seed=0))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jax_model_fns(jcfg).loss, has_aux=True))(
        jax.tree.map(jax.numpy.asarray, jax_init), batch)
    tloss, tm, tgrads = make_loss_and_grad(
        model_fns(tcfg).loss, TrainConfig())(
        params_from_numpy(jax_init, tcfg), batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=RTOL)
    jleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    tleaves = [g.numpy() for g in tree_leaves(tgrads)]
    assert [g.shape for g in jleaves] == [g.shape for g in tleaves]
    for j, t in zip(jleaves, tleaves):
        assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()


@pytest.mark.parametrize("lr", sorted(LR_TOLS))
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_three_steps_match_jax(runs, impl, lr):
    gn_rtol, leaf_rtol = LR_TOLS[lr]
    jparams, jhist = runs["jax", impl, lr]
    tparams, thist = runs["torch", impl, lr]
    for s, (j, t) in enumerate(zip(jhist, thist)):
        for key in j:
            rtol = gn_rtol if key == "grad_norm" and s > 0 else RTOL
            np.testing.assert_allclose(t[key], j[key], rtol=rtol,
                                       err_msg=f"step {s} {key}")
    assert thist[0]["loss"] != thist[-1]["loss"]
    jleaves = jax.tree_util.tree_leaves(jparams)
    tleaves = tree_leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert _rel_l2(t.numpy(), j) <= leaf_rtol


def test_flash_matches_chunked(runs):
    cparams, chist = runs["torch", "chunked", 1e-5]
    fparams, fhist = runs["torch", "flash", 1e-5]
    for s, (c, f) in enumerate(zip(chist, fhist)):
        for key in c:
            np.testing.assert_allclose(f[key], c[key], rtol=RTOL,
                                       err_msg=f"step {s} {key}")
    for c, f in zip(tree_leaves(cparams), tree_leaves(fparams)):
        assert _rel_l2(f.numpy(), c.numpy()) <= RTOL


def test_microbatches_match_one_batch(jax_init):
    _, tcfg = _configs("flash")
    one, h1 = _run_torch(tcfg, params_from_numpy(jax_init, tcfg))
    two, h2 = _run_torch(tcfg, params_from_numpy(jax_init, tcfg),
                         TrainConfig(**TC, microbatches=2))
    for a, b in zip(h1, h2):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=RTOL)
    for a, b in zip(tree_leaves(one), tree_leaves(two)):
        assert _rel_l2(b.numpy(), a.numpy()) <= RTOL


def test_resume_is_exact(jax_init):
    """Stop after 2 of 4 steps, resume from the checkpoint: bit-identical
    to the uninterrupted run (parameters, optimizer and data stream)."""
    _, tcfg = _configs("flash")
    fns = model_fns(tcfg)

    step = make_train_step(fns.loss, TrainConfig(
        total_steps=4, warmup_steps=1, learning_rate=1e-3))

    def run(ckpt_dir, total):
        tc = TrainConfig(total_steps=total, warmup_steps=1,
                         learning_rate=1e-3, checkpoint_every=2)
        data = SyntheticLMData(tcfg.vocab_size, SEQ, BATCH, seed=9)
        return train(train_step=step,
                     params=params_from_numpy(jax_init, tcfg), data=data,
                     tc=tc, ckpt_dir=ckpt_dir, log_every=1000)

    with tempfile.TemporaryDirectory() as d:
        whole = run(None, 4)
        run(d, 2)
        resumed = run(d, 4)
    assert resumed["history"] == whole["history"][2:]
    for a, b in zip(tree_leaves(whole["params"]),
                    tree_leaves(resumed["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(tree_leaves([whole["opt_state"].m,
                                 whole["opt_state"].v]),
                    tree_leaves([resumed["opt_state"].m,
                                 resumed["opt_state"].v])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(resumed["opt_state"].step) == 4


def test_nan_loss_raises(jax_init):
    _, tcfg = _configs("chunked")
    data = SyntheticLMData(tcfg.vocab_size, SEQ, BATCH, seed=5)

    def bad_step(p, o, b):
        return p, o, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError):
        train(train_step=bad_step, params=params_from_numpy(jax_init, tcfg),
              data=data, tc=TrainConfig(total_steps=3))


def test_launcher_defaults_to_the_card_and_runs_on_cpu():
    assert launch_train.parse_args([]).device == "cuda"
    out = launch_train.main(["--arch", "llama3.2-3b", "--reduced",
                             "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "16"])
    assert len(out["history"]) == 2 and np.isfinite(out["history"]).all()
    with pytest.raises(ValueError, match="256 ranks"):
        launch_train.main(["--production-mesh", "--device", "cpu"])


def test_bf16_param_cast_follows_the_stacked_rank(jax_init):
    """``opt_bf16_params`` casts by the JAX leaf's rank: block norm scales
    are stacked ``(n_layers, d)`` there, so the trainer's per-layer 1-D
    leaves are cast too; ``final_norm`` is not."""
    from repro.models.lm import maybe_cast_params as jax_cast
    from repro_torch.models.lm import maybe_cast_params
    from repro_torch.models.schema import tree_map
    from repro_torch.train.step import _grad_leaves
    jcfg, tcfg = (c.replace(opt_bf16_params=True, compute_dtype="bfloat16")
                  for c in _configs("flash"))
    jtree = jax_cast(jax.tree.map(jax.numpy.asarray, jax_init), jcfg)
    params = params_from_numpy(jax_init, tcfg)
    cast = maybe_cast_params(
        _grad_leaves(params, tree_map(torch.zeros_like, params)), tcfg)
    paths = jax.tree_util.tree_flatten_with_path(jtree)[0]
    one_layer = {**cast, "blocks": cast["blocks"][0]}
    assert len(paths) == len(tree_leaves(one_layer))
    for path, leaf in paths:
        keys = [p.key for p in path]
        want = str(leaf.dtype)
        if keys[0] == "blocks":
            got = {str(layer[keys[1]][keys[2]].dtype).split(".")[1]
                   for layer in cast["blocks"]}
        else:
            got = {str(cast[keys[0]][keys[1]].dtype).split(".")[1]}
        assert got == {want}, (keys, got, want)
