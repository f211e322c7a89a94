"""Training of the MLA, hybrid and RWKV-6 families through the port's
trainer (``train/step.py::make_train_step``, AdamW) on the CPU against
the JAX package's jitted ``make_train_step``.

Reduced deepseek-v2-236b (MLA + MoE with a dense head block) in its
expanded and absorbed (``opt_mla_absorbed``) forms, reduced hymba-1.5b
under ``chunked`` and ``flash`` attention (the port's flash on CPU tensors
runs K3/K4's plain versions, the reference's Pallas kernels run in
interpret mode; both ignore the window under flash), and reduced
rwkv6-7b. Weights come from the reference's ``model_fns(cfg).init``
through the numpy bridge; batches from the shared ``SyntheticLMData``.

Tolerances:

* float32, three AdamW steps at lr 1e-3 (``tests/test_torch_moe.py``'s):
  loss, ce, aux and lr within 1e-5 relative at every step, grad_norm
  within 1e-5 at the first step and 1e-3 after it, every final leaf
  within 2e-4 relative in L2 norm;
* bfloat16 compute, one step from the same f32 master weights: loss, ce
  and aux within ``BF16_TOL`` (2e-3) relative, grad_norm within
  ``BF16_GN_TOL`` (5e-2): two packages rounding the same bf16 products in
  their own order. At these sizes bf16 moves each package's own grad norm
  0.2-1.5% from its float32 one, and its loss by up to 6e-4; the two
  packages' bf16 grad norms differ by 0.02-2.1%. The leaves the
  reference reads in fp32 (``lm.F32_LEAVES``: rwkv's ``u`` and
  ``out_norm``, Mamba's ``a_log``) stay float32 in the parameters and
  in both AdamW moments, as every master leaf does. Their values after
  the step are not compared: they start at 0 or 1, AdamW's first step
  moves each element by ±lr with its gradient's sign, and bf16 compute
  moves those gradients 1-11% in relative L2 in either package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.models.lm import F32_LEAVES
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.train import make_train_step

STEPS, BATCH, SEQ = 3, 4, 32
TC = dict(total_steps=STEPS, warmup_steps=1, learning_rate=1e-3)
KEYS = ("loss", "ce", "aux", "grad_norm", "lr")
BF16_TOL = 2e-3
BF16_GN_TOL = 5e-2

CASES = {
    "deepseek-expanded": ("deepseek-v2-236b", {}),
    "deepseek-absorbed": ("deepseek-v2-236b", {"opt_mla_absorbed": True}),
    "hymba-chunked": ("hymba-1.5b", {"attention_impl": "chunked"}),
    "hymba-flash": ("hymba-1.5b", {"attention_impl": "flash"}),
    "rwkv6": ("rwkv6-7b", {}),
}

_INITS = {}


def _init(arch):
    """The reference's init of the reduced arch, as numpy (once a file)."""
    if arch not in _INITS:
        jcfg = jax_reduce_config(jax_get_config(arch))
        _INITS[arch] = jax.tree.map(
            np.asarray, jax_model_fns(jcfg).init(jax.random.PRNGKey(0)))
    return _INITS[arch]


def _configs(case, **over):
    arch, kw = CASES[case]
    kw = {**kw, **over}
    jcfg = jax_reduce_config(jax_get_config(arch)).replace(
        **kw, interpret_kernels=kw.get("attention_impl") == "flash")
    tcfg = reduce_config(get_config(arch)).replace(**kw)
    return jcfg, tcfg, _init(arch)


def _steps(jcfg, tcfg, np_params, n):
    """n steps of each package from the same weights and batches: (the
    reference's metrics per step, the port's, the reference's final
    parameters, the port's final parameters and AdamW state)."""
    jstep = jax.jit(jax_make_train_step(jax_model_fns(jcfg).loss,
                                        JaxTrainConfig(**TC)))
    tstep = make_train_step(model_fns(tcfg).loss, TrainConfig(**TC))
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params, tcfg)
    jopt, topt = jadamw.init_state(jp), tadamw.init_state(tp)
    data = SyntheticLMData(tcfg.vocab_size, SEQ, BATCH, seed=0)
    jms, tms = [], []
    for _ in range(n):
        batch = next(data)
        jp, jopt, jm = jstep(jp, jopt, batch)
        tp, topt, tm = tstep(tp, topt, batch)
        jms.append({k: float(jm[k]) for k in KEYS})
        tms.append({k: float(tm[k]) for k in KEYS})
    return jms, tms, jp, tp, topt


def _paths(tree, prefix=()):
    """(key path, leaf) of a nested dict in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        prefix + (k,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(case):
    jcfg, tcfg, np_params = _configs(case)
    jms, tms, jp, tp, _ = _steps(jcfg, tcfg, np_params, STEPS)
    for s, (jm, tm) in enumerate(zip(jms, tms)):
        assert np.isfinite(list(tm.values())).all(), (s, tm)
        for k in KEYS:
            rtol = 1e-3 if (k == "grad_norm" and s) else 1e-5
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol,
                                       err_msg=f"{case} {k} step {s}")
    if tcfg.family == "moe":
        assert all(tm["aux"] > 0 for tm in tms)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves) == len(tree_leaves(tp))
    for (path, want), got in zip(leaves, tree_leaves(tp)):
        want = np.asarray(want)
        err = np.linalg.norm(got.numpy() - want)
        assert err <= 2e-4 * np.linalg.norm(want), \
            (case, jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_step_keeps_f32_leaves(case):
    jcfg, tcfg, np_params = _configs(case, compute_dtype="bfloat16")
    jms, tms, _, tp, topt = _steps(jcfg, tcfg, np_params, 1)
    for k in ("loss", "ce", "aux", "grad_norm"):
        rtol = BF16_GN_TOL if k == "grad_norm" else BF16_TOL
        np.testing.assert_allclose(tms[0][k], jms[0][k], rtol=rtol,
                                   err_msg=f"{case} bf16 {k}")
    for tree in (tp, topt.m, topt.v):
        for path, leaf in _paths(tree):
            assert leaf.dtype == torch.float32, (case, path, leaf.dtype)
    named = [p for p, _ in _paths(tp) if p[-1] in F32_LEAVES]
    # rwkv6 carries u and out_norm, hymba a_log; deepseek none
    assert len(named) == {"rwkv": 2, "hybrid": 1}.get(tcfg.family, 0)


def _node_names(t):
    """The class names of every node of ``t``'s autograd graph."""
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_scan_backward_does_not_grow_with_the_sequence(arch):
    """The scans read their time steps through ``unbind``: no autograd node
    per step that would write a gradient of the whole sequence (a
    ``SelectBackward0`` of ``decay[:, t]`` made the backward quadratic in
    S). The graph's select nodes are the same at S 8 and S 24."""
    from repro_torch.models import hymba, rwkv6
    cfg = reduce_config(get_config(arch))
    block = params_from_numpy(_init(arch), cfg)["blocks"]["mixer"]
    counts = []
    for S in (8, 24):
        x = torch.randn(2, S, cfg.d_model, generator=torch.Generator()
                        .manual_seed(S), requires_grad=True)
        if arch == "rwkv6-7b":
            p = {k: v[0] for k, v in block.items()}
            y = rwkv6.rwkv_time_apply(p, x, cfg)
        else:
            p = {k: v[0] for k, v in block["mamba"].items()}
            y = hymba.mamba_apply(p, x, cfg)
        names = _node_names(y.sum())
        assert "UnbindBackward0" in names
        counts.append(names.count("SelectBackward0"))
    assert counts[0] == counts[1], counts


def test_chunked_attention_keeps_no_scores_for_the_backward():
    """Under autograd ``chunked_attention`` checkpoints each KV chunk's
    step: no saved tensor is as large as one chunk's (Sq, chunk) scores,
    and the gradients equal those of the same steps without the
    checkpoints."""
    from repro_torch.models import attention
    g = torch.Generator().manual_seed(5)
    B, H, S, D, chunk = 1, 2, 256, 8, 128
    q, k, v = (torch.randn(B, H, S, D, generator=g, requires_grad=True)
               for _ in range(3))
    sizes = []

    def pack(t):
        sizes.append(t.untyped_storage().nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = attention.chunked_attention(q, k, v, causal=True, intmax=True,
                                        chunk=chunk)
    assert max(sizes) < B * H * S * chunk * 4, max(sizes)
    got = torch.autograd.grad(o.square().sum(), (q, k, v))
    # the same recurrence, each step kept whole by autograd
    qg = q.reshape(B, H, 1, S, D)
    m = torch.full((B, H, 1, S, 1), -1e9)
    d, acc = torch.zeros_like(m), torch.zeros(B, H, 1, S, D)
    pos = torch.arange(S)
    for c in range(S // chunk):
        kp = c * chunk + torch.arange(chunk)
        m, d, acc = attention._chunk_step(
            qg, k[:, :, None, c * chunk:(c + 1) * chunk],
            v[:, :, None, c * chunk:(c + 1) * chunk], m, d, acc,
            pos[:, None] >= kp[None, :], True)
    want_o = (acc / d).reshape(B, H, S, D)
    want = torch.autograd.grad(want_o.square().sum(), (q, k, v))
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
