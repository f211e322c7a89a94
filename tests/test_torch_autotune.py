"""The port's engine autotune hook against the JAX package's.

Reduced qwen3-4b with the JAX init bridged through numpy, bfloat16 and
int8 pools, knobs ``kv_tile_blocks=2, decode_split_k=2`` (candidates
{1, 2} x {1, 2}): under ``autotune`` off, static and per-step the port's
``ContinuousEngine`` on the CPU emits greedy streams EXACTLY equal to the
JAX engine's under the same mode and to each other; the static mode
rebinds the same grid as JAX's; the per-step planner makes the same
decisions, step for step, with the same predicted seconds. An unknown mode
raises.
"""
import jax
import numpy as np
import pytest

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ContinuousEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import AUTOTUNE_MODES, ContinuousEngine

KW = dict(block_size=8, num_blocks=48, max_batch=4, max_len=64,
          kv_tile_blocks=2, decode_split_k=2)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduce_config(jax_get_config("qwen3-4b"))
    tcfg = reduce_config(get_config("qwen3-4b"))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _serve(eng):
    rng = np.random.default_rng(5)
    hs = [eng.submit(rng.integers(1, 100, (n,)).astype(np.int32), 5)
          for n in (9, 21, 13)]
    res = eng.run()
    return [res[h.req_id].tokens for h in hs]


@pytest.fixture(scope="module")
def runs(model):
    """Both engines under every mode and pool dtype, run once."""
    jcfg, tcfg, jparams, tparams = model
    out = {}
    for kv in ("bf16", "int8"):
        for mode in AUTOTUNE_MODES:
            jeng = JaxEngine(jcfg, jparams, kv_dtype=kv, autotune=mode, **KW)
            teng = ContinuousEngine(tcfg, tparams, kv_dtype=kv,
                                    autotune=mode, device="cpu", **KW)
            out[kv, mode] = (_serve(jeng), jeng, _serve(teng), teng)
    return out


@pytest.mark.parametrize("mode", AUTOTUNE_MODES)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_streams_and_decisions_match_jax(runs, kv, mode):
    jtoks, jeng, ttoks, teng = runs[kv, mode]
    assert ttoks == jtoks
    assert all(len(t) == 5 for t in ttoks)
    assert (teng.kv_tile_blocks, teng.decode_split_k) == \
        (jeng.kv_tile_blocks, jeng.decode_split_k)
    if mode == "off":
        assert teng.planner is None and jeng.planner is None
        return
    assert teng.planner.candidates == jeng.planner.candidates
    assert teng.planner.decisions == jeng.planner.decisions
    if mode == "per-step":
        assert sum(teng.planner.summary().values()) == \
            teng.metrics.decode_steps > 0
    else:
        # static: one decision, on the worst-case batch, at construction
        assert len(teng.planner.decisions) == 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_modes_give_the_same_streams(runs, kv):
    streams = [runs[kv, mode][2] for mode in AUTOTUNE_MODES]
    assert streams[0] == streams[1] == streams[2]


def test_static_mode_rebinds_the_reference_grid(runs):
    _, jeng, _, teng = runs["bf16", "static"]
    assert (teng.kv_tile_blocks, teng.decode_split_k) == \
        (jeng.kv_tile_blocks, jeng.decode_split_k) != (2, 2)


def test_invalid_mode_rejected(model):
    _, tcfg, _, tparams = model
    with pytest.raises(ValueError, match="autotune"):
        ContinuousEngine(tcfg, tparams, autotune="always", device="cpu",
                         **KW)
