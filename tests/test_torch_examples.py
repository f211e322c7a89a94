"""The port's example programs
(``repro_torch/examples/{train_lm,serve_lm}.py``) and
``models/schema.py::num_params`` on the CPU.

* ``num_params`` of every grid arch's full-size schema EXACTLY equal to
  the reference's ``repro.models.schema.num_params``;
* ``train_lm.main`` at the tiny preset (reduced llama3.2-3b) for 20 steps:
  one loss a step, finite, the last below the first and the mean of the
  last five below the mean of the first five;
* ``serve_lm.main`` at its reduced default (qwen3-4b, 4 mixed-length
  prompts, 16 new tokens): its greedy streams EXACTLY equal to a direct
  ``ContinuousEngine`` run over the same weights and prompts, and to the
  JAX package's ``ContinuousEngine`` on those weights (float32);
* both default to the CUDA card and raise without one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.models.schema import num_params as jax_num_params
from repro.serve import ContinuousEngine as JaxContinuousEngine
from repro_torch.examples import serve_lm, train_lm
from repro_torch.models.registry import (GRID_ARCHS, get_config, model_fns,
                                         reduce_config)
from repro_torch.models.schema import num_params
from repro_torch.serve import ContinuousEngine


@pytest.mark.parametrize("arch", GRID_ARCHS)
def test_num_params_equals_the_reference(arch):
    want = jax_num_params(jax_model_fns(jax_get_config(arch)).schema)
    assert num_params(model_fns(get_config(arch)).schema) == want > 0


def test_train_lm_tiny_loss_goes_down(capsys):
    out = train_lm.main(["--preset", "tiny", "--steps", "20",
                         "--device", "cpu"])
    h = out["history"]
    assert len(h) == 20 and np.isfinite(h).all()
    assert h[-1] < h[0] and np.mean(h[-5:]) < np.mean(h[:5]), h
    printed = capsys.readouterr().out
    n = num_params(model_fns(train_lm.PRESETS["tiny"]).schema)
    assert f"params={n / 1e6:.1f}M" in printed
    assert f"loss: {h[0]:.4f} -> {h[-1]:.4f} over 20 steps" in printed


def test_serve_lm_streams_equal_a_direct_engine_run():
    out = serve_lm.main(["--device", "cpu"])
    args = dict(block_size=16, num_blocks=64, max_batch=4, max_len=48)
    cfg = reduce_config(get_config("qwen3-4b"))
    params = model_fns(cfg).init(torch.Generator().manual_seed(0))
    eng = ContinuousEngine(cfg, params, device="cpu", **args)
    handles = [eng.submit(p, 16) for p in out["prompts"]]
    got = eng.run()
    want = {h.req_id: list(got[h.req_id].tokens) for h in handles}
    assert out["tokens"] == want
    assert all(len(t) == 16 for t in want.values())
    jeng = JaxContinuousEngine(
        jax_reduce_config(jax_get_config("qwen3-4b")),
        jax.tree.map(lambda a: a.numpy(), params), **args)
    jh = [jeng.submit(p, 16) for p in out["prompts"]]
    jgot = jeng.run()
    assert [list(jgot[h.req_id].tokens) for h in jh] == \
        [want[h.req_id] for h in handles]


@pytest.mark.parametrize("main", [train_lm.main, serve_lm.main],
                         ids=["train_lm", "serve_lm"])
def test_examples_default_to_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
