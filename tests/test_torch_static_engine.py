"""The port's static-slot ``ServeEngine`` on the CPU against the JAX
package's ``ServeEngine`` and against the port's own paged engine.

Held EXACTLY equal: greedy token streams of the port's and the JAX
package's static engines (the JAX init bridged through numpy, the same
prompts) for reduced llama3.2-3b and qwen3-4b, with a float32 cache, an
int8 cache (``opt_int8_kv``), the decode kernel's plain version
(``interpret_kernels``; the JAX side runs its Pallas kernel in interpret
mode) and ``opt_dus_cache``; and the greedy streams of the port's static
and paged engines (the counterpart of ``tests/test_serving.py``'s "static
and paged engines must emit IDENTICAL greedy tokens").

Temperature sampling cannot be held to JAX's (different generators): it
is reproducible from the seed, and its first tokens are tested as a
distribution against the base-2 softmax of the prefill logits.
"""
import logging

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns as jax_model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.softermax import softmax_base2
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import ContinuousEngine, GenerateResult, ServeEngine


@pytest.fixture(scope="module", params=["llama3.2-3b", "qwen3-4b"])
def model(request):
    jcfg = jax_reduce_config(jax_get_config(request.param))
    tcfg = reduce_config(get_config(request.param))
    jparams = jax_model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _prompts(cfg, seed=3, shape=(3, 20)):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("over", [{}, {"opt_int8_kv": True},
                                  {"interpret_kernels": True},
                                  {"opt_dus_cache": True},
                                  {"opt_bf16_params": True}],
                         ids=["f32", "int8", "interpret", "dus",
                              "bf16_params"])
def test_greedy_streams_match_jax(model, over):
    jcfg, tcfg, jparams, tparams = model
    jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    prompts = _prompts(tcfg)
    want = JaxServeEngine(jcfg, jparams, max_len=28).generate(prompts, 8)
    got = ServeEngine(tcfg, tparams, max_len=28, device="cpu").generate(
        prompts, 8)
    assert isinstance(got, GenerateResult) and got.steps == 8
    assert got.tokens.shape == (3, 8) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_static_matches_paged_engine(model):
    """The port's two engines on the same weights and prompts."""
    _, tcfg, _, tparams = model
    prompts = _prompts(tcfg, seed=4, shape=(2, 20))
    static = ServeEngine(tcfg, tparams, max_len=26, device="cpu").generate(
        prompts, 6)
    eng = ContinuousEngine(tcfg, tparams, block_size=8, num_blocks=32,
                           max_batch=4, max_len=32, device="cpu")
    handles = [eng.submit(p, 6) for p in prompts]
    res = eng.run()
    for h, want in zip(handles, static.tokens):
        assert res[h.req_id].tokens == want.tolist()


def test_temperature_sampling_reproducible_from_the_seed(model):
    _, tcfg, _, tparams = model
    eng = ServeEngine(tcfg, tparams, max_len=24, device="cpu")
    prompts = _prompts(tcfg, seed=6, shape=(2, 12))
    runs = [eng.generate(prompts, 10, temperature=1.0, seed=s).tokens
            for s in (5, 5, 6)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < tcfg.vocab_size)).all()


def test_temperature_sampling_follows_the_distribution(model):
    """4096 copies of one prompt: the first sampled token's frequencies
    against p = base-2 softmax of logits / T from the prefill, every token
    within 5 standard deviations of its binomial count."""
    _, tcfg, _, tparams = model
    T, N = 1.5, 4096
    eng = ServeEngine(tcfg, tparams, max_len=9, device="cpu")
    prompt = _prompts(tcfg, seed=8, shape=(1, 8))
    lg, _ = eng._prefill(torch.from_numpy(prompt))
    p = softmax_base2(lg[0, :tcfg.vocab_size] / T,
                      fold_log2e=True).double().numpy()
    first = eng.generate(np.repeat(prompt, N, axis=0), 1, temperature=T,
                         seed=11).tokens[:, 0]
    freq = np.bincount(first, minlength=tcfg.vocab_size) / N
    sd = np.sqrt(p * (1 - p) / N)
    assert (np.abs(freq - p) <= 5 * sd + 1.0 / N).all()
    assert p.max() < 0.5      # a spread distribution, not a near-argmax


def test_launcher_static_and_paged_emit_the_same_tokens(caplog):
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "12", "--max-new", "4"]
    assert launch_serve.parse_args(argv).engine == "static"
    seqs = {}
    for engine in ("static", "paged"):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve"):
            launch_serve.main(argv + ["--engine", engine, "--block-size",
                                      "8", "--num-blocks", "16"])
        seqs[engine] = [r.getMessage() for r in caplog.records
                        if r.getMessage().startswith("seq")]
        assert len(seqs[engine]) == 2
    assert seqs["static"] == seqs["paged"]
