"""The port's serving benches on the CPU.

``repro_torch.benchmarks.decode_paged_bench`` and ``autotune_bench`` run in
``--smoke`` mode with ``--device cpu`` (the plain versions of K1 and K8;
kernel parity and the engines' greedy equality gated, speed not), writing
nothing. The autotune bench's full mode writes its record into
``tmp_path``, stamped by the port's provenance header.

The autotune bench's trajectory, per-step decisions and modeled totals
against the JAX bench's (``benchmarks/autotune_bench.py``) for the same
arguments: the trajectory and every decision EXACTLY equal; every total
EXACTLY the correctly rounded sum (``math.fsum``) of the reference's
per-step values, which both benches compute bit for bit alike. The
reference accumulates its static totals with ``+=`` and its per-step total
with ``sum()`` (compensated since Python 3.12), so its own totals may sit
an ulp off those sums: held to 1e-12 relative.
"""
import json
import math

import numpy as np
import pytest

from benchmarks import autotune_bench as jax_bench
from repro.serve.kernel_costs import (CostParams, decode_launch_cost,
                                      estimate_seconds)
from repro_torch.benchmarks import autotune_bench, decode_paged_bench


def test_decode_bench_smoke_on_cpu(tmp_path, capsys):
    out = tmp_path / "decode.json"
    ratio = decode_paged_bench.main(["--smoke", "--device", "cpu", "--out",
                                     str(out)])
    assert ratio > 0 and not out.exists()
    lines = capsys.readouterr().out.splitlines()
    assert "decode_paged_bench,engine,greedy_equal,1" in lines
    assert "mode,cpu-plain" in lines[3]


def test_autotune_bench_smoke_on_cpu(tmp_path, capsys):
    out = tmp_path / "autotune.json"
    ratio = autotune_bench.main(["--smoke", "--device", "cpu", "--out",
                                 str(out)])
    assert ratio >= 1.0 and not out.exists()
    assert "autotune_bench,engine,greedy_equal,1" in \
        capsys.readouterr().out.splitlines()


def test_autotune_bench_full_mode_writes_its_record(tmp_path):
    out = tmp_path / "autotune.json"
    ratio = autotune_bench.main(["--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert ratio > 1.0 and rec["ratio_best_static_over_per_step"] == ratio
    prov = rec["provenance"]
    assert prov["measurement_mode"] == "analytic-cost-model"
    assert prov["card_name"] is None and prov["card_power_limit"] is None
    assert {"git_commit", "timestamp_utc", "torch_version", "cuda_version",
            "platform", "python"} <= set(prov)
    assert rec["greedy_equal"] is True and rec["engine_device"] == "cpu"


@pytest.mark.parametrize("argv", [["--smoke"], []], ids=["smoke", "full"])
def test_autotune_model_matches_jax_bench(argv):
    args = autotune_bench.parse_args(argv + ["--device", "cpu"])
    steps = autotune_bench.trajectory(args)
    jsteps = jax_bench._trajectory(args)
    assert len(steps) == len(jsteps)
    for (ln, w), (jln, jw) in zip(steps, jsteps):
        assert w == jw and np.array_equal(ln, jln)

    best, best_tot, per_tot, static_tot, decisions, _ = \
        autotune_bench.model_costs(args, steps)
    jbest, jbest_tot, jper_tot, jstatic_tot, jdecisions, _ = \
        jax_bench._model_costs(args, jsteps)
    assert best == jbest and decisions == jdecisions
    assert sorted(static_tot) == sorted(jstatic_tot)

    # the reference's per-step values, recomputed with its own model
    shape = dict(n_q_heads=args.hq, n_kv_heads=args.hkv,
                 head_dim=args.head_dim, block_size=args.block_size,
                 kv_dtype=args.kv_dtype)
    jparams = CostParams(cores=args.cores, flops_per_s=args.flops_per_s)
    per_cand = {c: [estimate_seconds(decode_launch_cost(
        ln, w, kv_tile_blocks=c[0], split_k=c[1], **shape), jparams)
        for ln, w in jsteps] for c in jstatic_tot}
    for c, tot in static_tot.items():
        assert tot == math.fsum(per_cand[c])
        assert tot == pytest.approx(jstatic_tot[c], rel=1e-12)
    assert per_tot == math.fsum(min(v[i] for v in per_cand.values())
                                for i in range(len(jsteps)))
    assert per_tot == pytest.approx(jper_tot, rel=1e-12)
    assert best_tot / per_tot == pytest.approx(jbest_tot / jper_tot,
                                               rel=1e-12)
