"""The paper's tables and figures on the port against the JAX package.

* ``core/energy_model.py``: ``table4()`` and ``fig5_sweep()`` EQUAL (``==``)
  to the reference's at their defaults and at other arguments, and so are
  the unit and PE models they are built from; the ``table4_efficiency``
  and ``fig5_sweep`` scripts' model rows are the reference scripts' rows.
* ``table1_bitwidth_ablation.run()``: every row within 1e-6 of the
  reference's (``softermax_fixed`` is exact between the packages; only
  ``softmax_base2``'s ulps differ).
* The measured rows of ``fig1_breakdown`` and ``fig5_sweep`` run on the
  CPU with the reference's keys, finite and positive (CPU times: no
  statement about the card).
* The quickstart runs on the CPU; its printed kernel errors are under
  their bounds.
"""
import math

import numpy as np
import pytest

from benchmarks import fig1_breakdown as jax_fig1
from benchmarks import fig5_sweep as jax_fig5
from benchmarks import table1_bitwidth_ablation as jax_table1
from benchmarks import table4_efficiency as jax_table4
from repro.core import energy_model as jax_em
from repro_torch.benchmarks import (fig1_breakdown, fig5_sweep,
                                    table1_bitwidth_ablation,
                                    table4_efficiency)
from repro_torch.core import energy_model as em
from repro_torch.examples import quickstart


@pytest.mark.parametrize("kw", [{}, {"seq_len": 128, "width": 16},
                                {"seq_len": 4096, "width": 64}])
def test_table4_equals_reference(kw):
    assert em.table4(**kw) == jax_em.table4(**kw)


@pytest.mark.parametrize("kw", [{}, {"widths": (8, 64),
                                     "seq_lens": (64, 384, 8192)}])
def test_fig5_sweep_equals_reference(kw):
    assert em.fig5_sweep(**kw) == jax_em.fig5_sweep(**kw)


@pytest.mark.parametrize("name", ["baseline_unnormed_unit",
                                  "softermax_unnormed_unit",
                                  "baseline_norm_unit",
                                  "softermax_norm_unit"])
@pytest.mark.parametrize("rows, V, width", [(384, 384, 32), (7, 100, 16)])
def test_unit_models_equal_reference(name, rows, V, width):
    a = getattr(em, name)(rows, V, width)
    b = getattr(jax_em, name)(rows, V, width)
    assert (a.energy_uj, a.area_um2, a.breakdown) == \
        (b.energy_uj, b.area_um2, b.breakdown)


@pytest.mark.parametrize("softmax", ["baseline", "softermax"])
def test_pe_costs_equal_reference(softmax):
    cfg = dict(vector_size=16, n_lanes=16, input_buffer_kb=16)
    a = em.pe_costs(512, softmax, em.PEConfig(**cfg))
    b = jax_em.pe_costs(512, softmax, jax_em.PEConfig(**cfg))
    assert (a.energy_uj, a.area_um2, a.breakdown) == \
        (b.energy_uj, b.area_um2, b.breakdown)
    with pytest.raises(ValueError):
        em.pe_costs(512, "other")


def test_table4_and_fig5_scripts_match_reference(capsys):
    assert table4_efficiency.run() == jax_table4.run()
    assert fig5_sweep.run_model() == jax_fig5.run_model()
    table4_efficiency.main()
    ours = capsys.readouterr().out
    jax_table4.main()
    assert ours == capsys.readouterr().out and ours.count("table4,") == 3


def test_table1_ablation_rows_match_reference():
    rows = table1_bitwidth_ablation.run(device="cpu")
    jrows = jax_table1.run()
    assert len(rows) == len(jrows) == 18
    for r, j in zip(rows, jrows):
        assert (r["out_bits"], r["unnormed_bits"]) == \
            (j["out_bits"], j["unnormed_bits"])
        assert r["max_err"] == pytest.approx(j["max_err"], abs=1e-6)
        assert r["mean_err"] == pytest.approx(j["mean_err"], abs=1e-6)


def test_measured_rows_run_on_cpu_with_the_reference_keys():
    f1 = fig1_breakdown.run(seq_lens=(128,), device="cpu")
    f5 = fig5_sweep.run_measured(seq_lens=(256,), device="cpu")
    jf5 = jax_fig5.run_measured(seq_lens=(256,))
    # the reference's fig1 rows, by its source: its run() takes no sizes
    jf1_keys = {"seq_len", "matmul_us", "softmax_e_us", "softermax_us",
                "softmax_frac_baseline", "softmax_frac_softermax"}
    assert "softmax_frac_softermax" in open(jax_fig1.__file__).read()
    assert set(f1[0]) == jf1_keys and set(f5[0]) == set(jf5[0])
    for row in f1 + f5:
        assert all(math.isfinite(v) and v > 0 for v in row.values())
    assert 0 < f1[0]["softmax_frac_baseline"] < 1


def test_fig5_rows_are_the_reference_inputs():
    x = fig5_sweep.rows_for(256, "cpu").numpy()
    want = np.asarray(np.random.default_rng(0).normal(size=(64, 256)),
                      np.float32) * 4
    np.testing.assert_array_equal(x, want)


def test_quickstart_on_cpu(capsys):
    errs = quickstart.run("cpu")
    out = capsys.readouterr().out
    assert errs["kernel"] <= 1e-6 and errs["flash"] <= 1e-5
    assert f"kernel max err: {errs['kernel']}" in out
    assert "full_pe: area×0.90 energy×0.46 (paper ×0.90/×0.43)" in out
