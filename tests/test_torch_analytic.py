"""The port's analytic layer against the JAX package's, EXACTLY (``==`` on
Python numbers): the shape cells, ``cell_supported``, the FLOP and
parameter counts of ``launch/analytic.py`` and ``launch/roofline.py`` for
every architecture at full width and reduced (deepseek also with
``opt_mla_absorbed``) at every shape, ``Roofline.to_dict()`` under the TPU
entry for drawn fields, and ``abstract_params`` / ``model_fns(cfg).abstract``
/ ``input_specs`` leaf for leaf (keys, shapes, dtypes by name) for every
grid cell that runs, every tensor on the meta device."""
import dataclasses

import jax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import base as jax_base
from repro.launch import analytic as jax_analytic
from repro.launch import roofline as jax_roofline
from repro.models import registry as jax_registry
from repro_torch.configs import base
from repro_torch.launch import analytic, roofline
from repro_torch.models import registry
from repro_torch.models.schema import abstract_params, tree_leaves

ARCHS = jax_registry.ARCH_IDS
SHAPES = jax_base.ALL_SHAPES
SHAPE_NAMES = [s.name for s in SHAPES]
# (arch, reduced, absorbed): every arch full width and reduced; deepseek's
# MLA also in its absorbed (latent-space) form
VARIANTS = [(a, r, False) for a in ARCHS for r in (False, True)] + [
    ("deepseek-v2-236b", r, True) for r in (False, True)]


def _variant_id(v):
    arch, reduced, absorbed = v
    return arch + ("-reduced" if reduced else "") + \
        ("-absorbed" if absorbed else "")


def _configs(arch, reduced, absorbed):
    ref, port = jax_registry.get_config(arch), registry.get_config(arch)
    if reduced:
        ref = jax_registry.reduce_config(ref)
        port = registry.reduce_config(port)
    if absorbed:
        ref = ref.replace(opt_mla_absorbed=True)
        port = port.replace(opt_mla_absorbed=True)
    return ref, port


def _shapes(name):
    return ({s.name: s for s in SHAPES}[name],
            {s.name: s for s in base.ALL_SHAPES}[name])


def test_shape_cells_match():
    assert [dataclasses.astuple(s) for s in base.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in SHAPES]
    assert [s.is_decode for s in base.ALL_SHAPES] == \
        [s.is_decode for s in SHAPES]
    assert base.TRAIN_4K == base.ALL_SHAPES[0]
    assert (base.PREFILL_32K, base.DECODE_32K, base.LONG_500K) == \
        base.ALL_SHAPES[1:]
    assert registry.SUBQUADRATIC == jax_registry.SUBQUADRATIC


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_supported_matches(arch, shape):
    ref_s, port_s = _shapes(shape)
    assert registry.cell_supported(arch, port_s) == \
        jax_registry.cell_supported(arch, ref_s)


@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_param_counts_match(variant):
    ref, port = _configs(*variant)
    n_mm = analytic.matmul_param_count(port)
    assert type(n_mm) is int
    assert n_mm == jax_analytic.matmul_param_count(ref)
    n = roofline.active_params(port)
    assert type(n) is int and n == jax_roofline.active_params(ref)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_flop_counts_match(variant, shape):
    ref, port = _configs(*variant)
    ref_s, port_s = _shapes(shape)
    want = jax_analytic.analytic_flops(ref, ref_s)
    got = analytic.analytic_flops(port, port_s)
    assert type(got) is type(want) and got == want
    want = jax_roofline.model_flops(ref, ref_s)
    got = roofline.model_flops(port, port_s)
    assert type(got) is type(want) and got == want
    assert roofline.model_flops(port, port_s, n_params=12345) == \
        jax_roofline.model_flops(ref, ref_s, n_params=12345)


def test_the_tpu_entry_is_the_reference_and_the_default():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (jax_roofline.PEAK_FLOPS, jax_roofline.HBM_BW, jax_roofline.LINK_BW)
    assert (roofline.TPU_V5E.peak_flops, roofline.TPU_V5E.hbm_bw,
            roofline.TPU_V5E.link_bw) == (jax_roofline.PEAK_FLOPS,
                                          jax_roofline.HBM_BW,
                                          jax_roofline.LINK_BW)
    assert roofline.Roofline(0.0, 0.0, 0.0, 1, 0.0, {}).chip == \
        roofline.TPU_V5E
    h = roofline.H100_SXM
    assert (h.peak_flops, h.peak_flops_f32, h.hbm_bw, h.link_bw) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert h.peak("bfloat16") == 989e12 and h.peak("float32") == 67e12
    with pytest.raises(ValueError, match="float32"):
        roofline.TPU_V5E.peak("float32")


def test_a_roofline_against_the_h100():
    """Each term divides by the H100 entry's own rate."""
    r = roofline.Roofline(flops_per_chip=3e15, bytes_per_chip=1e13,
                          collective_per_chip=9e11, chips=2,
                          model_flops=1.978e15, collective_breakdown={},
                          analytic_flops=3.956e15, chip=roofline.H100_SXM)
    assert r.compute_s == 3.956e15 / 2 / 989e12
    assert r.memory_s == 1e13 / 3.35e12
    assert r.collective_s == 9e11 / 450e9
    assert r.dominant == "memory" and r.bound_s == r.memory_s
    assert r.roofline_fraction == 1.978e15 / (2 * 989e12) / r.memory_s
    assert r.useful_flops_ratio == 0.5


_finite = st.floats(min_value=0.0, max_value=1e24, allow_nan=False,
                    allow_infinity=False)


@settings(max_examples=60, deadline=None)
@given(flops=_finite, byts=_finite, coll=_finite, analytic=_finite,
       model=_finite, chips=st.integers(1, 1024),
       breakdown=st.dictionaries(st.sampled_from(
           ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"]), _finite))
def test_roofline_to_dict_matches_reference(flops, byts, coll, analytic,
                                            model, chips, breakdown):
    kw = dict(flops_per_chip=flops, bytes_per_chip=byts,
              collective_per_chip=coll, chips=chips, model_flops=model,
              collective_breakdown=breakdown, analytic_flops=analytic)
    ref = jax_roofline.Roofline(**kw)
    port = roofline.Roofline(**kw)
    assert port.to_dict() == ref.to_dict()
    assert list(port.to_dict()) == list(ref.to_dict())
    assert port.bound_s == ref.bound_s


@pytest.mark.parametrize("dtype", sorted(jax_roofline._DTYPE_BYTES) + ["x9"])
@pytest.mark.parametrize("dims", ["", "7", "3,5,128", "2,0,4"])
def test_shape_bytes_matches(dtype, dims):
    assert roofline.shape_bytes(dtype, dims) == \
        jax_roofline.shape_bytes(dtype, dims)


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_matches(kind):
    for out_b in (0, 1, 4096, 3 * 2 ** 31):
        for group in (1, 2, 3, 16, 512):
            got = roofline._wire_bytes(kind, out_b, group)
            want = jax_roofline._wire_bytes(kind, out_b, group)
            assert type(got) is type(want) and got == want


def _dtype_name(dt):
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else jax.numpy.dtype(dt).name


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _assert_same_specs(got, want):
    """Leaf for leaf: the same keys, shapes and dtype names; every port
    leaf a tensor on the meta device."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, torch.Tensor) and g.device.type == "meta", k
        assert tuple(g.shape) == tuple(w.shape), k
        assert _dtype_name(g.dtype) == _dtype_name(w.dtype), k


GRID_CELLS = [(a, s.name) for a in jax_registry.GRID_ARCHS for s in SHAPES
              if jax_registry.cell_supported(a, s) is None]


@pytest.mark.parametrize("arch", jax_registry.GRID_ARCHS)
def test_abstract_params_match(arch):
    ref, port = _configs(arch, False, False)
    fns = registry.model_fns(port)
    want = jax_registry.model_fns(ref).abstract()
    _assert_same_specs(fns.abstract(), want)
    for dtype in (torch.float32, torch.bfloat16):
        tree = abstract_params(fns.schema, dtype)
        assert all(x.dtype == dtype and x.is_meta
                   for x in tree_leaves(tree))


@pytest.mark.parametrize("arch,shape", GRID_CELLS)
def test_input_specs_match(arch, shape):
    ref, port = _configs(arch, False, False)
    ref_s, port_s = _shapes(shape)
    got = registry.input_specs(port, port_s)
    _assert_same_specs(got, jax_registry.input_specs(ref, ref_s))
    assert list(got) == list(jax_registry.input_specs(ref, ref_s))


def test_grid_cells_cover_the_skips():
    """Every grid arch runs three shapes; the two sub-quadratic ones four."""
    assert len(GRID_CELLS) == 3 * len(jax_registry.GRID_ARCHS) + 2
    assert {a for a, s in GRID_CELLS if s == "long_500k"} == \
        registry.SUBQUADRATIC
