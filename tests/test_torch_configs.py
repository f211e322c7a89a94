"""The port's configs equal the JAX package's, field for field, for every
architecture and its reduced sibling (dtypes compared by name)."""
import dataclasses

import pytest

from repro.models.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.models.registry import GRID_ARCHS as JAX_GRID_ARCHS
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduce_config as jax_reduce_config
from repro_torch.models.registry import (ARCH_IDS, GRID_ARCHS, get_config,
                                         reduce_config)


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) \
            else v
    return out


def test_arch_ids_match():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert GRID_ARCHS == JAX_GRID_ARCHS


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match(arch, reduced):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jax_reduce_config(jcfg), reduce_config(tcfg)
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.head_dim_ == jcfg.head_dim_
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert str(tcfg.compute_dtype_).replace("torch.", "") == \
        jcfg.compute_dtype_.name
    assert str(tcfg.param_dtype_).replace("torch.", "") == \
        jcfg.param_dtype_.name
