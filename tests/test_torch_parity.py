"""The rule that holds a kernel's output against its plain version
(``repro_torch.kernels.parity``): one bfloat16 rounding step anywhere
passes, a real error of a few percent of one element does not."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.parity import (BF16_RTOL, F32_ATOL, parity_error,
                                        tolerance)


def _values(seed=0):
    """bf16 values of both signs over nine decades."""
    rng = np.random.default_rng(seed)
    x = rng.choice([-1.0, 1.0], 4096) * 10.0 ** rng.uniform(-6, 3, 4096)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _one_step(x):
    """Every element moved one bf16 step away from zero."""
    return (x.view(torch.int16) + 1).view(torch.bfloat16)


def test_tolerances():
    assert tolerance(torch.float32) == F32_ATOL
    assert tolerance(torch.bfloat16) == BF16_RTOL


def test_one_bf16_step_everywhere_is_held():
    want = _values()
    err, held = parity_error(_one_step(want), want)
    assert err > 0 and held <= 2 ** -7 < BF16_RTOL


@pytest.mark.parametrize("where", [0, 1000, 4095])
def test_a_two_percent_error_in_one_bf16_element_fails(where):
    want = _values(1)
    want[where] = -0.3          # well above the floor that guards zeros
    got = want.clone()
    got[where] = want[where].float() * 1.02
    assert parity_error(got, want)[1] > BF16_RTOL


@pytest.mark.parametrize("delta,passes", [(5e-6, True), (2e-5, False)])
def test_float32_is_held_absolutely(delta, passes):
    want = _values(2).float()
    want[7] = 0.5
    got = want.clone()
    got[7] += delta
    err, held = parity_error(got, want)
    assert err == held == pytest.approx(delta, rel=1e-2)
    assert (held <= tolerance(torch.float32)) == passes
