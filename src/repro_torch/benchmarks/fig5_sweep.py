"""Fig. 5: PE energy against sequence length (16- and 32-wide) from the
analytical model, and the measured time of the two-pass e-base softmax
against the one-pass Softermax scan (the measurable half of the same
claim: one fused pass against max + exp + divide) — the JAX package's
``benchmarks/fig5_sweep.py`` on the port.

The measured rows time the plain functions of ``core/softermax.py`` on
the device (the CUDA card by default), each call ended by a device
synchronize; ``--device cpu`` times them on the CPU.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig5_sweep [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.core.softermax as sm
from repro_torch.core import energy_model
from repro_torch.utils.device import resolve_device, synchronize


def _time(f, x, iters=5):
    f(x)
    synchronize(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        f(x)
    synchronize(x.device)
    return (time.perf_counter() - t0) / iters


def run_model():
    return energy_model.fig5_sweep()


def rows_for(S: int, device) -> torch.Tensor:
    """The measured rows at one sequence length: 64 rows of N(0, 4^2)."""
    return torch.as_tensor(np.random.default_rng(0).normal(size=(64, S)),
                           dtype=torch.float32, device=device) * 4


def run_measured(seq_lens=(256, 512, 1024, 2048), device="cuda"):
    """Wall time: two-pass e-base softmax vs one-pass softermax scan."""
    device = resolve_device(device)
    rows = []
    one_pass = lambda x: sm.softermax_online_scan(x, block=512)  # noqa: E731
    for S in seq_lens:
        x = rows_for(S, device)
        rows.append({
            "seq_len": S,
            "two_pass_us": _time(sm.softmax_e, x) * 1e6,
            "softermax_us": _time(one_pass, x) * 1e6,
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device of the measured rows (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    for r in run_model():
        print(f"fig5_model,width={r['width']},seq={r['seq_len']},"
              f"baseline_uj={r['baseline_uj']:.2f},"
              f"softermax_uj={r['softermax_uj']:.2f},ratio={r['ratio']:.3f}")
    for r in run_measured(device=args.device):
        print(f"fig5_measured,seq={r['seq_len']},"
              f"two_pass_us={r['two_pass_us']:.1f},"
              f"softermax_us={r['softermax_us']:.1f}")


if __name__ == "__main__":
    main()
