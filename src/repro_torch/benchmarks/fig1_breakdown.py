"""Fig. 1 analogue: the softmax share of one attention layer's runtime
against sequence length — the JAX package's ``benchmarks/fig1_breakdown.py``
on the port.

The paper profiles BERT-Large on a Volta GPU and shows softmax growing to
a large share of runtime at long sequence lengths. This measures the
matmuls (QK^T + AV) against the softmax of one layer (H 16, D 64) across
sequence lengths, for the e-base baseline and for Softermax (base-2 +
IntMax, the closed form of ``core/softermax.py``), on the device (the
CUDA card by default), every timed call ended by a device synchronize.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_breakdown \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.core.softermax as sm
from repro_torch.utils.device import resolve_device, synchronize

H, D = 16, 64


def _time(f, *args, iters=3):
    dev = args[0].device
    f(*args)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        f(*args)
    synchronize(dev)
    return (time.perf_counter() - t0) / iters


def run(seq_lens=(128, 256, 512, 1024), device="cuda"):
    device = resolve_device(device)

    def mm1(q, k):
        return torch.einsum("bhqd,bhkd->bhqk", q, k)

    def mm2(p, v):
        return torch.einsum("bhqk,bhkd->bhqd", p, v)

    rows = []
    for S in seq_lens:
        rng = np.random.default_rng(0)
        q, k, v = (torch.as_tensor(rng.normal(size=(1, H, S, D)),
                                   dtype=torch.float32, device=device)
                   for _ in range(3))
        s = mm1(q, k)
        p = sm.softmax_e(s)
        t_mm = _time(mm1, q, k) + _time(mm2, p, v)
        t_soft_e = _time(sm.softmax_e, s)
        t_soft_2 = _time(sm.softermax, s)
        rows.append({
            "seq_len": S,
            "matmul_us": t_mm * 1e6,
            "softmax_e_us": t_soft_e * 1e6,
            "softermax_us": t_soft_2 * 1e6,
            "softmax_frac_baseline": t_soft_e / (t_soft_e + t_mm),
            "softmax_frac_softermax": t_soft_2 / (t_soft_2 + t_mm),
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    for r in run(device=args.device):
        print(f"fig1,seq={r['seq_len']},"
              f"{r['softmax_e_us']:.0f},"
              f"frac_baseline={r['softmax_frac_baseline']:.3f},"
              f"frac_softermax={r['softmax_frac_softermax']:.3f}")


if __name__ == "__main__":
    main()
