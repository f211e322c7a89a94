"""Beyond-paper ablation of the Table-I bitwidths — the JAX package's
``benchmarks/table1_bitwidth_ablation.py`` on the port.

The paper fixes one operating point (Inp Q(6,2), Unnormed Q(1,15), PowSum
Q(10,6), Recip/Outp Q(1,7)). This sweep varies the output/reciprocal and
unnormed precisions and reports the error of ``softermax_fixed`` against
the exact base-2 softmax — the accuracy-per-bit curve a hardware team
would use to re-cost the units.

    PYTHONPATH=src python -m repro_torch.benchmarks.table1_bitwidth_ablation \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.core.softermax as sm
from repro_torch.core import quant
from repro_torch.utils.device import resolve_device


def run(rows=256, V=384, seed=0, device="cuda"):
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(rows, V)) * 4, dtype=torch.float32,
                        device=device)
    exact = sm.softmax_base2(x)
    out = []
    for out_frac in (4, 5, 6, 7, 8, 10):
        for un_frac in (7, 11, 15):
            bw = quant.SoftermaxBitwidths(
                unnormed=quant.QFormat(1, un_frac, signed=False),
                recip=quant.QFormat(1, out_frac, signed=False),
                outp=quant.QFormat(1, out_frac, signed=False),
            )
            y = sm.softermax_fixed(x, bitwidths=bw)
            diff = (y - exact).abs()
            out.append({
                "out_bits": 1 + out_frac, "unnormed_bits": 1 + un_frac,
                "max_err": float(diff.max()), "mean_err": float(diff.mean()),
            })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    for r in run(device=args.device):
        print(f"table1_ablation,out_bits={r['out_bits']},"
              f"unnormed_bits={r['unnormed_bits']},"
              f"max_err={r['max_err']:.5f},mean_err={r['mean_err']:.6f}")


if __name__ == "__main__":
    main()
