"""Quickstart: the Softermax algorithm family, its kernels and the
paper's Table IV in a few seconds — the JAX package's
``examples/quickstart.py`` on the port.

On the CUDA card (the default) the row kernel K6 (``softermax_op``) and
the flash-attention kernel K3 (``flash_attention_op``) run against their
plain versions; with ``--device cpu`` both dispatchers take the plain
PyTorch versions.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.core.softermax as sm
from repro_torch.core import energy_model
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_op,
                                                 scale_queries)
from repro_torch.kernels.softermax import softermax_op
from repro_torch.utils.device import resolve_device


def run(device="cuda"):
    """Prints the walkthrough; returns the kernels' max errors against
    their plain versions as {"kernel": ..., "flash": ...}."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(4, 128)) * 5, dtype=torch.float32,
                        device=device)

    # 1. The Figure-3 progression: all variants agree (float); fixed point
    #    is within the paper's pre-finetuning error budget.
    print("softmax_e  :", sm.softmax_e(x)[0, :4].cpu().numpy())
    print("softermax  :", sm.softermax(x)[0, :4].cpu().numpy())
    print("fixed-point:", sm.softermax_fixed(x)[0, :4].cpu().numpy())
    print("max |softermax - softmax_2|:",
          float((sm.softermax(x) - sm.softmax_base2(x)).abs().max()))

    # 2. The row kernel (K6 on the card) vs the closed form.
    y = softermax_op(x)
    k_err = float((y - sm.softermax(x)).abs().max())
    print("kernel max err:", k_err)

    # 3. Flash attention with the softermax online recurrence (K3 on the
    #    card) vs the full-matrix oracle.
    def t(shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=device)

    q = scale_queries(t((1, 4, 128, 64)), 64, base2=True)
    k = t((1, 2, 128, 64))
    v = t((1, 2, 128, 64))
    o = flash_attention_op(q, k, v, causal=True)
    f_err = float((o - attention_ref(q, k, v, causal=True)).abs().max())
    print("flash-attn max err:", f_err)

    # 4. The hardware story (Table IV).
    for unit, r in energy_model.table4().items():
        print(f"{unit}: area×{r['area_ratio']:.2f} "
              f"energy×{r['energy_ratio']:.2f} "
              f"(paper ×{r['paper_area']:.2f}/×{r['paper_energy']:.2f})")
    return {"kernel": k_err, "flash": f_err}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default: the CUDA card)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
