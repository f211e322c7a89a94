"""Softermax-aware finetuning (§III, Table III workflow) — the JAX
package's ``examples/softermax_finetune.py`` on the port.

Pretrain with standard softmax → swap in the bit-faithful fixed-point
softermax (Table-I Q-formats, STE backward) → finetune → compare eval loss
against the no-finetune drop-in. Demonstrates the paper's central accuracy
claim: the finetuned fixed-point model recovers baseline quality. The
variants' table and the two summary numbers are what
``repro_torch.benchmarks.table3_accuracy.report`` renders.

    PYTHONPATH=src python -m repro_torch.examples.softermax_finetune \
        [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.table3_accuracy import report, run


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    text = report(run(pretrain_steps=60, finetune_steps=40,
                      device=args.device))
    print(text)
    return text


if __name__ == "__main__":
    main()
