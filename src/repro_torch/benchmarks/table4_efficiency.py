"""Table IV: unit- and PE-level area/energy ratios from the analytical 7nm
model (``core/energy_model.py``), reported against the paper's measured
ratios — the JAX package's ``benchmarks/table4_efficiency.py`` on the
port. Pure arithmetic: no device.

    PYTHONPATH=src python -m repro_torch.benchmarks.table4_efficiency
"""
from __future__ import annotations

from repro_torch.core import energy_model


def run():
    return energy_model.table4(seq_len=384, width=32)


def main():
    for unit, r in run().items():
        print(f"table4,{unit},area={r['area_ratio']:.3f}"
              f"(paper {r['paper_area']:.2f}),"
              f"energy={r['energy_ratio']:.3f}(paper {r['paper_energy']:.2f})")


if __name__ == "__main__":
    main()
