"""Roofline table from dry-run artifacts (``artifacts/dryrun/<mesh>/*.json``,
or the folder ``DRYRUN_ART`` names), in the JAX package's format.

The counterpart of the reference's ``benchmarks/roofline_report.py``: one
row per (arch × shape × mesh) with the three terms (seconds), the dominant
one, MODEL_FLOPS over the analytic FLOPs and the roofline fraction. An
artifact's terms are rebuilt through the port's ``Roofline`` at the rates
of the chip it names (``chip``: the port's dry run writes ``H100 SXM``; a
reference artifact has none and is read at the TPU entry), with the
port's ``analytic_flops`` where it predates the analytic count. Run ``python -m repro_torch.benchmarks.roofline_report``; with
no artifacts it prints nothing.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.configs.base import ALL_SHAPES
from repro_torch.launch.analytic import analytic_flops
from repro_torch.launch.roofline import H100_SXM, TPU_V5E, Roofline
from repro_torch.models.registry import get_config

ART = os.environ.get("DRYRUN_ART", "artifacts/dryrun")
CHIPS = {c.name: c for c in (TPU_V5E, H100_SXM)}


def _upgrade(r):
    """The roofline terms at the rates of the artifact's ``chip`` (the TPU
    entry where it names none, as the reference's artifacts), with
    analytic FLOPs, computed for artifacts written before the analytic
    count existed (no recompile needed)."""
    if r.get("skipped"):
        return r
    rf = r["roofline"]
    af = rf.get("analytic_flops")
    if not af:
        shape = {s.name: s for s in ALL_SHAPES}[r["shape"]]
        af = analytic_flops(get_config(r["arch"]), shape)
    roof = Roofline(
        flops_per_chip=rf["flops_per_chip"],
        bytes_per_chip=rf["bytes_per_chip"],
        collective_per_chip=rf["collective_per_chip"],
        chips=rf["chips"],
        model_flops=rf["model_flops"],
        collective_breakdown=rf["collective_breakdown"],
        analytic_flops=af,
        chip=CHIPS[r.get("chip", TPU_V5E.name)],
    )
    r["roofline"] = roof.to_dict()
    return r


def load(mesh="16x16"):
    rows = []
    for path in sorted(glob.glob(os.path.join(ART, mesh, "*.json"))):
        with open(path) as f:
            rows.append(_upgrade(json.load(f)))
    return rows


def render(mesh="16x16"):
    lines = []
    for r in load(mesh):
        if r.get("skipped"):
            lines.append(f"roofline,{mesh},{r['arch']},{r['shape']},SKIP")
            continue
        rf = r["roofline"]
        lines.append(
            f"roofline,{mesh},{r['arch']},{r['shape']},"
            f"compute={rf['compute_s']:.4g}s,memory={rf['memory_s']:.4g}s,"
            f"collective={rf['collective_s']:.4g}s,dom={rf['dominant']},"
            f"useful={rf['useful_flops_ratio']:.3f},"
            f"frac={rf['roofline_fraction']:.4f}")
    return lines


def markdown_table(mesh="16x16"):
    out = ["| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | useful FLOPs ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in load(mesh):
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"SKIP | — | — |")
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4g} | "
            f"{rf['memory_s']:.4g} | {rf['collective_s']:.4g} | "
            f"{rf['dominant']} | {rf['useful_flops_ratio']:.3f} | "
            f"{rf['roofline_fraction']:.4f} |")
    return "\n".join(out)


def main():
    meshes = [m for m in ("16x16", "2x16x16")
              if os.path.isdir(os.path.join(ART, m))]
    if not meshes:
        return
    # the rows come from dry-run artifacts, not a fresh measurement: the
    # header says which checkout rendered them
    from repro_torch.benchmarks.provenance import provenance
    print("# provenance:",
          json.dumps(provenance(mode="dryrun-artifacts"), sort_keys=True))
    for mesh in meshes:
        for line in render(mesh):
            print(line)


if __name__ == "__main__":
    main()
