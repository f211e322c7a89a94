"""Provenance header of the port's benchmark artifacts.

Every ``BENCH_torch_*.json`` writer stamps its record with
``provenance()``: which commit produced it, when, on which torch/CUDA
build and card (name and power limit, as ``nvidia-smi`` prints them), and
in which measurement mode — so a CPU artifact cannot be mistaken for a
card measurement, and two card numbers are compared only at one power
limit.

The commit comes from the environment variable ``REPRO_GIT_COMMIT`` when
it is set and not empty, and only otherwise from ``git`` — a tree
unpacked with ``git archive`` has no ``.git``, so a run from such a copy
passes the commit it was made from, for example

    REPRO_GIT_COMMIT=$(git rev-parse HEAD) python -m \
        repro_torch.benchmarks.prefill_paged_bench
"""
from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Optional

import torch

ROOT = Path(__file__).resolve().parents[3]
COMMIT_ENV = "REPRO_GIT_COMMIT"


def git_commit() -> Optional[str]:
    """The commit named by ``REPRO_GIT_COMMIT``; else HEAD of the checkout
    (+ ``-dirty``), or None outside a repository."""
    passed = os.environ.get(COMMIT_ENV, "").strip()
    if passed:
        return passed
    try:
        head = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, check=True, cwd=ROOT).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True,
            text=True, timeout=10, check=True, cwd=ROOT).stdout.strip()
        return head + ("-dirty" if dirty else "")
    except Exception:
        return None


def card() -> Dict[str, Optional[str]]:
    """The card's ``name`` and ``power.limit`` from ``nvidia-smi``; both
    None on a machine without a card."""
    if not torch.cuda.is_available() or shutil.which("nvidia-smi") is None:
        return {"name": None, "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, limit = (x.strip() for x in
                   out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def provenance(mode: Optional[str] = None) -> Dict[str, object]:
    """The shared artifact header; ``mode`` is the bench's measurement
    mode ("cuda", "cpu-plain", "analytic-cost-model", ...)."""
    c = card()
    out: Dict[str, object] = {
        "git_commit": git_commit(),
        "timestamp_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "card_name": c["name"],
        "card_power_limit": c["power_limit"],
        "platform": platform.platform(),
        "python": sys.version.split()[0],
    }
    if mode is not None:
        out["measurement_mode"] = mode
    return out
