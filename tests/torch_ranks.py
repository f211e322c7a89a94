"""Multi-process runs for the port's ``parallel/`` tests on the CPU.

``run_ranks`` starts ``world`` Python processes that join one gloo process
group through a ``FileStore`` under the test's temporary directory (no
port is bound, so concurrent xdist workers cannot collide) and run the
same code; each saves its ``out`` dict with ``torch.save``. ``run_jax``
runs the reference's code in one process that sees 8 virtual CPU devices,
as the JAX package's own multi-device tests do. Both start without
waiting, so a file's reference and its ranks run side by side.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")

_PRELUDE = """
import datetime, os
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["STORE"], world), rank=rank,
    world_size=world, timeout=datetime.timedelta(seconds=240))
inp = dict(np.load(os.environ["IN"])) if os.environ.get("IN") else {}
out = {}
"""

_EPILOGUE = """
torch.save(out, os.path.join(os.environ["OUT"], f"rank{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
"""


class Run:
    """Started processes; ``wait`` checks every exit code."""

    def __init__(self, procs, outs=None):
        self.procs, self.outs = procs, outs

    def wait(self, timeout=600):
        errs = []
        for p in self.procs:
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                raise
            if p.returncode != 0:
                errs.append(err[-4000:])
        assert not errs, "\n".join(errs)
        if self.outs is None:
            return None
        return [torch.load(o, weights_only=False) for o in self.outs]


def run_ranks(code: str, world: int, tmp: Path, inputs=None) -> Run:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    src = _PRELUDE + textwrap.dedent(code) + _EPILOGUE
    procs = []
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
               "WORLD": str(world), "STORE": str(store), "OUT": str(tmp),
               "IN": str(inputs or ""), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, "-c", src], env=env,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE, text=True))
    return Run(procs, [tmp / f"rank{r}.pt" for r in range(world)])


def run_jax(code: str) -> Run:
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    return Run([subprocess.Popen([sys.executable, "-c",
                                  textwrap.dedent(code)], env=env,
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)])
