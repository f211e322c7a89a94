"""Fault-tolerant training loop (the JAX package's ``repro.train.loop``).

Responsibilities beyond calling the step:

* **checkpoint/restart** — auto-resume from the latest checkpoint (params,
  optimizer, data-iterator position, step counter), placed as the live
  state is (``sharding_of``); periodic async saves.
* **straggler monitor** — per-step wall time EWMA + variance; steps slower
  than ``mean + k·σ`` are flagged and logged.
* **NaN guard** — a non-finite loss aborts with the last good checkpoint on
  disk (restart-safe).
* metrics logging.

The step updates parameters in place; the loop reads the loss back to the
host once per step (``float``), which also bounds the step's wall time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataState, SyntheticLMData
from repro_torch.models.schema import tree_map
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import sharding_of
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.train")


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags outliers ≥ mean + k·σ."""

    k: float = 4.0
    alpha: float = 0.1
    mean: float = 0.0
    var: float = 0.0
    warmup: int = 5
    _n: int = 0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self.mean = dt if self._n == 1 else (
                self.mean + (dt - self.mean) / self._n)
            return False
        sigma = max(self.var, 1e-12) ** 0.5
        is_straggler = dt > self.mean + self.k * sigma + 1e-9
        if is_straggler:
            self.flagged += 1
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return is_straggler


def train(
    *,
    train_step: Callable,
    params,
    data: SyntheticLMData,
    tc: TrainConfig,
    ckpt_dir: Optional[str] = None,
    opt_state: Optional[adamw.AdamWState] = None,
    hooks: Optional[Dict[str, Callable]] = None,
    log_every: int = 10,
) -> Dict[str, Any]:
    """Run to tc.total_steps with checkpoint/restart. Returns final state."""
    hooks = hooks or {}
    if opt_state is None:
        opt_state = adamw.init_state(params)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir, keep=tc.keep_checkpoints) \
        if ckpt_dir else None

    if mgr is not None and mgr.latest_step() is not None:
        step0 = mgr.latest_step()
        restored = mgr.restore(step0, {
            "params": params, "opt": opt_state,
            "data": data.state.to_dict(),
        }, shardings={"params": tree_map(sharding_of, params),
                      "opt": adamw.AdamWState(
                          m=tree_map(sharding_of, opt_state.m),
                          v=tree_map(sharding_of, opt_state.v), step=None)})
        params, opt_state = restored["params"], restored["opt"]
        data.restore(DataState.from_dict(restored["data"]))
        start_step = restored["meta"]["step"]
        log.info("resumed from checkpoint step=%d", start_step)

    monitor = StragglerMonitor()
    history = []
    for step in range(start_step, tc.total_steps):
        batch = next(data)
        if "pre_step" in hooks:
            hooks["pre_step"](step)
        t0 = time.time()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if monitor.observe(dt):
            log.warning("straggler: step %d took %.3fs (mean %.3fs)",
                        step, dt, monitor.mean)
        if not np.isfinite(loss):
            if mgr is not None:
                mgr.wait()
            raise FloatingPointError(
                f"non-finite loss at step {step}; last checkpoint preserved")
        history.append(loss)
        if step % log_every == 0:
            log.info("step %d loss %.4f lr %.2e gnorm %.3f (%.3fs)",
                     step, loss, float(metrics.get("lr", 0)),
                     float(metrics.get("grad_norm", 0)), dt)
        if mgr is not None and (step + 1) % tc.checkpoint_every == 0:
            mgr.save(step + 1, {
                "params": params, "opt": opt_state,
                "data": data.state.to_dict(),
            })
    if mgr is not None:
        mgr.save(tc.total_steps, {
            "params": params, "opt": opt_state,
            "data": data.state.to_dict(),
        })
        mgr.wait()
    return {"params": params, "opt_state": opt_state, "history": history,
            "straggler_flags": monitor.flagged}
