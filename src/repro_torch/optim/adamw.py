"""AdamW with decoupled weight decay, global-norm clipping, LR schedule.

The JAX package's functional optimizer, with the state ``{m, v, step}``
mirroring the parameter tree (stacked layer leaves, so weight decay follows
the reference's rule: every leaf of rank ≥ 2 — block norm scales
``(n_layers, d)`` included — is decayed; only ``final_norm`` is not).

Unlike the reference, the update runs **in place**: at full width the f32
parameters, gradients, m and v take 12.85 GB each (llama3.2-3b), so a
fresh copy of the gradient tree for the clip, or a handful of fresh
temporaries per leaf, would not fit beside them on one 80 GB card. The
order of operations is the reference's; the schedule and the bias
corrections are computed in fp32 on the host and enter as fp32 scalars.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.schema import tree_leaves, tree_map


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    step: torch.Tensor           # 0-d int32, on the host


def init_state(params) -> AdamWState:
    return AdamWState(m=tree_map(torch.zeros_like, params),
                      v=tree_map(torch.zeros_like, params),
                      step=torch.zeros((), dtype=torch.int32))


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to 10%, in fp32 (``step`` int32)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - tc.warmup_steps) /
                       max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32)
                               * frac))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` **in place** to a global norm of at most
    ``max_norm``. Returns (grads, the norm before clipping, fp32 0-d)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(n)) for n in
                        torch._foreach_norm([g.float() for g in leaves])))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    torch._foreach_mul_(leaves, scale)
    return grads, gn


def _f32(x) -> float:
    """A value rounded to fp32, as a Python float (an exact fp32 scalar)."""
    return torch.as_tensor(x, dtype=torch.float32).item()


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, tc: TrainConfig
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, updating ``params``, ``state.m``, ``state.v`` and
    ``grads`` (clipped) in place. Returns (params, state, {"lr",
    "grad_norm"})."""
    grads, gn = clip_by_global_norm(grads, tc.grad_clip)
    step = state.step.to("cpu") + 1
    lr = lr_schedule(tc, step)
    b1, b2 = tc.b1, tc.b2
    stepf = step.float()
    bc1 = _f32(1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
    bc2 = _f32(1 - torch.tensor(b2, dtype=torch.float32) ** stepf)
    lr_f = _f32(lr)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_(g, alpha=1 - b1)               # b1*m + (1-b1)*g
        v.mul_(b2).addcmul_(g, g, value=1 - b2)        # b2*v + (1-b2)*g*g
        u = torch.div(v, bc2).sqrt_().add_(1e-8)       # sqrt(vh) + eps
        u = torch.div(m, bc1).div_(u)                  # mh / (…)
        if p.dim() >= 2:  # decay matrices only (final_norm exempt)
            u.add_(p.float(), alpha=tc.weight_decay)
        if p.dtype == torch.float32:
            p.add_(u, alpha=-lr_f)                     # p - lr*u
        else:
            p.copy_(p.float().add_(u, alpha=-lr_f))
        del u
    state.step = step
    return params, state, {"lr": lr, "grad_norm": gn}
