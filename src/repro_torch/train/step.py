"""Train step factory: per-layer gradient leaves, microbatch accumulation,
AdamW.

``make_train_step`` builds

    (params, opt_state, batch) → (params, opt_state, metrics)

over the JAX package's parameter tree (layer stacks on a leading
``(n_layers, …)`` axis). Autograd never sees the stacks: each step makes
one leaf per layer slice of every stacked tensor (``_grad_leaves``; views,
no copies) and sets its ``.grad`` to the matching slice of a stacked f32
gradient tree, so the backward accumulates each layer's gradient in place
where the optimizer reads it. Indexing the stack inside the layer loop
instead would make autograd build a zero gradient of the whole stack per
layer and leaf (28 x 2.8 GB for llama3.2-3b's FFN matrices).

* microbatching: the batch splits into ``tc.microbatches`` slices whose
  gradients accumulate in f32 (the parameters' dtype) and are divided by
  the count, as in the reference; the loss is their mean and the other
  metrics are the last slice's.
* the loss comes from the model (``registry.model_fns(cfg).loss``).

``make_ddp_train_step`` (data-parallel with int8 gradient compression)
waits for the port of ``parallel/``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.optim import adamw


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    t = p.detach().requires_grad_()
    t.grad = g
    return t


def _grad_leaves(params, grads):
    """Autograd leaves sharing storage with ``params``, their ``.grad`` the
    matching views of ``grads``; the ``blocks`` stack becomes a per-layer
    list (what ``models.schema.layer_params`` reads)."""
    out = {k: _map2(_leaf, params[k], grads[k]) for k in params
           if k != "blocks"}
    if "blocks" in params:
        n = tree_leaves(params["blocks"])[0].shape[0]
        out["blocks"] = [
            _map2(lambda p, g, i=i: _leaf(p[i], g[i]), params["blocks"],
                  grads["blocks"]) for i in range(n)]
    return out


def _batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            if not isinstance(v, torch.Tensor) else v.to(device)
            for k, v in batch.items()}


def make_loss_and_grad(loss_fn: Callable, tc: TrainConfig):
    def accumulate(params, batch):
        """(mean loss, last microbatch's metrics, gradients) over the whole
        batch; gradients in the parameters' layout and dtype."""
        device = tree_leaves(params)[0].device
        batch = _batch_to(batch, device)
        n = max(tc.microbatches, 1)
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} "
                             "microbatches")
        grads = tree_map(torch.zeros_like, params)
        leaves = _grad_leaves(params, grads)
        loss_sum, metrics = None, {}
        for i in range(n):
            mb = {k: v[i * (B // n):(i + 1) * (B // n)]
                  for k, v in batch.items()}
            loss, metrics = loss_fn(leaves, mb)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        if n > 1:
            torch._foreach_div_(tree_leaves(grads), n)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss_sum / n, metrics, grads

    return accumulate


def make_train_step(loss_fn: Callable, tc: TrainConfig):
    accumulate = make_loss_and_grad(loss_fn, tc)

    def train_step(params, opt_state: adamw.AdamWState, batch
                   ) -> Tuple[Any, adamw.AdamWState, Dict[str, Any]]:
        loss, metrics, grads = accumulate(params, batch)
        params, opt_state, info = adamw.apply_updates(
            params, grads, opt_state, tc)
        return params, opt_state, {"loss": loss, **metrics, **info}

    return train_step
