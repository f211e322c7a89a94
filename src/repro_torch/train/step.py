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
* placed parameters (DTensors, ``parallel.sharding.place``): the batch is
  distributed by the ambient rules' ``("batch", "seq")`` spec, the
  forward and backward run under ``placed_scope`` (plain constants taken
  as replicated), and the metrics come back as plain tensors holding the
  global values. The layer stacks are never sharded, so a layer's slice
  is a view of each rank's shard. Plain parameters take none of this.

``make_ddp_train_step`` is the data-parallel step over a mesh's data axis:
replicated parameters, each rank's slice of the batch, gradients
all-reduced as int8 with error feedback (``tc.grad_compression``,
``parallel.collectives``) or as their mean.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import TrainConfig
from repro_torch.models.lm import STACKS
from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel.collectives import (axis_group,
                                              compressed_psum_tree,
                                              pmean_tree)
from repro_torch.parallel.sharding import (batch_sharding, distribute,
                                           placed_scope)


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    t = p.detach().requires_grad_()
    t.grad = g
    return t


def _grad_leaves(params, grads):
    """Autograd leaves sharing storage with ``params``, their ``.grad`` the
    matching views of ``grads``; each layer stack (``blocks`` and the MoE
    family's ``head_blocks``) becomes a per-layer list (what
    ``models.schema.layer_params`` reads)."""
    out = {k: tree_map(_leaf, params[k], grads[k]) for k in params
           if k not in STACKS}
    for name in STACKS:
        if name in params:
            n = tree_leaves(params[name])[0].shape[0]
            out[name] = [
                tree_map(lambda p, g, i=i: _leaf(p[i], g[i]), params[name],
                         grads[name]) for i in range(n)]
    return out


def _batch_to(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            if not isinstance(v, torch.Tensor) else v.to(device)
            for k, v in batch.items()}


def _distributed(mb):
    """A microbatch of placed parameters' step, distributed by
    ``batch_sharding`` under the ambient mesh (a DTensor, placed already,
    as it is)."""
    out = {}
    for k, v in mb.items():
        if isinstance(v, DTensor):
            out[k] = v
            continue
        sharding = batch_sharding(v.shape)
        if sharding is None:
            raise ValueError("placed parameters need the sharding_context "
                             "they were placed under")
        out[k] = distribute(v, sharding)
    return out


def _plain(x):
    """A metric as a plain tensor: a DTensor's global value."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_loss_and_grad(loss_fn: Callable, tc: TrainConfig):
    def accumulate(params, batch):
        """(mean loss, last microbatch's metrics, gradients) over the whole
        batch; gradients in the parameters' layout and dtype."""
        first = tree_leaves(params)[0]
        placed = isinstance(first, DTensor)
        batch = _batch_to(batch, first.device)
        n = max(tc.microbatches, 1)
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} "
                             "microbatches")
        grads = tree_map(torch.zeros_like, params)
        leaves = _grad_leaves(params, grads)
        loss_sum, metrics = None, {}
        with placed_scope() if placed else contextlib.nullcontext():
            for i in range(n):
                mb = batch if n == 1 else {
                    k: v[i * (B // n):(i + 1) * (B // n)]
                    for k, v in batch.items()}
                if placed:
                    mb = _distributed(mb)
                loss, metrics = loss_fn(leaves, mb)
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            if n > 1:
                torch._foreach_div_(tree_leaves(grads), n)
        metrics = {k: _plain(v.detach()) for k, v in metrics.items()}
        return _plain(loss_sum / n), metrics, grads

    return accumulate


def make_train_step(loss_fn: Callable, tc: TrainConfig):
    accumulate = make_loss_and_grad(loss_fn, tc)

    def train_step(params, opt_state: adamw.AdamWState, batch
                   ) -> Tuple[Any, adamw.AdamWState, Dict[str, Any]]:
        loss, metrics, grads = accumulate(params, batch)
        params, opt_state, info = adamw.apply_updates(
            params, grads, opt_state, tc)
        info = {k: _plain(v) for k, v in info.items()}
        return params, opt_state, {"loss": loss, **metrics, **info}

    return train_step


def make_ddp_train_step(loss_fn: Callable, tc: TrainConfig, mesh,
                        data_axis: str = "data"):
    """The data-parallel step ``(params, opt_state, errors, batch) →
    (params, opt_state, errors, metrics)`` over ``mesh``'s ``data_axis``.

    Every rank holds the same parameters and optimizer state and the whole
    batch; it computes gradients on its slice of the batch (rows
    ``[i·B/n, (i+1)·B/n)`` for its index i on the axis), the loss is their
    mean over the axis, and the gradients cross the axis as int8 codes with
    error feedback (``errors``, this rank's residuals, ride in the step's
    state) under ``tc.grad_compression``, else as their mean. Metrics:
    ``{"loss", **AdamW info}``, as in the reference."""
    accumulate = make_loss_and_grad(loss_fn, tc)
    group, index, n = axis_group(mesh, data_axis)

    def step(params, opt_state, errors, batch):
        local = {}
        for k, v in batch.items():
            B = v.shape[0]
            if B % n:
                raise ValueError(f"batch {B} does not split over {n} "
                                 f"ranks of '{data_axis}'")
            local[k] = v[index * (B // n):(index + 1) * (B // n)]
        loss, _, grads = accumulate(params, local)
        loss = pmean_tree(loss, group)
        if tc.grad_compression:
            grads, errors = compressed_psum_tree(grads, group, errors)
        else:
            grads = pmean_tree(grads, group)
        params, opt_state, info = adamw.apply_updates(
            params, grads, opt_state, tc)
        return params, opt_state, errors, {"loss": loss, **info}

    return step
