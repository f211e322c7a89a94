"""Checkpoint manager: atomic, retained, device-agnostic restore.

The JAX package's on-disk contract: the full train state (params,
optimizer m/v/step, data-iterator state, metadata) is flattened to
path-keyed arrays (dict keys joined by ``//``, a dataclass's fields by
position — an ``AdamWState`` as ``0`` = m, ``1`` = v, ``2`` = step),
written as ``arrays.npz`` plus ``meta.json`` into
a temp dir, then atomically renamed to ``step_<n>``. A retention policy
prunes old checkpoints. Writes go through a background thread so the
train loop is not blocked (async checkpointing).

The port updates parameters in place, so ``save`` copies every tensor to
host memory before it returns; only the file write is asynchronous.
bfloat16 tensors are stored as float32 (exact) and cast back on restore.

Restore: arrays are loaded on the host and moved to each template leaf's
device and dtype, or to the ``device`` the caller names — a checkpoint
written on the card restores onto the CPU unchanged, and back.

Placed trees (DTensors): ``save`` writes each leaf's global array
(``full_tensor()``, a collective every rank joins; rank 0 alone writes),
and ``restore(shardings=)`` places each restored tree by a same-structure
tree of ``parallel.sharding.NamedSharding``s. The arrays on disk do not
depend on the mesh, so a checkpoint saved on 8 ranks restores on 1, and
one saved on 1 restores on 8.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import distribute
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.checkpoint")

_SEP = "//"


def _children(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(str(i), getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree, path=()) -> Dict[str, np.ndarray]:
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(path): _host_array(tree)}
    flat = {}
    for key, child in kids:
        flat.update(_flatten(child, path + (key,)))
    return flat


def _unflatten_into(template, flat: Dict[str, np.ndarray], device,
                    path=()):
    kids = _children(template)
    if kids is None:
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if hasattr(template, "shape") and \
                tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(template.shape)}")
        if isinstance(template, torch.Tensor):
            dev = template.device if device is None else device
            return torch.from_numpy(np.array(arr)).to(dev, template.dtype)
        return arr
    values = [_unflatten_into(child, flat, device, path + (key,))
              for key, child in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), values))
    return dataclasses.replace(template, **{
        f.name: v for f, v in zip(dataclasses.fields(template), values)})


def _place(tree, shardings):
    """``tree`` with each tensor leaf distributed by the matching leaf of
    the same-structure ``shardings`` (a None leaf stays as it is)."""
    if shardings is None:
        return tree
    kids = _children(tree)
    if kids is None:
        return distribute(tree, shardings)
    values = [_place(child, sub) for (_, child), (_, sub) in
              zip(kids, _children(shardings))]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    return dataclasses.replace(tree, **{
        f.name: v for f, v in zip(dataclasses.fields(tree), values)})


def _is_placed(tree) -> bool:
    kids = _children(tree)
    if kids is None:
        return isinstance(tree, DTensor)
    return any(_is_placed(c) for _, c in kids)


def _is_metadata(tree) -> bool:
    kids = _children(tree)
    if kids is None:
        return isinstance(tree, (int, float, str, bool, type(None)))
    return all(_is_metadata(c) for _, c in kids)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any],
             extra_meta: Optional[Dict] = None) -> None:
        """state: {"params": tree, "opt": AdamWState, "data": dict, ...}.
        A state holding DTensors is gathered on every rank and written by
        rank 0 alone."""
        flat: Dict[str, np.ndarray] = {}
        placed = any(_is_placed(t) for t in state.values())
        meta = {"step": int(step), "keys": {}, **(extra_meta or {})}
        for name, tree in state.items():
            if _is_metadata(tree):
                meta[name] = tree   # plain metadata (data-iterator state)
                continue
            sub = _flatten(tree)
            meta["keys"][name] = sorted(sub.keys())
            flat.update({f"{name}{_SEP}{k}": v for k, v in sub.items()})

        self.wait()  # one in-flight save at a time
        if placed and dist.is_initialized() and dist.get_rank() != 0:
            return

        def _write():
            try:
                t0 = time.time()
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                final = os.path.join(self.dir, f"step_{step:08d}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._retain()
                log.info("saved checkpoint step=%d (%.2fs)", step,
                         time.time() - t0)
            except BaseException as e:  # surfaced on next wait()/save()
                self._exc = e

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, templates: Dict[str, Any],
                shardings: Optional[Dict[str, Any]] = None,
                device=None) -> Dict[str, Any]:
        """templates: same-structure trees (tensors give shape, dtype and
        device). Tensors land on ``device`` when given, else on their
        template's device; ``shardings``: optional same-structure trees of
        ``NamedSharding`` per name, by which each restored tree is placed
        (mesh-agnostic restore)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        out: Dict[str, Any] = {"meta": meta}
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            for name, template in templates.items():
                if name in meta and name not in meta["keys"]:
                    out[name] = meta[name]
                    continue
                prefix = f"{name}{_SEP}"
                flat = {k[len(prefix):]: npz[k] for k in npz.files
                        if k.startswith(prefix)}
                tree = _unflatten_into(template, flat, device)
                if shardings and shardings.get(name) is not None:
                    tree = _place(tree, shardings[name])
                out[name] = tree
        return out
