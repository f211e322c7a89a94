"""Training launcher: the dense LM through the fault-tolerant loop
(checkpoint/restart, straggler monitor) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        --steps 3 --batch 1 --seq 4096
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 3

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
versions instead (with ``--reduced`` for a CPU-sized model). Weights are
random, drawn from ``torch.Generator(device).manual_seed(0)``; batches come
from the numpy ``SyntheticLMData`` (seed 0). ``--production-mesh`` and
``--multi-pod`` need the port of ``parallel/`` and raise until then.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.models.registry import (GRID_ARCHS, get_config, model_fns,
                                         reduce_config)
from repro_torch.train import make_train_step, train
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.launch.train")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(GRID_ARCHS), default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU dev box)")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the production mesh (needs parallel/, not ported)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "--production-mesh / --multi-pod need the port of parallel/")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.optimized:
        cfg = cfg.with_opts(True)

    fns = model_fns(cfg)
    params = fns.init(torch.Generator(device=device).manual_seed(0))
    tc = TrainConfig(total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     learning_rate=args.lr,
                     microbatches=args.microbatches,
                     checkpoint_every=max(args.steps // 3, 1))
    data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch, seed=0)
    out = train(train_step=make_train_step(fns.loss, tc), params=params,
                data=data, tc=tc, ckpt_dir=args.ckpt_dir,
                log_every=max(args.steps // 20, 1))
    h = out["history"]
    log.info("done on %s: loss %.4f -> %.4f; stragglers flagged: %d",
             device, h[0], h[-1], out["straggler_flags"])
    return out


if __name__ == "__main__":
    main()
