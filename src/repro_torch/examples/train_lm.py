"""End-to-end training example: train an LM with Softermax attention — the
JAX package's ``examples/train_lm.py`` on the port.

Default: a ~100M-param llama-family model for a few hundred steps (the
deliverable-(b) configuration):

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \
        --steps 300

CI-sized run (reduced llama3.2-3b), on the CPU's plain versions:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny \
        --steps 40 --device cpu

Runs on the CUDA card by default (``--device cpu`` for the CPU). Weights
are random, drawn from ``torch.Generator(device).manual_seed(0)``; batches
come from the numpy ``SyntheticLMData`` (seed 0), the reference's tokens.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import num_params
from repro_torch.train import make_train_step, train
from repro_torch.utils.device import resolve_device

PRESETS = {
    # ~103M params (tied embeddings), llama-style
    "100m": ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000,
        tie_embeddings=True, softmax_impl="softermax",
        compute_dtype="float32"),
    "tiny": reduce_config(get_config("llama3.2-3b")),
}


def main(argv=None) -> dict:
    """Trains and prints the loss line; returns ``train``'s output (params,
    opt_state, history: one loss a step, straggler_flags)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--softmax", default="softermax",
                    choices=["softmax", "base2", "softermax",
                             "softermax_fixed"])
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = PRESETS[args.preset].replace(softmax_impl=args.softmax)
    fns = model_fns(cfg)
    params = fns.init(torch.Generator(device=device).manual_seed(0))
    print(f"model: {cfg.name}  params={num_params(fns.schema)/1e6:.1f}M  "
          f"softmax={cfg.softmax_impl}  device={device}")

    tc = TrainConfig(total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     learning_rate=3e-4 if args.preset == "100m" else 3e-3,
                     checkpoint_every=max(args.steps // 3, 1))
    data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch, seed=0)
    out = train(train_step=make_train_step(fns.loss, tc), params=params,
                data=data, tc=tc, ckpt_dir=args.ckpt_dir,
                log_every=max(args.steps // 20, 1))
    h = out["history"]
    print(f"loss: {h[0]:.4f} -> {h[-1]:.4f} over {len(h)} steps")
    return out


if __name__ == "__main__":
    main()
