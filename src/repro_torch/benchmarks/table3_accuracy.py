"""Table III analogue: Softermax-aware finetuning recovers accuracy — the
JAX package's ``benchmarks/table3_accuracy.py`` (and the printout of
``examples/softermax_finetune.py``) on the port.

The paper finetunes BERT on GLUE/SQuAD with Softermax and reports parity
with the quantized baseline. Offline, the scaled proxy: pretrain a
BERT-family transformer (``causal=True``, the LM proxy task) with the
standard softmax on the synthetic LM task, then finetune three variants —
the standard softmax, Softermax (float) and ``softermax_fixed`` (the
bit-faithful Table-I fixed point with STE, through the naive attention
path: the fixed-point kernel K7 on the card) — and report their eval
losses, beside the fixed-point drop-in without finetuning.

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_accuracy
    PYTHONPATH=src python -m repro_torch.benchmarks.table3_accuracy \\
        --device cpu

The weights are random (from a seed); BERT's checkpoint and GLUE are not
in the repository, so the eval losses are of the synthetic task.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import SyntheticLMData
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.models.schema import tree_map
from repro_torch.optim import adamw
from repro_torch.train import make_train_step
from repro_torch.utils.device import resolve_device

SEQ, BATCH = 64, 16
VARIANTS = ("softmax", "softermax", "softermax_fixed")


def _eval_loss(fns, params, cfg: ModelConfig, *, seq: int, batch: int,
               n: int = 4, seed: int = 77) -> float:
    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=seed)
    device = params["final_norm"]["scale"].device
    tot = 0.0
    with torch.no_grad():
        for _ in range(n):
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
            loss, _ = fns.loss(params, b)
            tot += float(loss)
    return tot / n


def _copy(params):
    return tree_map(lambda a: a.clone(), params)


def finetune_variants(base_cfg: ModelConfig, params, *, pretrain_steps: int,
                      finetune_steps: int, seq: int = SEQ,
                      batch: int = BATCH):
    """The workflow of ``run`` on a given model and initial weights (left
    untouched: the optimizer updates copies in place). Returns the eval
    loss of each finetuned variant and of the fixed-point drop-in."""
    fns = model_fns(base_cfg)
    params = _copy(params)
    tc = TrainConfig(total_steps=pretrain_steps, warmup_steps=5,
                     learning_rate=3e-3)
    step = make_train_step(fns.loss, tc)
    data = SyntheticLMData(base_cfg.vocab_size, seq, batch, seed=1)
    opt = adamw.init_state(params)
    for _ in range(pretrain_steps):
        params, opt, _ = step(params, opt, next(data))
    del opt

    results = {}
    for impl in VARIANTS:
        cfg_i = base_cfg.replace(softmax_impl=impl)
        fns_i = model_fns(cfg_i)
        tc_f = TrainConfig(total_steps=finetune_steps, warmup_steps=2,
                           learning_rate=1e-3)
        step_i = make_train_step(fns_i.loss, tc_f)
        p_i = _copy(params)
        o_i = adamw.init_state(p_i)
        ft_data = SyntheticLMData(base_cfg.vocab_size, seq, batch, seed=2)
        for _ in range(finetune_steps):
            p_i, o_i, _ = step_i(p_i, o_i, next(ft_data))
        results[impl] = _eval_loss(fns_i, p_i, cfg_i, seq=seq, batch=batch)
        del p_i, o_i
    # the zero-shot drop-in (no softermax-aware finetuning), for contrast
    cfg_z = base_cfg.replace(softmax_impl="softermax_fixed")
    results["softermax_fixed_no_finetune"] = _eval_loss(
        model_fns(cfg_z), params, cfg_z, seq=seq, batch=batch)
    return results


def table3_config() -> ModelConfig:
    """Reduced bert-base as the LM proxy task, pretrained with softmax."""
    return reduce_config(get_config("bert-base")).replace(
        causal=True, softmax_impl="softmax")


def run(pretrain_steps: int = 60, finetune_steps: int = 40, device=None):
    """The reference's ``run()`` on ``device`` (the card by default), from
    the model's own init drawn from a ``torch.Generator`` seeded 0."""
    base_cfg = table3_config()
    params = model_fns(base_cfg).init(
        torch.Generator(device=resolve_device(device)).manual_seed(0))
    return finetune_variants(base_cfg, params, pretrain_steps=pretrain_steps,
                             finetune_steps=finetune_steps)


def report(results) -> str:
    """What ``examples/softermax_finetune.py`` prints."""
    base = results["softmax"]
    lines = [f"{'variant':38s} eval_loss   delta"]
    lines += [f"{k:38s} {v:9.4f}   {v - base:+.4f}"
              for k, v in results.items()]
    drop_in = results["softermax_fixed_no_finetune"] - base
    finetuned = results["softermax_fixed"] - base
    lines.append(f"\nfixed-point drop-in penalty: {drop_in:+.4f}; "
                 f"after softermax-aware finetuning: {finetuned:+.4f}")
    return "\n".join(lines)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(report(run(pretrain_steps=60, finetune_steps=40,
                     device=args.device)))


if __name__ == "__main__":
    main()
