"""Hymba hybrid mixer: parallel attention heads and Mamba (selective SSM)
heads — the JAX package's ``repro.models.hymba`` in PyTorch.

Each layer runs a sliding-window GQA attention branch (with Softermax)
beside a Mamba branch on the same normed input; the branch outputs are
RMS-normalized and averaged. Decode keeps the attention branch's K/V in a
ring buffer of the window's size (``attention_decode(..., ring=True)``)
and the SSM's state and the causal conv's last inputs per layer.

The selective scan runs in fp32 as a loop over time (the reference's
``lax.scan``), each step in the reference's order: ``h = h · exp(dt·A) +
(dt·u) ⊗ B``, then ``y = h · C``. The step's elementwise factors are
formed for every time step at once before the loop (the same values),
and the readout ``y`` is one product over the stacked states after it.
The loop takes its steps from ``unbind``: autograd turns ``decay[:, t]``
into a zero gradient of the whole (B, S, di, st) tensor per step, which
makes a training step's backward quadratic in S (4096 steps of 839 MB at
hymba-1.5b's width); ``unbind``'s backward stacks the S slices once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dtensor import run_local
from repro_torch.kernels.observe import call_plain
from repro_torch.models.attention import (attention_apply, attention_decode,
                                         attention_schema)
from repro_torch.models.layers import rmsnorm, rmsnorm_schema
from repro_torch.models.schema import ParamSpec
from repro_torch.parallel.sharding import shard_act


def mamba_schema(cfg: ModelConfig):
    d = cfg.d_model
    ssm = cfg.ssm
    di = ssm.d_inner or 2 * d
    st = ssm.state
    dt_rank = max(16, d // 16)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "act_mlp")),
        "conv_w": ParamSpec((ssm.conv_width, di), ("conv", "act_mlp"),
                            std=0.2),
        "conv_b": ParamSpec((di,), ("act_mlp",), init="zeros"),
        "w_bc": ParamSpec((di, 2 * st), ("act_mlp", "state")),
        "dt_a": ParamSpec((di, dt_rank), ("act_mlp", None)),
        "dt_b": ParamSpec((dt_rank, di), (None, "act_mlp")),
        "dt_bias": ParamSpec((di,), ("act_mlp",), init="zeros"),
        "a_log": ParamSpec((di, st), ("act_mlp", "state"), init="zeros"),
        "d_skip": ParamSpec((di,), ("act_mlp",), init="ones"),
        "out_proj": ParamSpec((di, d), ("act_mlp", "embed")),
    }


def _causal_conv(u, w, b, conv_state=None):
    """Depthwise causal conv by shift-adds. u (B, S, di); w (cw, di);
    conv_state (B, cw-1, di): the previous raw inputs (decode continuity).
    Returns (out (B, S, di), the new conv state)."""
    B, S, di = u.shape
    cw = w.shape[0]
    prev = (torch.zeros((B, cw - 1, di), dtype=u.dtype, device=u.device)
            if conv_state is None else conv_state)
    ext = torch.cat([prev, u], dim=1)                 # (B, S+cw-1, di)
    out = torch.zeros_like(u)
    for i in range(cw):
        out = out + ext[:, i:i + S] * w[i]
    new_state = ext[:, -(cw - 1):] if cw > 1 else prev
    return out + b, new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``softplus`` turns
    linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def selective_scan(decay, dbu, h):
    """The loop over time: ``h = h · decay_t + dbu_t``. decay, dbu (B, S,
    di, st) fp32; h (B, di, st) the state before the first step. Returns
    (every step's state stacked (B, S, di, st), the final state)."""
    hs = []
    for a_t, b_t in zip(decay.unbind(1), dbu.unbind(1)):
        h = h * a_t + b_t
        hs.append(h)
    return torch.stack(hs, 1), h


_SCAN = ("batch", None, "mlp", None)    # (B, S, di, st)


def _ssm(decay, dbu, h, C_):
    """The scan and its read-out: (y (B, S, di) fp32, the final state)."""
    hs, h = selective_scan(decay, dbu, h)
    return (hs @ C_[..., None])[..., 0], h


def _ssm_like(decay, dbu, h, C_):
    """Empty outputs of ``_ssm``'s shapes and dtypes."""
    return decay.new_empty(decay.shape[:3]), h.new_empty(h.shape)


def mamba_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                ssm_state=None, conv_state=None, return_state=False):
    """x (B, S, d) → (B, S, d); with ``return_state`` also the final SSM
    state (B, di, st) fp32 and the conv state (B, cw-1, di)."""
    ssm = cfg.ssm
    dt_ = x.dtype
    B, S, d = x.shape
    di = ssm.d_inner or 2 * d
    st = ssm.state

    uz = x @ params["in_proj"].to(dt_)
    u, z = uz[..., :di], uz[..., di:]
    u_conv, new_conv = _causal_conv(u, params["conv_w"].to(dt_),
                                    params["conv_b"].to(dt_), conv_state)
    u_act = shard_act(F.silu(u_conv), ("batch", "seq", "act_mlp"))

    bc = u_act @ params["w_bc"].to(dt_)
    B_, C_ = bc[..., :st].float(), bc[..., st:].float()
    dt = softplus(torch.tanh(u_act @ params["dt_a"].to(dt_))
                  @ params["dt_b"].to(dt_)
                  + params["dt_bias"].to(dt_)).float()          # (B, S, di)
    A = -torch.exp(params["a_log"].float())                     # (di, st)

    decay = torch.exp(dt[..., None] * A)                        # (B,S,di,st)
    dbu = (dt * u_act.float())[..., None] * B_[:, :, None, :]
    h = (torch.zeros((B, di, st), dtype=torch.float32, device=x.device)
         if ssm_state is None else ssm_state)
    # the recurrence on local shards (batch, channels), the time axis whole
    # (``kernels/dtensor.py``)
    y, h = run_local(lambda *t: call_plain("selective_scan", _ssm, *t,
                                           like=_ssm_like),
                     (decay, dbu, h, C_), (_SCAN,) * 2 + (
        ("batch", "mlp", None), ("batch", None, None)),
        keep=("batch", "mlp"),
        out_axes=(("batch", None, "mlp"), ("batch", "mlp", None)))
    y = y.to(dt_)                                               # (B,S,di)
    y = y + u_act * params["d_skip"].to(dt_)
    y = y * F.silu(z)
    out = y @ params["out_proj"].to(dt_)
    if return_state:
        return out, h, new_conv
    return out


def hymba_mixer_schema(cfg: ModelConfig):
    return {
        "attn": attention_schema(cfg),
        "mamba": mamba_schema(cfg),
        "attn_norm": rmsnorm_schema(cfg.d_model),
        "mamba_norm": rmsnorm_schema(cfg.d_model),
    }


def combine(params, a, m, cfg: ModelConfig):
    """The two branches' outputs, each RMS-normalized, averaged."""
    return 0.5 * (rmsnorm(params["attn_norm"], a, cfg.norm_eps) +
                  rmsnorm(params["mamba_norm"], m, cfg.norm_eps))


def hymba_mixer_apply(params, x, cfg: ModelConfig, *, positions):
    a = attention_apply(params["attn"], x, cfg, positions=positions,
                        causal=True, window=cfg.window)
    m = mamba_apply(params["mamba"], x, cfg)
    return combine(params, a, m, cfg)


def hymba_mixer_decode(params, x1, cfg: ModelConfig, *, cache_k, cache_v,
                       cache_len, ssm_state, conv_state, rope_cs=None):
    """One token, x1 (B, d). The attention branch writes its K/V row into
    the ring buffer in place; returns (y1, cache_k, cache_v, the new SSM
    state, the new conv state)."""
    a1, new_k, new_v = attention_decode(
        params["attn"], x1, cfg, cache_k=cache_k, cache_v=cache_v,
        cache_len=cache_len, window=cfg.window, ring=True, rope_cs=rope_cs)
    m1, new_h, new_conv = mamba_apply(
        params["mamba"], x1[:, None, :], cfg, ssm_state=ssm_state,
        conv_state=conv_state, return_state=True)
    return combine(params, a1, m1[:, 0], cfg), new_k, new_v, new_h, new_conv
