"""RWKV6 "Finch" time mix and channel mix (attention-free): the JAX
package's ``repro.models.rwkv6`` in PyTorch.

There is no softmax in its token mixing, so Softermax does not apply
inside the layers (the serving logits' softmax still uses it). Per layer:

* token shift with a data-dependent lerp for the five targets (r, k, v,
  w, g), each ``mu_i + tanh(xx @ A_i) @ B_i`` (LoRA rank ``mix_lora``);
* the WKV6 recurrence per head (state n×n): ``y_t = r_t·(S + u⊙k_t⊗v_t)``,
  ``S ← diag(w_t)·S + k_t⊗v_t``, with the data-dependent decay
  ``w_t = exp(-exp(w0 + tanh(z_w @ Aw) @ Bw))``, in fp32 as a loop over
  time (the reference's ``lax.scan``), each step in the reference's order;
* per-head RMS norm of the output, a silu gate, the output projection;
* channel mix: a static-shift lerp, ``sigmoid(r') * (relu(k')² @ Wv')``.

Decode carries the shift states in the compute dtype and the WKV state in
fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dtensor import run_local
from repro_torch.kernels.observe import call_plain
from repro_torch.models.attention import proj_heads
from repro_torch.models.schema import ParamSpec
from repro_torch.parallel.sharding import shard_act

_MIX = 5  # r, k, v, w, g


def rwkv_time_schema(cfg: ModelConfig):
    d = cfg.d_model
    ssm = cfg.ssm
    n = ssm.head_size
    H = d // n
    r = ssm.mix_lora
    rd = ssm.decay_lora
    return {
        "mu": ParamSpec((_MIX, d), (None, "embed"), init="zeros"),
        "mix_a": ParamSpec((_MIX, d, r), (None, "embed", None), std=0.02),
        "mix_b": ParamSpec((_MIX, r, d), (None, None, "embed"), std=0.02),
        "wr": ParamSpec((d, H, n), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, H, n), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, H, n), ("embed", "heads", "head_dim")),
        "wg": ParamSpec((d, d), ("embed", "act_embed")),
        "w0": ParamSpec((d,), ("embed",), init="zeros"),
        "decay_a": ParamSpec((d, rd), ("embed", None), std=0.02),
        "decay_b": ParamSpec((rd, d), (None, "embed"), std=0.02),
        "u": ParamSpec((H, n), ("heads", "head_dim"), init="zeros"),
        "out_norm": ParamSpec((H, n), ("heads", "head_dim"), init="ones"),
        "wo": ParamSpec((d, d), ("embed", "act_embed")),
    }


def rwkv_channel_schema(cfg: ModelConfig):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("embed",), init="zeros"),
        "mu_r": ParamSpec((d,), ("embed",), init="zeros"),
        "wk": ParamSpec((d, ff), ("embed", "mlp")),
        "wv": ParamSpec((ff, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", "act_embed")),
    }


def _ddlerp(params, x, xx):
    """Data-dependent lerp for the five mix targets. x, xx (B, S, d) →
    (5, B, S, d)."""
    dt = x.dtype
    mu = params["mu"].to(dt)                         # (5, d)
    a = params["mix_a"].to(dt)                       # (5, d, r)
    b = params["mix_b"].to(dt)                       # (5, r, d)
    lo = torch.einsum("bsd,mdr->mbsr", xx, a)
    lo = torch.einsum("mbsr,mrd->mbsd", torch.tanh(lo), b)
    return x[None] + xx[None] * (mu[:, None, None, :] + lo)


def _decay(params, zw):
    """w_t in (0, 1), fp32: exp(-exp(w0 + tanh(zw @ Aw) @ Bw))."""
    dt = zw.dtype
    lo = torch.tanh(zw @ params["decay_a"].to(dt)) @ params["decay_b"].to(dt)
    return torch.exp(-torch.exp(params["w0"].float() + lo.float()))


def _head_norm(params, y, eps):
    """Per-head RMS norm in fp32, y (B, S, H, n), returned in y's dtype."""
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)
            * params["out_norm"].float()).to(y.dtype)


def _wkv_scan(r, k, v, w, u, state0):
    """The WKV6 recurrence. r, k, v, w (B, S, H, n), w the decays in (0, 1);
    u (H, n); state0 (B, H, n, n). Returns y (B, S, H, n), the final
    state."""
    S = state0
    ys = []
    uu = u[None, :, :, None]
    # unbind, not r[:, t]: see models/hymba.py (the backward stays linear)
    for r_t, k_t, v_t, w_t in zip(*(a.unbind(1) for a in (r, k, v, w))):
        kv = k_t[..., :, None] * v_t[..., None, :]           # (B, H, n, n)
        ys.append((r_t[..., None, :] @ (S + uu * kv)).squeeze(-2))
        S = w_t[..., :, None] * S + kv
    return torch.stack(ys, 1), S


def _wkv_like(r, k, v, w, u, state0):
    """Empty outputs of ``_wkv_scan``'s shapes and dtypes."""
    return r.new_empty(r.shape), state0.new_empty(state0.shape)


def _shifted(x, shift_state):
    """x_{t-1} - x_t over the sequence, the first step's predecessor
    ``shift_state`` (B, d) (zeros without one)."""
    B, _, d = x.shape
    prev = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
            if shift_state is None else shift_state[:, None])
    return torch.cat([prev, x[:, :-1]], dim=1) - x


def rwkv_time_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                    shift_state=None, wkv_state=None,
                    return_state: bool = False):
    """Time mix over a sequence, x (B, S, d); with ``return_state`` also the
    last input (the next shift state) and the final WKV state."""
    B, S, d = x.shape
    n = cfg.ssm.head_size
    H = d // n
    dt = x.dtype

    xx = _shifted(x, shift_state)
    # the mix's einsums on local batch shards (``kernels/dtensor.py``)
    mix = ("mu", "mix_a", "mix_b")
    act = ("batch", None, None)
    zr, zk, zv, zw, zg = run_local(
        lambda x_, xx_, *p: _ddlerp(dict(zip(mix, p)), x_, xx_),
        (x, xx, *(params[m] for m in mix)),
        (act, act, (None,) * 2, (None,) * 3, (None,) * 3),
        keep=("batch",), out_axes=((None,) + act,))
    r = proj_heads(zr, params["wr"].to(dt))               # (B, S, H, n)
    k = proj_heads(zk, params["wk"].to(dt))
    v = proj_heads(zv, params["wv"].to(dt))
    g = F.silu(zg @ params["wg"].to(dt))
    w = _decay(params, zw).reshape(B, S, H, n)

    state0 = (torch.zeros((B, H, n, n), dtype=torch.float32,
                          device=x.device)
              if wkv_state is None else wkv_state)
    args = (r.float(), k.float(), v.float(), w, params["u"].float(),
            state0)
    # the recurrence on local shards (batch, heads), the time axis whole
    # (``kernels/dtensor.py``)
    seq = ("batch", None, "heads", None)
    st = ("batch", "heads", None, None)
    y, state = run_local(
        lambda *t: call_plain("wkv_scan", _wkv_scan, *t, like=_wkv_like),
        args, (seq,) * 4 + (("heads", None), st), keep=("batch", "heads"),
        out_axes=(seq, st))
    y = _head_norm(params, y.to(dt), cfg.norm_eps)
    y = shard_act(y, ("batch", "seq", "act_heads", "head_dim"))
    out = (y.reshape(B, S, d) * g) @ params["wo"].to(dt)
    if return_state:
        return out, x[:, -1], state
    return out


def rwkv_time_decode(params, x1, cfg: ModelConfig, *, shift_state,
                     wkv_state):
    """One token's time mix, x1 (B, d). Returns (out (B, d), the new shift
    state, the new WKV state)."""
    out, new_shift, new_state = rwkv_time_apply(
        params, x1[:, None, :], cfg, shift_state=shift_state,
        wkv_state=wkv_state, return_state=True)
    return out[:, 0], new_shift, new_state


def rwkv_channel_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                       shift_state=None, return_state: bool = False):
    dt = x.dtype
    xx = _shifted(x, shift_state)
    xk = x + xx * params["mu_k"].to(dt)
    xr = x + xx * params["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ params["wk"].to(dt)))
    kk = shard_act(kk, ("batch", "seq", "act_mlp"))
    out = torch.sigmoid(xr @ params["wr"].to(dt)) * (kk @ params["wv"].to(dt))
    if return_state:
        return out, x[:, -1]
    return out


def rwkv_channel_decode(params, x1, cfg: ModelConfig, *, shift_state):
    out, new_shift = rwkv_channel_apply(
        params, x1[:, None, :], cfg, shift_state=shift_state,
        return_state=True)
    return out[:, 0], new_shift
