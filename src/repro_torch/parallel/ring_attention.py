"""Ring attention with the Softermax online recurrence (the JAX package's
``repro.parallel.ring_attention``).

Sequence-parallel attention without materializing the full K/V on a rank:
each of the n ranks of the ``model`` axis owns a sequence shard; K/V
shards circulate the ring (``batch_isend_irecv`` to the next rank, from
the previous one) while every rank folds each visiting block into its
running (IntMax m, denominator d, accumulator) state: the online
normalization of the paper, here spanning ranks, every cross-block rescale
an exact power of two because the running max is kept integral. Each
block's transfer is posted before the fold of the block in hand, so the
two overlap.

The backward (``_Ring``, an autograd Function) runs the reverse ring: each
K/V block travels the other way together with its dK/dV accumulators,
every rank adding its queries' share from the final (m, d) it saved, and
after n steps the block and its gradients are home. The per-block products
are ``torch.matmul``, as the reference computes them outside any kernel.

``ring_attention`` takes the global q/k/v (as the reference's ``shard_map``
entry does), gives each rank its shards and returns the global output on
every rank; gradients follow ``parallel.collectives``' convention (the
global tensors' full gradients on every rank).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.numerics import NEG_INF
from repro_torch.launch.mesh import mesh_shape
from repro_torch.parallel.collectives import (axis_group, gather,
                                              group_peer, shard)

LN2 = math.log(2.0)


def _shift(tensors, group, index: int, n: int, step: int):
    """Post the send of ``tensors`` to the member ``step`` places on and
    the receive of the same shapes from ``step`` places back; returns
    (receive buffers, requests)."""
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      group_peer(group, (index + step) % n), group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, group_peer(group, (index - step) % n),
                       group) for r in recv]
    return recv, dist.batch_isend_irecv(ops)


def _scores(qg, k_b, q_pos, k_pos, causal):
    """fp32 scores (B, Hkv, G, Sq, Sk), NEG_INF where causally masked."""
    s = qg @ k_b[:, :, None].float().transpose(-1, -2)
    if causal:
        valid = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    return s


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, index, n, causal, intmax):
        B, Hq, S, D = q.shape
        Hkv = k.shape[1]
        qg = q.reshape(B, Hkv, Hq // Hkv, S, D).float()
        dev = q.device
        q_pos = index * S + torch.arange(S, device=dev)
        m = torch.full(qg.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                       device=dev)
        d = torch.zeros_like(m)
        acc = torch.zeros(qg.shape[:-1] + (v.shape[-1],),
                          dtype=torch.float32, device=dev)
        kv = (k, v)
        for step in range(n):
            if step < n - 1:
                nxt, reqs = _shift(kv, group, index, n, 1)
            k_b, v_b = kv
            kv_rank = (index - step) % n
            k_pos = kv_rank * S + torch.arange(S, device=dev)
            s = _scores(qg, k_b, q_pos, k_pos, causal)
            sl = torch.ceil(s) if intmax else s
            m_new = torch.maximum(m, torch.amax(sl, dim=-1, keepdim=True))
            alpha = torch.exp2(m - m_new)   # integer exponent under IntMax
            p = torch.exp2(s - m_new)
            acc = acc * alpha + p.to(v_b.dtype).float() @ \
                v_b[:, :, None].float()
            d = d * alpha + torch.sum(p, dim=-1, keepdim=True)
            m = m_new
            if step < n - 1:
                for r in reqs:
                    r.wait()
                kv = tuple(nxt)
        pos = d > 0
        o = torch.where(pos, acc / torch.where(pos, d, torch.ones_like(d)),
                        torch.zeros_like(acc))
        ctx.save_for_backward(q, k, v, o, m, d)
        ctx.args = (group, index, n, causal)
        return o.reshape(B, Hq, S, v.shape[-1]).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, d = ctx.saved_tensors
        group, index, n, causal = ctx.args
        B, Hq, S, D = q.shape
        Hkv = k.shape[1]
        qg = q.reshape(B, Hkv, Hq // Hkv, S, D).float()
        dog = do.reshape(o.shape).float()
        delta = torch.sum(dog * o, dim=-1, keepdim=True)
        inv_d = torch.where(d > 0, 1.0 / torch.where(d > 0, d,
                                                    torch.ones_like(d)),
                            torch.zeros_like(d))
        dev = q.device
        q_pos = index * S + torch.arange(S, device=dev)
        dq = torch.zeros_like(qg)
        blk = (k, v, torch.zeros(k.shape, dtype=torch.float32, device=dev),
               torch.zeros(v.shape, dtype=torch.float32, device=dev))
        for step in range(n):
            k_b, v_b, dk_b, dv_b = blk
            kv_rank = (index + step) % n
            k_pos = kv_rank * S + torch.arange(S, device=dev)
            s = _scores(qg, k_b, q_pos, k_pos, causal)
            p = torch.exp2(s - m) * inv_d                # (B,Hkv,G,Sq,Sk)
            dv_b = dv_b + (p.transpose(-1, -2) @ dog).sum(2)
            dp = dog @ v_b[:, :, None].float().transpose(-1, -2)
            ds = p * (dp - delta) * LN2
            dq = dq + ds @ k_b[:, :, None].float()
            dk_b = dk_b + (ds.transpose(-1, -2) @ qg).sum(2)
            if n > 1:
                # the reverse ring: the block and its gradients go back one
                # rank; after the n-th move they are home
                moving = (dk_b, dv_b) if step == n - 1 else \
                    (k_b, v_b, dk_b, dv_b)
                nxt, reqs = _shift(moving, group, index, n, -1)
                for r in reqs:
                    r.wait()
                blk = tuple(nxt) if step < n - 1 else (None, None, *nxt)
            else:
                blk = (k_b, v_b, dk_b, dv_b)
        dk, dv = blk[2], blk[3]
        return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None)


def ring_attention(
    q: torch.Tensor,  # (B, Hq, S, D), pre-scaled; global on every rank
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "model",
    causal: bool = True,
    intmax: bool = True,
    batch_axes: Tuple[str, ...] = ("pod", "data"),
) -> torch.Tensor:
    """Shards the sequence over ``axis_name`` (and the batch over
    ``batch_axes`` where it divides their product, as the reference's
    spec), runs the ring, returns the global (B, Hq, S, Dv) on every rank.
    The tensors must lie on the mesh's device type."""
    if q.device.type != mesh.device_type:
        raise ValueError(f"ring_attention: tensors on {q.device.type}, "
                         f"mesh over {mesh.device_type}")
    sizes = mesh_shape(mesh)
    group, index, n = axis_group(mesh, axis_name)
    baxes = [a for a in batch_axes if a in sizes]
    if q.shape[0] % max(1, math.prod(sizes[a] for a in baxes)):
        baxes = []
    if q.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]} does not split over {n} "
                         f"ranks of '{axis_name}'")
    # global → this rank's shards: the batch axes major to minor, then seq
    places = [(0, axis_group(mesh, a)) for a in baxes] + \
        [(2, (group, index, n))]
    for dim, (g, i, size) in places:
        q, k, v = (shard(t, dim, g, i, size) for t in (q, k, v))
    o = _Ring.apply(q, k, v, group, index, n, causal, intmax)
    for dim, (g, i, size) in reversed(places):
        o = gather(o, dim, g, i, size)
    return o


def ring_attention_placed(q, k, v, mesh, *, axis_name: str = "model",
                          causal: bool = True, intmax: bool = True):
    """Ring attention on DTensors whose sequence is sharded over
    ``axis_name`` (the sequence-parallel rules): each rank runs the ring
    on its own shards (the reference's ``shard_map`` body), the batch kept
    on its shards, the heads whole. Returns a DTensor placed as ``q``."""
    from repro_torch.kernels.dtensor import run_local
    group, index, n = axis_group(mesh, axis_name)
    S = q.shape[2]

    def local(ql, kl, vl):
        if ql.shape[2] * n != S:
            raise ValueError(f"sequence {S} is not sharded over the {n} "
                             f"ranks of '{axis_name}'")
        return _Ring.apply(ql, kl, vl, group, index, n, causal, intmax)

    ax = ("batch", None, "seq", None)
    return run_local(local, (q, k, v), (ax,) * 3, keep=("batch", "seq"))
