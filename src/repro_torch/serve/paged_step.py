"""Model step functions over the paged KV cache (dense GQA LMs).

The JAX package's ``repro.serve.paged_step`` in eager PyTorch. JAX jits
each step, scans the layer stack and returns new pool arrays; the port
runs eagerly, loops over the layers, and **updates the pools in place**
(``index_put_``) — each step function below that writes the pool says so.

* ``paged_prefill``          — full-prompt forward (prompt right-padded to
  a block multiple); returns the true-last-token logits and the per-layer
  K/V to scatter.
* ``scatter_prefill``        — place a prefilled request's K/V into its
  physical blocks (in place).
* ``paged_prefill_suffix``   — prefix-cache hit: only the uncached suffix
  runs, attending the cached prefix gathered from the pool.
* ``scatter_prefill_offset`` — place suffix rows at arbitrary (block, row)
  coordinates (in place).
* ``paged_prefill_chunked``  — one chunk of a long prompt: per layer the
  chunk's rows are written into the pool first, then the chunk attends the
  pool through the block table (``kernels/flash_prefill_paged``).
* ``paged_decode_step``      — one token for the whole running batch: per
  layer, write the new K/V row, then paged Softermax decode attention over
  the pool (``kernels/flash_decode_paged``). Inactive rows carry table 0
  (the garbage block) and length 0; their writes land in block 0.

On CUDA tensors both attention calls launch the Hopper kernels; on CPU
tensors they take the plain PyTorch versions.

**Int8 pools.** Writers quantize rows per (head, token) when they write;
readers dequantize at gather, and attention accumulates in fp32.

**Dtypes.** Matrix weights are cast to the compute dtype at each use, as in
the JAX package (an identity when the engine cast them once at load); the
q scale is applied in q's dtype; ``rmsnorm`` returns its input's dtype;
logits are a compute-dtype product cast to fp32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode_paged import (flash_decode_paged_op,
                                                    gather_kv_dequant)
from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged_op
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (apply_rope, embed, logits, mlp,
                                       rmsnorm, rope_cos_sin)
from repro_torch.models.schema import layer_params


def check_paged_support(cfg: ModelConfig) -> None:
    """Paged serving covers the dense GQA family. The MoE family is served
    by the JAX package and comes to the port with ``moe_apply``."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"paged serving: unsupported family {cfg.family!r}")
    if cfg.mla is not None or cfg.ssm is not None:
        raise ValueError("paged serving: MLA/SSM caches not supported")
    if cfg.moe.first_dense:
        raise ValueError("paged serving: leading dense head blocks "
                         "not supported")
    if cfg.window:
        raise ValueError("paged serving: sliding-window archs not supported")
    if cfg.family == "moe":
        raise NotImplementedError("paged serving of the moe family needs "
                                  "moe_apply, not yet ported")


def table_width_bucket(need: int, *, nb_max: Optional[int] = None,
                       chunk_blocks: Optional[int] = None) -> int:
    """THE block-table width policy of the serving stack.

    * ``chunk_blocks`` set — chunked-prefill cover policy: round ``need`` up
      to a multiple of the chunk's own block count. This bound is the
      ``paged_prefill_split_ref`` table CONTRACT the CPU path relies on.
    * otherwise — pow2 policy (decode and one-shot suffix tables): the next
      power of two covering ``need``, clamped to ``nb_max`` (never below
      ``need``).
    """
    if chunk_blocks is not None:
        if chunk_blocks < 1:
            raise ValueError(f"chunk_blocks must be >= 1, "
                             f"got {chunk_blocks}")
        return -(-need // chunk_blocks) * chunk_blocks
    w = 1
    while w < need:
        w *= 2
    if nb_max is not None:
        w = max(min(w, nb_max), need)
    return w


def _ffn(bp, x, cfg: ModelConfig):
    return mlp(bp["ffn"], rmsnorm(bp["ln2"], x, cfg.norm_eps),
               cfg.activation)


def _head(params, x, last, cfg: ModelConfig):
    """Final norm and logits of the rows ``last`` (B,) of x (B, S, d)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    rows = torch.arange(x.shape[0], device=x.device)
    return logits(params["embed"], x[rows, last.long()], cfg)


def _row_index(blk, off, n_kv_heads: int):
    """Index of rows ``i`` at (blk[i], h, off[i]) of a layer's pool, for
    every head h: built once, used by every layer."""
    h = torch.arange(n_kv_heads, device=blk.device)
    return blk.long()[:, None], h[None, :], off.long()[:, None]


def _write_kv(k_pool, v_pool, k_scale, v_scale, layer, idx, k, v):
    """Write K/V rows (R, Hkv, Dh) of one layer at ``idx`` (``_row_index``)
    in place, quantizing them first for an int8 pool."""
    if k_pool.dtype == torch.int8:
        k, k_sc = attn_mod.quantize_kv(k)
        v, v_sc = attn_mod.quantize_kv(v)
        k_scale[layer].index_put_(idx, k_sc)
        v_scale[layer].index_put_(idx, v_sc)
    k_pool[layer].index_put_(idx, k.to(k_pool.dtype))
    v_pool[layer].index_put_(idx, v.to(v_pool.dtype))


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _fake_quant_kv(t: torch.Tensor) -> torch.Tensor:
    """Round-trip ``t`` through the pool's int8 representation, so a
    prefill attends exactly the values every later reader dequantizes."""
    q8, sc = attn_mod.quantize_kv(t)
    return attn_mod.dequantize_kv(q8, sc, t.dtype)


def paged_prefill(params, tokens: torch.Tensor, last_pos: torch.Tensor,
                  cfg: ModelConfig, kv_quantize: bool = False):
    """tokens (B, Sp) right-padded to a block multiple; last_pos (B,).
    Returns (true-last-token logits (B, V), k, v (L, B, Hkv, Sp, Dh)).

    ``kv_quantize`` (int8 pools) round-trips each layer's K/V through the
    int8 grid before the in-prompt attention."""
    B, Sp = tokens.shape
    _, intmax = attn_mod._mode(cfg)
    positions = torch.arange(Sp, dtype=torch.int32,
                             device=tokens.device).expand(B, Sp)
    x = embed(params["embed"], tokens, cfg)
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        if kv_quantize:
            q, k, v = attn_mod._project_qkv(bp["mixer"], h, cfg, positions)
            k = _fake_quant_kv(k)
            v = _fake_quant_kv(v)
            o = attn_mod.chunked_attention(attn_mod.q_scale(q, cfg), k, v,
                                           causal=True, intmax=intmax,
                                           chunk=cfg.attention_chunk)
            y = attn_mod._out_proj(bp["mixer"], o, cfg)
        else:
            y, k, v = attn_mod.attention_apply(bp["mixer"], h, cfg,
                                               positions=positions,
                                               causal=True, return_kv=True)
        x = x + y
        x = x + _ffn(bp, x, cfg)
        ks.append(k)
        vs.append(v)
    return _head(params, x, last_pos, cfg), torch.stack(ks), torch.stack(vs)


def scatter_prefill(k_pool, v_pool, ks, vs, block_ids, k_scale=None,
                    v_scale=None) -> None:
    """Write a prefilled request's K/V (L, 1, Hkv, Sp, Dh) into its blocks
    ``block_ids`` (nb,), nb*BS == Sp, **in place**; int8 pools quantize
    each (layer, head, token) row and write its scale too."""
    L, _, Hkv, Sp, Dh = ks.shape
    BS = k_pool.shape[3]
    nb = Sp // BS
    idx = block_ids.long()

    def place(pool, seq):                            # seq (L, Hkv, Sp, …)
        blocks = seq.reshape(L, Hkv, nb, BS, *seq.shape[3:]).movedim(2, 1)
        for layer in range(L):                       # leading-dim writes
            pool[layer].index_copy_(0, idx, blocks[layer].to(pool.dtype))

    if k_pool.dtype != torch.int8:
        place(k_pool, ks[:, 0])
        place(v_pool, vs[:, 0])
        return
    kq, ksc = attn_mod.quantize_kv(ks[:, 0])
    vq, vsc = attn_mod.quantize_kv(vs[:, 0])
    place(k_pool, kq)
    place(v_pool, vq)
    place(k_scale, ksc)
    place(v_scale, vsc)


def _suffix_attention(q, k_pre, v_pre, k_suf, v_suf, pre_valid, q_pos,
                      intmax):
    """Dense Softermax of suffix queries over [cached prefix ‖ in-flight
    suffix]; q (B, Hq, Sq, D) pre-scaled, k_pre/v_pre (B, Hkv, Sk, D)
    gathered from the pool (rows past the prefix masked by ``pre_valid``),
    k_suf/v_suf (B, Hkv, Sq, D), q_pos (B, Sq) absolute positions."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k_pre.shape
    k = torch.cat([k_pre, k_suf], dim=2)
    v = torch.cat([v_pre, v_suf], dim=2)
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = qg.float() @ k.float()[:, :, None].transpose(-1, -2)
    valid_pre = pre_valid[:, None, :].expand(B, Sq, Sk)
    valid_suf = q_pos[:, :, None] >= q_pos[:, None, :]
    valid = torch.cat([valid_pre, valid_suf], dim=2)      # (B, Sq, Sk+Sq)
    s = torch.where(valid[:, None, None], s,
                    torch.full_like(s, attn_mod.NEG_INF))
    m = torch.amax(torch.ceil(s) if intmax else s, dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    d = torch.sum(p, dim=-1, keepdim=True)
    pos = d > 0
    p = torch.where(pos, p / torch.where(pos, d, torch.ones_like(d)),
                    torch.zeros_like(p))
    o = p.to(v.dtype).float() @ v.float()[:, :, None]
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def paged_prefill_suffix(params, tokens, pos0: int, last_rel, k_pool, v_pool,
                         prefix_table, prefix_len, cfg: ModelConfig,
                         k_scale=None, v_scale=None):
    """Prefill only the uncached suffix (absolute positions ``pos0 + i``)
    of a prompt whose first ``pos0`` tokens are resident in the pool.
    Attention reads the cached prefix through ``prefix_table`` (B, W),
    dequantized for an int8 pool, masked past ``prefix_len`` (B,).
    Returns (logits (B, V), ks, vs (L, B, Hkv, Sp, Dh)); the caller writes
    ks/vs with ``scatter_prefill_offset``. Reads the pool only."""
    B, Sp = tokens.shape
    _, intmax = attn_mod._mode(cfg)
    quantized = k_pool.dtype == torch.int8
    dev = tokens.device
    positions = pos0 + torch.arange(Sp, dtype=torch.int32,
                                    device=dev).expand(B, Sp)
    x = embed(params["embed"], tokens, cfg)
    W = prefix_table.shape[1]
    BS = k_pool.shape[3]
    pre_valid = torch.arange(W * BS, dtype=torch.int32,
                             device=dev)[None, :] < prefix_len[:, None]
    ks, vs = [], []
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        q, k, v = attn_mod._project_qkv(bp["mixer"], h, cfg, positions)
        if quantized:
            k = _fake_quant_kv(k)
            v = _fake_quant_kv(v)
        q = attn_mod.q_scale(q, cfg)
        ksc = k_scale[layer] if quantized else None
        vsc = v_scale[layer] if quantized else None
        k_pre = gather_kv_dequant(k_pool[layer], ksc, prefix_table).to(k.dtype)
        v_pre = gather_kv_dequant(v_pool[layer], vsc, prefix_table).to(v.dtype)
        o = _suffix_attention(q, k_pre, v_pre, k, v, pre_valid, positions,
                              intmax)
        x = x + attn_mod._out_proj(bp["mixer"], o, cfg)
        x = x + _ffn(bp, x, cfg)
        ks.append(k)
        vs.append(v)
    return _head(params, x, last_rel, cfg), torch.stack(ks), torch.stack(vs)


def scatter_prefill_offset(k_pool, v_pool, ks, vs, blk, off, k_scale=None,
                           v_scale=None) -> None:
    """Row-granular write **in place**: suffix row ``i`` of every layer
    lands at ``pool[:, blk[i], :, off[i]]``; the caller routes pad rows to
    garbage block 0. Int8 pools quantize the rows and write their scales."""
    idx = _row_index(blk, off, ks.shape[2])
    for layer in range(ks.shape[0]):
        _write_kv(k_pool, v_pool, k_scale, v_scale, layer, idx,
                  ks[layer, 0].transpose(0, 1), vs[layer, 0].transpose(0, 1))


# ---------------------------------------------------------------------------
# Chunked prefill (flash-prefill kernel over the block table)
# ---------------------------------------------------------------------------


def _chunk_attention(q, k_pool_l, v_pool_l, table, pos0, intmax,
                     ksc_l=None, vsc_l=None, kv_tile_blocks=1):
    """Chunk queries over block-table-resident KV through the one
    dispatcher. ``split_tail_blocks`` is passed because
    ``paged_prefill_chunked`` requires an exact-cover or chunk-quantized
    table — the CPU split version's contract."""
    BS = k_pool_l.shape[2]
    tail = 2 * (-(-q.shape[2] // BS)) + 1
    return flash_prefill_paged_op(q, k_pool_l, v_pool_l, table, pos0,
                                  k_scale=ksc_l, v_scale=vsc_l,
                                  intmax=intmax,
                                  kv_tile_blocks=kv_tile_blocks,
                                  split_tail_blocks=tail)


def paged_prefill_chunked(params, tokens, pos0: int, last_rel, k_pool,
                          v_pool, table, blk, off, cfg: ModelConfig,
                          k_scale=None, v_scale=None, kv_tile_blocks: int = 1):
    """One chunk (1, C) of a chunked prefill at absolute position ``pos0``.

    ``table`` (1, W) covers every position <= pos0 + C - 1 in logical
    order; W must be the exact cover ceil((pos0+C)/BS) or that cover
    rounded up to a multiple of ceil(C/BS), pad entries = block 0 (the CPU
    path skips causal masking on the leading blocks under exactly this
    guarantee). Per layer the chunk's K/V rows are written into the pool at
    (blk, off) **in place** — pad rows go to block 0 — and then the chunk
    attends [cached prefix ‖ earlier chunks ‖ this chunk] through the
    table. Returns the chunk-last-token logits (1, V)."""
    B, C = tokens.shape
    _, intmax = attn_mod._mode(cfg)
    quantized = k_pool.dtype == torch.int8
    dev = tokens.device
    positions = pos0 + torch.arange(C, dtype=torch.int32,
                                    device=dev).expand(B, C)
    x = embed(params["embed"], tokens, cfg)
    qpos0 = torch.full((B,), pos0, dtype=torch.int32, device=dev)
    idx = _row_index(blk, off, k_pool.shape[2])
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        q, k, v = attn_mod._project_qkv(bp["mixer"], h, cfg, positions)
        _write_kv(k_pool, v_pool, k_scale, v_scale, layer, idx,
                  k[0].transpose(0, 1), v[0].transpose(0, 1))
        o = _chunk_attention(attn_mod.q_scale(q, cfg), k_pool[layer],
                             v_pool[layer], table, qpos0, intmax,
                             k_scale[layer] if quantized else None,
                             v_scale[layer] if quantized else None,
                             kv_tile_blocks)
        x = x + attn_mod._out_proj(bp["mixer"], o, cfg)
        x = x + _ffn(bp, x, cfg)
    return _head(params, x, last_rel, cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def paged_decode_step(params, tokens1, k_pool, v_pool, block_tables, lengths,
                      cfg: ModelConfig, k_scale=None, v_scale=None,
                      kv_tile_blocks: int = 1, decode_split_k: int = 1):
    """One continuous-batch decode step.

    tokens1 (B,); block_tables (B, nb); lengths (B,) tokens already cached.
    Writes each sequence's new K/V row at logical position ``lengths[b]``
    (physical: table[b, pos // BS], row pos % BS) **in place** — quantized
    against its own amax for an int8 pool — then attends ``lengths + 1``
    entries. Returns logits (B, V)."""
    B = tokens1.shape[0]
    BS = k_pool.shape[3]
    dt = cfg.compute_dtype_
    _, intmax = attn_mod._mode(cfg)
    quantized = k_pool.dtype == torch.int8
    x1 = params["embed"]["embedding"].to(dt)[tokens1]
    rows = torch.arange(B, device=tokens1.device)
    blk = block_tables[rows, (lengths // BS).long()]    # (B,) physical block
    off = lengths % BS
    new_len = lengths + 1
    idx = _row_index(blk, off, k_pool.shape[2])
    if cfg.rope_theta > 0:                              # next positions
        cos, sin = rope_cos_sin(lengths[:, None, None], cfg.rope_theta,
                                cfg.head_dim_ // 2)
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        mx = bp["mixer"]
        h = rmsnorm(bp["ln1"], x1, cfg.norm_eps)
        q = attn_mod.proj_heads(h, mx["wq"].to(dt))     # (B, Hq, Dh)
        k = attn_mod.proj_heads(h, mx["wk"].to(dt))
        v = attn_mod.proj_heads(h, mx["wv"].to(dt))
        if cfg.qk_norm:
            q = rmsnorm(mx["q_norm"], q, cfg.norm_eps)
            k = rmsnorm(mx["k_norm"], k, cfg.norm_eps)
        if cfg.rope_theta > 0:
            q = apply_rope(q[:, :, None, :], cos, sin)[:, :, 0]
            k = apply_rope(k[:, :, None, :], cos, sin)[:, :, 0]
        _write_kv(k_pool, v_pool, k_scale, v_scale, layer, idx, k, v)
        o = flash_decode_paged_op(
            attn_mod.q_scale(q, cfg), k_pool[layer], v_pool[layer],
            block_tables, new_len,
            k_scale=k_scale[layer] if quantized else None,
            v_scale=v_scale[layer] if quantized else None, intmax=intmax,
            kv_tile_blocks=kv_tile_blocks, split_k=decode_split_k)
        wo = mx["wo"].to(dt)
        x1 = x1 + o.flatten(1) @ wo.reshape(-1, wo.shape[-1])
        x1 = x1 + _ffn(bp, x1, cfg)
    x1 = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    return logits(params["embed"], x1, cfg)
