"""The port's kernel cost model and grid planner against the JAX package.

``serve/kernel_costs.py`` on the port: every ``LaunchCost`` field and
``estimate_seconds`` EXACTLY equal to the JAX package's over fixed and
random geometries, and the model equal to the port's measuring gather
oracles (``decode_gather_oracle``, ``prefill_gather_oracle``), which run
the gathers on torch tensors and count bytes. ``serve/autotune.py``:
``GridPlanner`` decisions and ``predicted_s`` exactly equal to JAX's over
random lengths trajectories, ``default_candidates`` equal, the argmin and
memoization properties of the reference's tests, and a planner given a
metric registry records its decisions and measurements there (held to the
JAX planner's registry in ``test_torch_telemetry.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import autotune as jat
from repro.serve import kernel_costs as jkc
from repro_torch.kernels.flash_decode_paged import (decode_gather_oracle,
                                                    split_layout)
from repro_torch.kernels.flash_prefill_paged import prefill_gather_oracle
from repro_torch.serve import (CostParams, GridPlanner, MetricRegistry,
                               default_candidates, decode_launch_cost,
                               estimate_seconds, prefill_launch_cost)
from repro_torch.serve import kernel_costs as tkc

_rng = np.random.default_rng(11)

Hq, Hkv, D, BS = 8, 2, 64, 16
SHAPE = dict(n_q_heads=Hq, n_kv_heads=Hkv, head_dim=D, block_size=BS)


def _pools(n_blocks, dtype):
    if dtype == "int8":
        k = torch.from_numpy(_rng.integers(-127, 128, (n_blocks, Hkv, BS, D))
                             .astype(np.int8))
        ks = torch.from_numpy(_rng.random((n_blocks, Hkv, BS))
                              .astype(np.float32))
        return k, k, ks, ks
    k = torch.from_numpy(_rng.standard_normal((n_blocks, Hkv, BS, D)))
    k = k.to(getattr(torch, dtype))
    return k, k, None, None


def _table(B, W, n_blocks, lengths):
    """Exact-cover tables: row i holds ceil(len/BS) real entries, rest 0."""
    bt = np.zeros((B, W), np.int32)
    for i, ln in enumerate(lengths):
        nb = min(-(-int(ln) // BS), W)
        bt[i, :nb] = _rng.integers(1, n_blocks, (nb,))
    return torch.from_numpy(bt)


def _same_as_jax(cost, jcost, params=None):
    """Every field and the latency proxy equal to the JAX package's."""
    assert dataclasses.asdict(cost) == dataclasses.asdict(jcost)
    assert cost.useful_bytes == jcost.useful_bytes
    if params is None:
        assert estimate_seconds(cost) == jkc.estimate_seconds(jcost)
    else:
        assert estimate_seconds(cost, CostParams(**params)) == \
            jkc.estimate_seconds(jcost, jkc.CostParams(**params))


class TestDecodeModelMatchesOracle:
    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    @pytest.mark.parametrize("tile,split", [(1, 1), (2, 1), (4, 1),
                                            (1, 2), (2, 2), (4, 3),
                                            (16, 1), (1, 4)])
    def test_gather_waste_steps_exact(self, dtype, tile, split):
        B, W, n_blocks = 5, 12, 64
        lengths = np.array([1, 17, 64, 190, 7], np.int64)
        k, v, ks, vs = _pools(n_blocks, dtype)
        bt = _table(B, W, n_blocks, lengths)
        oracle = decode_gather_oracle(k, v, bt, lengths,
                                      kv_tile_blocks=tile, split_k=split,
                                      k_scale=ks, v_scale=vs)
        model = decode_launch_cost(lengths, W, kv_tile_blocks=tile,
                                   split_k=split, kv_dtype=dtype, **SHAPE)
        assert model.gather_bytes == oracle["gather_bytes"]
        assert model.waste_bytes == oracle["waste_bytes"]
        assert model.useful_bytes == oracle["useful_bytes"]
        assert model.grid_steps == oracle["grid_steps"]
        assert split_layout(W, tile, split)[3] == oracle["padded_width"]
        _same_as_jax(model, jkc.decode_launch_cost(
            lengths, W, kv_tile_blocks=tile, split_k=split, kv_dtype=dtype,
            **SHAPE))

    def test_random_geometry_sweep(self):
        for _ in range(25):
            B = int(_rng.integers(1, 7))
            W = int(_rng.integers(1, 40))
            tile = int(_rng.integers(1, 9))
            split = int(_rng.integers(1, 5))
            dtype = ("float32", "bfloat16", "int8")[int(_rng.integers(3))]
            heads = dict(SHAPE, n_q_heads=int(_rng.choice([2, 4, 8, 12])))
            lengths = _rng.integers(1, W * BS + 1, (B,))
            k, v, ks, vs = _pools(48, dtype)
            bt = _table(B, W, 48, lengths)
            oracle = decode_gather_oracle(k, v, bt, lengths,
                                          kv_tile_blocks=tile,
                                          split_k=split, k_scale=ks,
                                          v_scale=vs)
            model = decode_launch_cost(lengths, W, kv_tile_blocks=tile,
                                       split_k=split, kv_dtype=dtype,
                                       **heads)
            assert model.gather_bytes == oracle["gather_bytes"]
            assert model.waste_bytes == oracle["waste_bytes"]
            assert model.grid_steps == oracle["grid_steps"]
            _same_as_jax(model, jkc.decode_launch_cost(
                lengths, W, kv_tile_blocks=tile, split_k=split,
                kv_dtype=dtype, **heads),
                params=dict(cores=int(_rng.integers(1, 9)),
                            flops_per_s=float(_rng.choice([5e10, 2e13]))))

    def test_waste_zero_iff_no_padding(self):
        B, W = 3, 8
        lengths = np.full((B,), W * BS, np.int64)
        model = decode_launch_cost(lengths, W, kv_tile_blocks=2, split_k=2,
                                   **SHAPE)
        assert split_layout(W, 2, 2)[3] == W and model.waste_bytes == 0
        short = lengths.copy()
        short[0] -= BS
        assert decode_launch_cost(short, W, kv_tile_blocks=2, split_k=2,
                                  **SHAPE).waste_bytes > 0
        assert decode_launch_cost(lengths, W, kv_tile_blocks=3, split_k=1,
                                  **SHAPE).waste_bytes > 0

    def test_int8_scale_siblings_counted(self):
        lengths = np.array([40, 8], np.int64)
        f32 = decode_launch_cost(lengths, 4, kv_dtype="float32", **SHAPE)
        i8 = decode_launch_cost(lengths, 4, kv_dtype="int8", **SHAPE)
        blocks = 2 * Hkv * split_layout(4, 1, 1)[3]
        assert i8.gather_bytes == f32.gather_bytes // 4 + blocks * 2 * BS * 4

    def test_scaled_multiplies_extensive_fields_only(self):
        c = decode_launch_cost(np.array([33]), 4, **SHAPE)
        s = c.scaled(3)
        assert s.gather_bytes == 3 * c.gather_bytes
        assert s.flops == 3 * c.flops
        assert s.grid_steps == 3 * c.grid_steps
        assert s.tile_bytes == c.tile_bytes
        assert s.vmem_bytes == c.vmem_bytes
        d = c.to_dict()
        assert d["useful_bytes"] == c.gather_bytes - c.waste_bytes
        assert d == jkc.decode_launch_cost(np.array([33]), 4, **SHAPE) \
            .to_dict()

    def test_unknown_dtype_rejected(self):
        with pytest.raises(ValueError, match="kv_dtype"):
            decode_launch_cost(np.array([8]), 2, kv_dtype="fp4", **SHAPE)
        assert tkc.KV_ITEMSIZE == jkc.KV_ITEMSIZE


class TestPrefillModelMatchesOracle:
    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    @pytest.mark.parametrize("tile", [1, 2, 4])
    @pytest.mark.parametrize("q_len,block_q", [(32, 128), (200, 128),
                                               (64, 32)])
    def test_gather_waste_steps_exact(self, dtype, tile, q_len, block_q):
        B, n_blocks = 3, 64
        pos0 = np.array([0, 48, 16], np.int64)
        cover = [-(-int(p + q_len) // BS) for p in pos0]
        W = max(cover) + 2                       # some rows padded
        k, v, ks, vs = _pools(n_blocks, dtype)
        bt = _table(B, W, n_blocks, [c * BS for c in cover])
        oracle = prefill_gather_oracle(k, v, bt, pos0, q_len,
                                       kv_tile_blocks=tile, block_q=block_q,
                                       cover_blocks=cover,
                                       k_scale=ks, v_scale=vs)
        model = prefill_launch_cost(q_len, pos0, cover, W,
                                    kv_tile_blocks=tile, block_q=block_q,
                                    kv_dtype=dtype, **SHAPE)
        assert model.gather_bytes == oracle["gather_bytes"]
        assert model.waste_bytes == oracle["waste_bytes"]
        assert model.useful_bytes == oracle["useful_bytes"]
        assert model.grid_steps == oracle["grid_steps"]
        _same_as_jax(model, jkc.prefill_launch_cost(
            q_len, pos0, cover, W, kv_tile_blocks=tile, block_q=block_q,
            kv_dtype=dtype, **SHAPE))

    def test_waste_zero_iff_exact_cover(self):
        pos0, q_len = [0], 4 * BS
        model = prefill_launch_cost(q_len, pos0, [4], 4, **SHAPE)
        assert model.waste_bytes == 0
        assert prefill_launch_cost(q_len, pos0, [4], 6,
                                   **SHAPE).waste_bytes > 0
        k, v, _, _ = _pools(8, "float32")
        bt = _table(1, 4, 8, [q_len])
        assert prefill_gather_oracle(k, v, bt, pos0, q_len)["waste_bytes"] \
            == 0

    def test_misaligned_rows_rejected(self):
        with pytest.raises(ValueError, match="align"):
            prefill_launch_cost(32, [0, 1], [2], 4, **SHAPE)


class TestEstimateSeconds:
    def test_monotone_in_length(self):
        p = CostParams(flops_per_s=5e10)
        costs = [decode_launch_cost(np.array([ln]), 16, **SHAPE)
                 for ln in (8, 64, 200)]
        secs = [estimate_seconds(c, p) for c in costs]
        assert secs == sorted(secs) and secs[0] < secs[-1]
        assert dataclasses.asdict(p) == dataclasses.asdict(
            jkc.CostParams(flops_per_s=5e10))

    def test_split_k_helps_long_row_with_cores(self):
        lengths = np.array([64 * BS], np.int64)
        p = CostParams(cores=8)
        t1 = estimate_seconds(decode_launch_cost(lengths, 64, **SHAPE), p)
        t4 = estimate_seconds(decode_launch_cost(lengths, 64, split_k=4,
                                                 **SHAPE), p)
        assert t4 < t1
        assert dataclasses.asdict(tkc.DEFAULT_COST_PARAMS) == \
            dataclasses.asdict(jkc.DEFAULT_COST_PARAMS)


class TestGridPlanner:
    CANDS = [(1, 1), (2, 1), (4, 1), (2, 2)]

    def _planner(self, **kw):
        return GridPlanner(self.CANDS, kv_dtype="float32", **SHAPE, **kw)

    def test_argmin_never_loses_to_any_fixed_candidate(self):
        pl = self._planner()
        for _ in range(20):
            B = int(_rng.integers(1, 6))
            W = int(_rng.integers(1, 33))
            lengths = _rng.integers(1, W * BS + 1, (B,))
            dec = pl.plan_decode(lengths, W)
            for (t, s) in self.CANDS:
                c = decode_launch_cost(lengths, W, kv_tile_blocks=t,
                                       split_k=s, **SHAPE)
                assert dec.predicted_s <= estimate_seconds(
                    c, pl.cost_params) + 1e-15
            assert (dec.kv_tile_blocks, dec.split_k) in self.CANDS
            assert len(dec.considered) == len(self.CANDS)

    @pytest.mark.parametrize("cores,flops", [(2, 2e13), (8, 5e10)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_decisions_equal_jax_over_trajectories(self, cores, flops,
                                                   dtype):
        """Random lengths trajectories (rows advance one token per step,
        requests finish and the width bucket shrinks): every decision, its
        predicted seconds and its ranking exactly equal to JAX's."""
        cands = [(1, 1), (4, 1), (8, 1), (1, 4), (4, 2), (4, 4)]
        kw = dict(SHAPE, kv_dtype=dtype)
        tp = GridPlanner(cands, cost_params=CostParams(
            cores=cores, flops_per_s=flops), **kw)
        jp = jat.GridPlanner(cands, cost_params=jkc.CostParams(
            cores=cores, flops_per_s=flops), **kw)
        lengths = _rng.integers(1, 40 * BS, (6,))
        for step in range(40):
            live = lengths + step
            if step >= 20:
                live[0] = 1                      # finished: a zombie row
            W = 1
            while W * BS < int(live.max()) + 1:
                W *= 2
            td, jd = tp.plan_decode(live, W), jp.plan_decode(live, W)
            assert (td.kv_tile_blocks, td.split_k, td.predicted_s,
                    td.considered) == (jd.kv_tile_blocks, jd.split_k,
                                       jd.predicted_s, jd.considered)
            _same_as_jax(td.cost, jd.cost, params=dict(
                cores=cores, flops_per_s=flops))
        assert tp.decisions == jp.decisions
        assert tp.summary() == jp.summary()

    def test_memoizes_on_block_counts_not_raw_lengths(self):
        pl = self._planner()
        d1 = pl.plan_decode(np.array([17, 33]), 8)
        d2 = pl.plan_decode(np.array([20, 44]), 8)
        assert d2 is d1
        assert len(pl._cache) == 1
        d3 = pl.plan_decode(np.array([17, 49]), 8)   # crosses a block
        assert d3 is not d1
        assert sum(pl.summary().values()) == 3

    def test_registry_records_decisions_and_measurements(self):
        reg = MetricRegistry()
        pl = self._planner(registry=reg)
        dec = pl.plan_decode(np.array([40]), 4)
        pl.observe_measured(dec, 1e-3)
        pl.observe_measured(dec, 0.0)          # not recorded
        assert reg.get("autotune_decisions_total").value == 1
        assert reg.get("autotune_measured_step_seconds").count == 1
        assert reg.get("autotune_pred_over_measured").value == \
            dec.predicted_s / 1e-3
        # without a registry the decision trail alone is kept
        pl = self._planner()
        pl.observe_measured(pl.plan_decode(np.array([40]), 4), 1e-3)
        assert sum(pl.summary().values()) == 1

    def test_default_candidates_closed_and_deduped(self):
        cands = default_candidates(4, 2)
        assert set(cands) == {(1, 1), (4, 1), (1, 2), (4, 2)}
        assert default_candidates(1, 1) == ((1, 1),)
        for t, s in ((4, 2), (1, 1), (8, 4), (2, 1)):
            assert default_candidates(t, s) == jat.default_candidates(t, s)
        with pytest.raises(ValueError):
            GridPlanner([(0, 1)], kv_dtype="float32", **SHAPE)
