"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a card every test here skips (the decision is
made inside the ``cuda_device`` fixture, never at import). On the card,
run with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the suite's conftest imports JAX, which the port does
not need).

Tolerances: float32 outputs within 1e-5 of the plain version (the kernel
sums in another order, every rescale is exact). The paged kernels'
bfloat16 outputs within 2e-2 (one bf16 rounding of values of order 1). The
flash kernels' and the contiguous decode kernel's (K5) bfloat16 outputs
and gradients are held element by element to their own size
(``repro_torch.kernels.parity``, as ``chip_smoke.py`` holds them), and the
flash kernels' fp32 row statistics to 1e-5 in every dtype, on both of
their routes (bf16 on the tensor cores, f32 on the CUDA cores). The Softermax
row kernel (K6) is held by the same rule to its plain version computed in
float32; the fixed-point kernel (K7) is held EXACTLY (``torch.equal``) to
its mirror ``softermax_quant_plain`` and within one Q(1,7) step, 2^-7, of
``softermax_fixed`` (``kernels/softermax_quant/ref.py``). K5 and K6 are
held so on both of their routes (the bulk-copy and the earlier kernel; the
register and the two-pass kernel), and each route's launch counter is
checked; so are K2 (the tensor-core and the CUDA-core kernel, its bf16
route held by the same element-wise rule) and K7 (the register and the
two-pass kernel, both EQUAL to the mirror). The per-head
paged decode kernel (K8) is held by the same rule (float32 outputs 1e-5,
bfloat16 outputs 1e-2 of each element's size) to its plain version
``paged_decode_single_plain`` and to K1 on the same inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_op, flash_attention_plain)
from repro_torch.kernels.flash_decode import (bulk_tile_rows, decode_ref,
                                              flash_decode, split_lanes)
from repro_torch.kernels.flash_decode_paged import (
    flash_decode_paged, flash_decode_paged_single,
    flash_decode_paged_single_op, paged_decode_ref,
    paged_decode_single_plain, paged_decode_split_ref)
from repro_torch.kernels.flash_prefill_paged import (flash_prefill_paged,
                                                     paged_prefill_ref,
                                                     tc_route)
from repro_torch.kernels.parity import F32_ATOL, parity_error, tolerance
from repro_torch.kernels.softermax import (REG_CAP, softermax_op,
                                           softermax_rows, softermax_rows_ref)
from repro_torch.kernels.softermax_quant import REG_CAP as K7_REG_CAP
from repro_torch.kernels.softermax_quant import (softermax_quant_plain,
                                                 softermax_quant_ref,
                                                 softermax_quant_reg_plain,
                                                 softermax_quant_rows)
from repro_torch.models.attention import quantize_kv

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pools(rng, N, Hkv, BS, D, kv, device):
    k = torch.from_numpy(rng.normal(size=(N, Hkv, BS, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(N, Hkv, BS, D)).astype(np.float32))
    if kv == "int8":
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        return [t.to(device) for t in (kq, vq, ks, vs)]
    dt = torch.bfloat16 if kv == "bf16" else torch.float32
    return [k.to(device, dt), v.to(device, dt), None, None]


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("split", [1, 2, 3])
@pytest.mark.parametrize("BS", [16, 24])
def test_decode_kernel_matches_plain(cuda_device, kv, G, T, split, BS):
    rng = np.random.default_rng(100 + 9 * T + split)
    B, Hkv, D, W = 4, 2, 128, 9
    lens = np.array([0, 1, 17, W * BS - 3])       # zombie row first
    N = B * W + 1
    kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, cuda_device)
    tables = rng.permutation(np.arange(1, N))[:B * W].reshape(B, W)
    tables[0] = 0                                  # zombie: table 0
    bt = torch.from_numpy(tables.astype(np.int32)).to(cuda_device)
    ln = torch.from_numpy(lens.astype(np.int32)).to(cuda_device)
    qdt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = torch.from_numpy(rng.normal(size=(B, G * Hkv, D)).astype(np.float32)
                         / np.sqrt(D)).to(cuda_device, qdt)
    got = flash_decode_paged(q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                             kv_tile_blocks=T, split_k=split)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, kp, vp, bt, ln, k_scale=ks, v_scale=vs)
    want_split = paged_decode_split_ref(q, kp, vp, bt, ln, k_scale=ks,
                                        v_scale=vs, kv_tile_blocks=T,
                                        split_k=split)
    tol = _tol(qdt)
    # the gather version spreads a zombie row uniformly over garbage (no
    # column is valid); the kernel and the split version leave it at the
    # merge identity, which finalizes to 0
    assert (got[1:].float() - want[1:].float()).abs().max().item() <= tol
    assert (got.float() - want_split.float()).abs().max().item() <= tol
    assert torch.all(got[0] == 0)


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("pos0s,Sq", [((0, 768), 64), ((5, 40), 33)])
@pytest.mark.parametrize("G,BS", [(3, 16), (8, 24)])
def test_prefill_kernel_matches_plain(cuda_device, kv, T, pos0s, Sq, G, BS):
    rng = np.random.default_rng(7 + T)
    B, Hkv, D = len(pos0s), 2, 128
    W = -(-(max(pos0s) + Sq) // BS)
    N = B * W + 1
    kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, cuda_device)
    tables = rng.permutation(np.arange(1, N))[:B * W].reshape(B, W)
    bt = torch.from_numpy(tables.astype(np.int32)).to(cuda_device)
    pos = torch.tensor(pos0s, dtype=torch.int32, device=cuda_device)
    qdt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = torch.from_numpy(rng.normal(size=(B, G * Hkv, Sq, D))
                         .astype(np.float32) / np.sqrt(D)).to(cuda_device,
                                                              qdt)
    got = flash_prefill_paged(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs,
                              kv_tile_blocks=T)
    torch.cuda.synchronize()
    want = paged_prefill_ref(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs)
    assert (got.float() - want.float()).abs().max().item() <= _tol(qdt)


def _prefill_case(rng, device, B, Hkv, G, D, BS, Sq, pos0s, kv="bf16"):
    """Pools of 2 spare blocks past the tables, tables in a shuffled block
    order covering every position <= pos0 + Sq - 1, pre-scaled q."""
    W = -(-(max(pos0s) + Sq) // BS)
    N = B * W + 2
    kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, device)
    tables = rng.permutation(np.arange(1, N))[:B * W].reshape(B, W)
    bt = torch.from_numpy(tables.astype(np.int32)).to(device)
    pos = torch.tensor(pos0s, dtype=torch.int32, device=device)
    qdt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = torch.from_numpy(rng.normal(size=(B, G * Hkv, Sq, D))
                         .astype(np.float32) / np.sqrt(D)).to(device, qdt)
    return q, kp, vp, ks, vs, bt, pos


def _prefill_routes(*args, **kw):
    """One K2 launch; returns the output and its (launches, tensor-core
    launches) counts."""
    before = (flash_prefill_paged.launches, flash_prefill_paged.launches_tc)
    got = flash_prefill_paged(*args, **kw)
    torch.cuda.synchronize()
    return got, (flash_prefill_paged.launches - before[0],
                 flash_prefill_paged.launches_tc - before[1])


@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("BS", [8, 16])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("Sq", [11, 70])
@pytest.mark.parametrize("pos0", [0, 37])
def test_prefill_tensor_core_route_matches_plain(cuda_device, pos0, Sq, G,
                                                 BS, D, intmax):
    """K2's tensor-core route over the CPU emulation's geometry grid (two
    sequences at pos0 and pos0 + 29; covers off the 64-row tile), held to
    ``paged_prefill_ref`` by the bf16 rule of ``kernels/parity.py``."""
    rng = np.random.default_rng(pos0 + 3 * Sq + 7 * G + BS + D)
    q, kp, vp, _, _, bt, pos = _prefill_case(rng, cuda_device, 2, 2, G, D,
                                             BS, Sq, (pos0, pos0 + 29))
    assert tc_route(q, kp, vp)
    got, counts = _prefill_routes(q, kp, vp, bt, pos, intmax=intmax)
    assert counts == (1, 1)
    want = paged_prefill_ref(q, kp, vp, bt, pos, intmax=intmax)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert parity_error(got, want)[1] <= tolerance(torch.bfloat16)


@pytest.mark.parametrize("pos0", [0, 768, 3000])
def test_prefill_tensor_core_route_full_width_chunk(cuda_device, pos0):
    """A full-width 256-token chunk of llama3.2-3b (Hq 24, Hkv 8, D 128,
    BS 16) on the tensor-core route, the table padded to a multiple of 3
    blocks (``kv_tile_blocks`` 3: 288 and 1,056 positions, off the 64-row
    tile, at pos0 0 and 768), against ``paged_prefill_ref``."""
    rng = np.random.default_rng(pos0)
    q, kp, vp, _, _, bt, pos = _prefill_case(rng, cuda_device, 1, 8, 3, 128,
                                             16, 256, (pos0,))
    got, counts = _prefill_routes(q, kp, vp, bt, pos, kv_tile_blocks=3)
    assert counts == (1, 1)
    want = paged_prefill_ref(q, kp, vp, bt, pos)
    assert parity_error(got, want)[1] <= tolerance(torch.bfloat16)


@pytest.mark.parametrize("case", ["f32", "int8", "bf16 D36", "bf16 BS4",
                                  "bf16 BS24", "bf16 pool off 16 bytes"])
def test_prefill_earlier_route_off_the_rule(cuda_device, case):
    """Geometries off ``tc_route`` take the CUDA-core kernel (the
    tensor-core counter stays) and hold its parity."""
    rng = np.random.default_rng(len(case))
    kv = {"f32": "f32", "int8": "int8"}.get(case, "bf16")
    D = 36 if case == "bf16 D36" else 128
    BS = {"bf16 BS4": 4, "bf16 BS24": 24}.get(case, 16)
    q, kp, vp, ks, vs, bt, pos = _prefill_case(rng, cuda_device, 2, 2, 3, D,
                                               BS, 40, (5, 70), kv=kv)
    if case == "bf16 pool off 16 bytes":
        flat = torch.empty(kp.numel() + 1, dtype=kp.dtype,
                           device=cuda_device)
        flat[1:].copy_(kp.reshape(-1))
        kp = flat[1:].view(kp.shape)
    assert not tc_route(q, kp, vp)
    got, counts = _prefill_routes(q, kp, vp, bt, pos, k_scale=ks,
                                  v_scale=vs)
    assert counts == (1, 0)
    want = paged_prefill_ref(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs)
    assert parity_error(got, want)[1] <= tolerance(q.dtype)


def test_launch_counters_count_launches_only(cuda_device):
    rng = np.random.default_rng(3)
    kp, vp, _, _ = _pools(rng, 5, 2, 16, 128, "f32", cuda_device)
    bt = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda_device)
    q = torch.zeros((1, 4, 128), device=cuda_device)
    before = flash_decode_paged.launches
    flash_decode_paged(q, kp, vp, bt, torch.tensor([20], dtype=torch.int32,
                                                   device=cuda_device))
    paged_decode_ref(q, kp, vp, bt, torch.tensor([20], device=cuda_device))
    assert flash_decode_paged.launches == before + 1
    before = flash_prefill_paged.launches
    flash_prefill_paged(q[:, :, None], kp, vp, bt,
                        torch.tensor([5], dtype=torch.int32,
                                     device=cuda_device))
    assert flash_prefill_paged.launches == before + 1


# (B, Hkv, G, Sq, Sk, D): Sq = Sk and Sq < Sk, lengths off every tile; D 16
# (the reduced configs). bf16 cases take the tensor-core kernels, f32 the
# CUDA-core kernels.
FLASH_SHAPES = [(2, 2, 1, 77, 77, 128), (1, 2, 3, 50, 130, 128),
                (1, 8, 3, 200, 200, 128), (2, 1, 3, 33, 70, 64),
                (2, 2, 3, 77, 130, 16)]


def _flash_parity(device, dt, causal, intmax, shape):
    """K3 (o, m, d) and K4 (dq, dk, dv) against their plain versions."""
    B, Hkv, G, Sq, Sk, D = shape
    rng = np.random.default_rng(Sq + Sk)

    def rand(*shp):
        return torch.from_numpy(rng.normal(size=shp).astype(np.float32)) \
            .to(device, dt)

    q = rand(B, Hkv * G, Sq, D) * D ** -0.5
    k, v = rand(B, Hkv, Sk, D), rand(B, Hkv, Sk, D)
    do = rand(B, Hkv * G, Sq, D)
    o, m, d = flash_attention(q, k, v, causal=causal, intmax=intmax,
                              return_stats=True)
    torch.cuda.synchronize()
    po, pm, pd = flash_attention_plain(q, k, v, causal=causal, intmax=intmax,
                                       return_stats=True)
    tol = tolerance(dt)
    assert parity_error(o, po)[1] <= tol
    lse, plse = m + torch.log2(d), pm + torch.log2(pd)
    assert (lse - plse).abs().max().item() <= F32_ATOL
    if intmax:
        assert torch.equal(m, pm)
    grads = flash_attention_bwd(q, k, v, o, do, m, d, causal=causal)
    torch.cuda.synchronize()
    plain = flash_attention_bwd_plain(q, k, v, o, do, m, d, causal=causal)
    for got, want in zip(grads, plain):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert parity_error(got, want)[1] <= tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_kernels_match_plain(cuda_device, dtype, causal, intmax,
                                   shape):
    """K3 and K4 against their plain versions, on both routes."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    _flash_parity(cuda_device, dt, causal, intmax, shape)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("intmax", [True, False])
def test_flash_tensor_core_kernels_long_rows(cuda_device, causal, intmax):
    """The tensor-core kernels at Sq = Sk = 1000, where no tile edge (64,
    128, 32 rows) lines up with the end of the rows: bf16, same gate."""
    _flash_parity(cuda_device, torch.bfloat16, causal, intmax,
                  (1, 2, 3, 1000, 1000, 128))


def test_flash_launch_counters(cuda_device):
    """One count per forward launch and one per backward kernel (two per
    backward); the plain versions launch nothing."""
    q = torch.randn(1, 4, 40, 64, device=cuda_device, requires_grad=True)
    k = torch.randn(1, 2, 40, 64, device=cuda_device, requires_grad=True)
    v = torch.randn(1, 2, 40, 64, device=cuda_device, requires_grad=True)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    flash_attention_op(q, k, v).sum().backward()
    flash_attention_plain(q.detach(), k.detach(), v.detach())
    assert flash_attention.launches == f0 + 1
    assert flash_attention_bwd.launches == b0 + 2
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_op_route_counters(cuda_device, dtype):
    """A bf16 forward and backward (D 64) go through the tensor-core
    kernels and bump their counters; an f32 one goes through the CUDA-core
    kernels and leaves them alone. The totals count both routes."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(1, h, 40, 64, device=cuda_device, generator=gen)
               .to(dt).requires_grad_() for h in (4, 2, 2))
    before = (flash_attention.launches, flash_attention_bwd.launches,
              flash_attention.launches_tc, flash_attention_bwd.launches_tc)
    flash_attention_op(q, k, v).float().sum().backward()
    after = (flash_attention.launches, flash_attention_bwd.launches,
             flash_attention.launches_tc, flash_attention_bwd.launches_tc)
    tc = (1, 2) if dt == torch.bfloat16 else (0, 0)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 2, *tc)
    assert q.grad.dtype == dt and k.grad.shape == k.shape


def test_engine_sampling_on_the_card(cuda_device):
    """Temperature sampling draws from the engine's CUDA generator: the
    same seed gives the same streams; tokens stay in the vocabulary."""
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine
    cfg = reduce_config(get_config("llama3.2-3b"))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    runs = []
    for _ in range(2):
        eng = ContinuousEngine(cfg, params, block_size=8, num_blocks=40,
                               max_batch=2, max_len=64, seed=3,
                               device=cuda_device)
        eng.submit(np.arange(1, 12, dtype=np.int32), 10, temperature=0.8)
        eng.submit(np.arange(3, 9, dtype=np.int32), 10)
        runs.append([r.tokens for _, r in sorted(eng.run().items())])
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab_size for s in runs[0] for t in s)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("S", [37, 1056])
@pytest.mark.parametrize("Hkv", [1, 2, 8])
@pytest.mark.parametrize("intmax", [True, False])
def test_contiguous_decode_kernel_matches_plain(cuda_device, dtype, G, S,
                                                Hkv, intmax):
    """K5 against ``decode_ref``: lengths 1, the chunk (32) and pass (128)
    boundaries +-1 and the whole cache; 1, 5 or 9 split lanes
    (``split_lanes``) as the (sequence, KV head) pairs vary."""
    rng = np.random.default_rng(G * S + Hkv)
    D = 128
    lens = [n for n in (1, 31, 32, 33, 127, 128, 129, S) if n <= S]
    B = len(lens)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def rand(*shp, scale=1.0):
        return torch.from_numpy((rng.normal(size=shp) * scale)
                                .astype(np.float32)).to(cuda_device, dt)

    q = rand(B, G * Hkv, D, scale=D ** -0.5)
    k, v = rand(B, Hkv, S, D), rand(B, Hkv, S, D)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = flash_decode(q, k, v, ln, intmax=intmax)
    torch.cuda.synchronize()
    want = decode_ref(q, k, v, ln, intmax=intmax)
    assert got.dtype == want.dtype == dt
    assert parity_error(got, want)[1] <= tolerance(dt)


def test_contiguous_decode_kernel_counts_and_empty_rows(cuda_device):
    """One count per launch, none for the plain version; a row of length 0
    is the merge identity, 0 (d == 0 -> 0)."""
    k = torch.randn(2, 2, 40, 64, device=cuda_device)
    v = torch.randn(2, 2, 40, 64, device=cuda_device)
    q = torch.randn(2, 6, 64, device=cuda_device)
    ln = torch.tensor([0, 40], dtype=torch.int32, device=cuda_device)
    before = flash_decode.launches
    out = flash_decode(q, k, v, ln)
    decode_ref(q, k, v, ln)
    assert flash_decode.launches == before + 1
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert parity_error(out[1], decode_ref(q, k, v, ln)[1])[1] <= F32_ATOL


_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 4, 8])
@pytest.mark.parametrize("dtypes", ["bf16/bf16", "f32/f32", "bf16/f32",
                                    "f32/bf16"])
def test_decode_bulk_route_matches_plain(cuda_device, dtypes, G, D, intmax):
    """K5's bulk-copy route against ``decode_ref`` (q/cache dtypes): lengths
    0, 1, a tile's rows +-1, past the four-stage ring and the whole cache,
    in caches of under one tile, two tiles and 5 tiles + 3 rows, at 1, 8 and
    40 KV heads: 1 to 6 split lanes, and one lane of 6 tiles, where the
    ring wraps. Every launch takes the route; a row of length 0 is 0."""
    qdt, kdt = (_DT[n] for n in dtypes.split("/"))
    tile = bulk_tile_rows(D, torch.tensor([], dtype=kdt).element_size())
    splits = set()
    for S in (tile - 1, 2 * tile, 5 * tile + 3):
        lens = [n for n in (0, 1, tile - 1, tile, tile + 1, 4 * tile + 1, S)
                if n <= S]
        B = len(lens)
        for Hkv in (1, 8, 40):
            rng = np.random.default_rng(S + Hkv + G + D)

            def rand(*shp, scale=1.0, dt=kdt):
                return torch.from_numpy((rng.normal(size=shp) * scale)
                                        .astype(np.float32)).to(cuda_device,
                                                                dt)

            q = rand(B, G * Hkv, D, scale=D ** -0.5, dt=qdt)
            k, v = rand(B, Hkv, S, D), rand(B, Hkv, S, D)
            ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
            before = (flash_decode.launches, flash_decode.launches_bulk)
            got = flash_decode(q, k, v, ln, intmax=intmax)
            torch.cuda.synchronize()
            assert (flash_decode.launches - before[0],
                    flash_decode.launches_bulk - before[1]) == (1, 1)
            want = decode_ref(q, k, v, ln, intmax=intmax)
            live = ln > 0
            assert got.dtype == qdt
            assert parity_error(got[live], want[live])[1] <= tolerance(qdt)
            assert torch.all(got[~live] == 0)
            splits.add(split_lanes(B * Hkv, S, tile)[1])
    assert min(splits) == 1 and max(splits) >= 5


@pytest.mark.parametrize("case", ["bf16 D36", "f32 K off 16 bytes"])
def test_decode_earlier_route_off_the_rule(cuda_device, case):
    """Geometries off ``bulk_route`` take the earlier kernel (the bulk
    counter stays) and hold its parity: a bf16 row of 72 bytes, and a K
    4 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(7)
    B, Hkv, G, S = 5, 2, 3, 300
    D, dt, shift = (36, torch.bfloat16, 0) if case == "bf16 D36" else \
        (128, torch.float32, 1)
    lens = [1, 31, 129, 200, S]
    q = torch.from_numpy(rng.normal(size=(B, G * Hkv, D)).astype(np.float32)
                         / np.sqrt(D)).to(cuda_device, dt)
    n = B * Hkv * S * D
    flat = torch.from_numpy(rng.normal(size=2 * n + 8).astype(np.float32)) \
        .to(cuda_device, dt)
    k = flat[shift:shift + n].view(B, Hkv, S, D)
    v = flat[n + 4:2 * n + 4].view(B, Hkv, S, D)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = (flash_decode.launches, flash_decode.launches_bulk)
    got = flash_decode(q, k, v, ln)
    torch.cuda.synchronize()
    assert (flash_decode.launches - before[0],
            flash_decode.launches_bulk - before[1]) == (1, 0)
    assert parity_error(got, decode_ref(q, k, v, ln))[1] <= tolerance(dt)


def test_static_engine_on_the_card(cuda_device):
    """Reduced llama3.2-3b in float32: the static engine on the card (K5)
    emits the greedy streams of the same engine on the CPU and of the
    paged engine on the card, with n_layers K5 launches per decode step."""
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine, ServeEngine
    cfg = reduce_config(get_config("llama3.2-3b"))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 20)).astype(np.int32)
    streams = {}
    for d in ("cpu", cuda_device):
        before = flash_decode.launches
        res = ServeEngine(cfg, params, max_len=30, device=d).generate(
            prompts, 10)
        streams[str(d)] = res.tokens.tolist()
        launched = flash_decode.launches - before
        assert launched == (0 if d == "cpu" else cfg.n_layers * 9)
    eng = ContinuousEngine(cfg, params, block_size=8, num_blocks=32,
                           max_batch=4, max_len=32, device=cuda_device)
    handles = [eng.submit(p, 10) for p in prompts]
    res = eng.run()
    assert streams["cpu"] == streams[str(cuda_device)] == \
        [res[h.req_id].tokens for h in handles]


def _rows(shape, seed, scale):
    """Scores with a fully masked row, a half-masked row, a row whose max
    is <= -17 and a row masked up front (pad and masked entries enter the
    fixed-point PowSum)."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x *= scale
    rows = x.reshape(-1, shape[-1])
    rows[0] = -1e9
    if rows.shape[0] > 3:
        rows[1, shape[-1] // 2:] = -1e9
        rows[2] -= 30.0
        rows[3, :shape[-1] // 3] = -1e9
    return torch.from_numpy(x)


# the CPU tests' shapes, V off the 16-wide slice, and full-width rows (the
# llama3.2-3b prefill's V 1024 and bert-base's 512)
ROW_SHAPES = [(4, 128), (8, 1024), (5, 300), (16, 64), (3, 7, 130), (8, 37),
              (2, 16), (12, 200), (3, 1), (2048, 1024), (1024, 512)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("shape", ROW_SHAPES, ids=str)
def test_softermax_row_kernel_matches_plain(cuda_device, shape, intmax,
                                            dtype):
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = _rows(shape, sum(shape), 4.0).to(cuda_device, dt)
    got = softermax_rows(x.reshape(-1, shape[-1]), intmax=intmax)
    torch.cuda.synchronize()
    want = softermax_rows_ref(x.reshape(-1, shape[-1]).float(),
                              intmax).to(dt)
    assert got.dtype == dt and torch.isfinite(got).all()
    assert parity_error(got, want)[1] <= tolerance(dt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("V", [1, 7, 512, 1024, REG_CAP - 1, REG_CAP,
                               REG_CAP + 1, 4096, 8192])
def test_softermax_row_routes(cuda_device, V, intmax, dtype):
    """K6's two routes: rows of up to REG_CAP values on the register
    kernel, longer rows on the two-pass kernel (the register counter
    stays), each held to the plain version, with fully masked, half-masked,
    -30-shifted and partly masked rows (``_rows``); a fully masked row is
    uniform, 1/V."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = _rows((6, V), V + 3, 4.0).to(cuda_device, dt)
    before = (softermax_rows.launches, softermax_rows.launches_reg)
    got = softermax_rows(x, intmax=intmax)
    torch.cuda.synchronize()
    assert (softermax_rows.launches - before[0],
            softermax_rows.launches_reg - before[1]) == (1, int(V <= REG_CAP))
    want = softermax_rows_ref(x.float(), intmax).to(dt)
    assert got.dtype == dt and torch.isfinite(got).all()
    assert parity_error(got, want)[1] <= tolerance(dt)
    uniform = torch.full((V,), 1 / V, device=cuda_device)
    assert parity_error(got[0], uniform.to(dt))[1] <= tolerance(dt)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ROW_SHAPES, ids=str)
def test_fixed_point_kernel_equals_its_mirror(cuda_device, shape, dtype):
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = _rows(shape, sum(shape) + 1, 6.0).to(cuda_device, dt)
    x2 = x.reshape(-1, shape[-1])
    got = softermax_quant_rows(x2)
    torch.cuda.synchronize()
    assert got.dtype == dt
    assert torch.equal(got, softermax_quant_plain(x2))
    ref = softermax_quant_ref(x2.float())
    assert (got.float() - ref).abs().max().item() <= 2 ** -7
    assert torch.equal(got.float() * 128, torch.round(got.float() * 128))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("V", [16, 200, 1024, 2048, 2049])
def test_fixed_point_routes(cuda_device, V, dtype):
    """K7's two routes: rows of up to REG_CAP values on the register kernel,
    V 2049 on the two-pass kernel (the register counter stays); each EQUAL
    to the mirror and to the register route's plain arithmetic, with fully
    masked, half-masked, -30-shifted and partly masked rows (``_rows``)
    and a max that climbs by 13.25 per 16-wide slice."""
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = _rows((6, V), V + 5, 6.0)
    cols = torch.arange(V)
    x[4] = -30.0 + 13.25 * (cols // 16)
    x = x.to(cuda_device, dt)
    before = (softermax_quant_rows.launches,
              softermax_quant_rows.launches_reg)
    got = softermax_quant_rows(x)
    torch.cuda.synchronize()
    assert (softermax_quant_rows.launches - before[0],
            softermax_quant_rows.launches_reg - before[1]) == \
        (1, int(V <= K7_REG_CAP))
    assert got.dtype == dt
    assert (got.float() - softermax_quant_plain(x).float()).abs().max() \
        .item() == 0.0
    assert torch.equal(got, softermax_quant_reg_plain(x))
    assert (got.float() - softermax_quant_ref(x.float())).abs().max() \
        .item() <= 2 ** -7


def test_softermax_kernels_count_launches_and_take_gradients(cuda_device):
    """One count per launch (none for the plain versions); the dispatch of
    attention_softmax; the trainable ops' gradients against the plain
    functions' autograd (K6: closed form, 1e-5; K7: the same STE
    vector-Jacobian product, recomputed)."""
    from repro_torch.core.softermax import attention_softmax, softermax_fixed
    x = _rows((2, 3, 6, 70), 5, 4.0).to(cuda_device)
    g = torch.randn_like(x)
    k6, k7 = softermax_rows.launches, softermax_quant_rows.launches
    attention_softmax(x, "softermax")
    attention_softmax(x, "base2", axis=2)
    attention_softmax(x, "softermax_fixed")
    attention_softmax(x, "softmax")
    attention_softmax(x, "base2_folded")
    softermax_rows_ref(x.reshape(-1, 70))
    softermax_quant_plain(x)
    assert (softermax_rows.launches - k6, softermax_quant_rows.launches - k7) \
        == (2, 1)
    for impl in ("softermax", "base2", "softermax_fixed"):
        a = x.clone().requires_grad_()
        attention_softmax(a, impl).backward(g)
        b = x.cpu().requires_grad_()
        if impl == "softermax_fixed":
            softermax_fixed(b.reshape(-1, 70)).reshape(b.shape).backward(
                g.cpu())
        else:
            softermax_op(b, intmax=impl == "softermax").backward(g.cpu())
        assert (a.grad.cpu() - b.grad).abs().max().item() <= \
            1e-5 * b.grad.abs().max().item()


def test_fixed_point_engines_on_the_card(cuda_device):
    """Reduced llama3.2-3b in float32 with softmax_impl="softermax_fixed":
    the static engine on the card (K7 prefill, K5 decode) emits the greedy
    streams of the same engine on the CPU and of the paged engine on the
    card, with n_layers K7 launches per prefill."""
    from repro_torch.models.registry import (get_config, init_lm_params,
                                             reduce_config)
    from repro_torch.serve import ContinuousEngine, ServeEngine
    cfg = reduce_config(get_config("llama3.2-3b")).replace(
        softmax_impl="softermax_fixed")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 20)).astype(np.int32)
    streams = {}
    for d in ("cpu", cuda_device):
        before = softermax_quant_rows.launches
        res = ServeEngine(cfg, params, max_len=30, device=d).generate(
            prompts, 10)
        streams[str(d)] = res.tokens.tolist()
        launched = softermax_quant_rows.launches - before
        assert launched == (0 if d == "cpu" else cfg.n_layers)
    eng = ContinuousEngine(cfg, params, block_size=8, num_blocks=32,
                           max_batch=4, max_len=32, device=cuda_device)
    handles = [eng.submit(p, 10) for p in prompts]
    res = eng.run()
    assert streams["cpu"] == streams[str(cuda_device)] == \
        [res[h.req_id].tokens for h in handles]


def _single_inputs(rng, device, kv, G, BS, lens, W=6, Hkv=2, D=64):
    """K8 inputs: tables whose entries past each row's block cover are
    garbage (other rows' blocks)."""
    B = len(lens)
    N = B * W + 1
    kp, vp, ks, vs = _pools(rng, N, Hkv, BS, D, kv, device)
    tables = rng.permutation(np.arange(1, N)).reshape(B, W)
    for b, ln in enumerate(lens):
        cover = -(-ln // BS)
        tables[b, cover:] = rng.integers(0, N, W - cover)
    bt = torch.from_numpy(tables.astype(np.int32)).to(device)
    ln = torch.tensor(lens, dtype=torch.int32, device=device)
    qdt = torch.bfloat16 if kv == "bf16" else torch.float32
    q = torch.from_numpy(rng.normal(size=(B, G * Hkv, D)).astype(np.float32)
                         / np.sqrt(D)).to(device, qdt)
    return q, kp, vp, bt, ln, ks, vs


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("intmax", [True, False])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 12])
@pytest.mark.parametrize("BS", [8, 16])
def test_single_decode_kernel_matches_plain_and_k1(cuda_device, kv, intmax,
                                                   G, BS):
    rng = np.random.default_rng(200 + 7 * G + BS)
    lens = [0, 1, BS, 2 * BS + 5, 6 * BS - 3]     # length 0 first
    q, kp, vp, bt, ln, ks, vs = _single_inputs(rng, cuda_device, kv, G, BS,
                                               lens)
    got = flash_decode_paged_single(q, kp, vp, bt, ln, k_scale=ks,
                                    v_scale=vs, intmax=intmax)
    torch.cuda.synchronize()
    want = paged_decode_single_plain(q, kp, vp, bt, ln, k_scale=ks,
                                     v_scale=vs, intmax=intmax)
    assert got.dtype == q.dtype
    assert parity_error(got, want)[1] <= tolerance(q.dtype)
    assert torch.all(got[0] == 0)
    if G > 8:                                      # K1 holds groups <= 8
        return
    for T, S in ((1, 1), (4, 2)):
        k1 = flash_decode_paged(q, kp, vp, bt, ln, k_scale=ks, v_scale=vs,
                                intmax=intmax, kv_tile_blocks=T, split_k=S)
        assert parity_error(got, k1)[1] <= tolerance(q.dtype)


def test_single_decode_kernel_counts_and_dispatch(cuda_device):
    rng = np.random.default_rng(5)
    q, kp, vp, bt, ln, _, _ = _single_inputs(rng, cuda_device, "f32", 3, 16,
                                             [3, 40])
    before = flash_decode_paged_single.launches
    a = flash_decode_paged_single(q, kp, vp, bt, ln)
    b = flash_decode_paged_single_op(q, kp, vp, bt, ln)
    assert flash_decode_paged_single.launches == before + 2
    assert torch.equal(a, b)
    cpu = [t.cpu() for t in (q, kp, vp, bt, ln)]
    c = flash_decode_paged_single_op(*cpu)
    assert flash_decode_paged_single.launches == before + 2
    assert (c - a.cpu()).abs().max().item() <= F32_ATOL
    with pytest.raises(ValueError):
        flash_decode_paged_single(*cpu)
