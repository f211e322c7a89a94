"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

The reference runs in one JAX process (``torch_ranks.run_jax``) on the
``Auto``-axis mesh ``Mesh(devices.reshape(4, 2), ("data", "model"))``
(``jax.make_mesh`` builds ``Explicit`` axes on this JAX, which its
``lower_cell`` does not take), the port in one process of its own on a
``fake`` process group of 8 ranks with the same (4, 2) mesh; both patch
``make_production_mesh`` to return it, as the reference's own tests do.
The cells: reduced qwen3-4b (``vocab_pad_to=64``) at ``train_4k``, and at
``decode_32k`` with and without ``with_opts(True)``.

EQUAL to the reference:

* the rule table ``lower_cell`` picks, for every ``GRID_ARCHS`` x shape x
  ``with_opts`` case on the 16 x 16 production mesh;
* ``chips``, ``model_flops`` and ``analytic_flops`` of each cell;
* the argument bytes per rank of each cell (the local shards of
  parameters, AdamW state, batch and cache);
* ``collective_bytes`` (the port's copy of the HLO reader) on the HLO
  strings of ``tests/test_property_hypothesis.py`` and on the optimized
  HLO text of the reference's own (4, 2) lowering of ``train_4k``;
* the collective wire bytes of one sharded matmul (a contraction split
  over ``model``, its result replicated: one all-reduce), where GSPMD and
  DTensor place the same way.

Held as the reference's tests hold them: the ``with_opts`` decode cache's
argument bytes at least 2x smaller (``tests/test_optimizations.py``).

Stated, not EQUAL: the per-kind collective bytes and the
bytes accessed. GSPMD propagates shardings through the whole program and
may pick another collective than DTensor's op-by-op rules (an all-gather
of activations where DTensor reduce-scatters a gradient); and XLA counts
the bytes of fused kernels, with each loop body once, where the port
counts every eager operation's operands and outputs, and the reference's
decode rewrites the whole cache through a one-hot select where the port
writes one row in place. So the port's total collective bytes must lie
within ``COLL_BAND`` of the reference's and its bytes accessed within
``BYTES_BAND``; both bands were set from the first runs (port over
reference: collectives 2.09 at ``train_4k``, 3.21 and 6.14 at the two
decode cells, whose totals are 41-570 KB of one-token activations; bytes
43.1x at ``train_4k``, 0.69x and 2.08x at decode) with room for another
torch's choices.

Counting, on a fake 8-rank group: ring attention's p2p shifts
(``batch_isend_irecv``, which ``CommDebugMode`` does not see) count as
``collective-permute``; a K6 call (``softermax_op``) counts as one call,
its operands plus its outputs, and its backward as one more. The
vocab-parallel loss and embedding: the recorded ``train_4k`` step
all-gathers neither the logits nor the whole embedding table, and the
same step on 8 gloo ranks (``tests/test_torch_placement.py``) holds the
one-rank loss within 1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from torch_ranks import SRC, run_jax

CELLS = {"train": ("train_4k", False), "decode": ("decode_32k", False),
         "decode_opts": ("decode_32k", True)}
COLL_BAND = (0.5, 8.0)     # port / reference total collective bytes
BYTES_BAND = (0.5, 100.0)  # port / reference bytes accessed
HLO_CASES = {
    "while": """
HloModule m

%body.1 (p: (s32[], f32[64])) -> (s32[], f32[64]) {
  %ar = f32[64]{0} all-reduce(%x), replica_groups=[16,16]<=[256]
  ROOT %t = tuple()
}

ENTRY %main () -> f32[64] {
  %w = (s32[], f32[64]) while(%init), condition=%c, body=%body.1, backend_config={"known_trip_count":{"n":"12"}}
  ROOT %r = f32[64]{0} get-tuple-element(%w)
}
""",
    "plain": """
HloModule m

ENTRY %main () -> f32[128] {
  %ag = f32[128]{0} all-gather(%x), replica_groups=[2,8]<=[16]
  ROOT %cp = f32[128]{0} collective-permute(%ag), source_target_pairs={{0,1}}
}
""",
}

_JAX = """
import json
import repro.launch.dryrun as dr      # first: it asks for 512 host devices
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.launch import roofline as rf
from repro.models.registry import GRID_ARCHS, get_config, reduce_config
from repro.parallel import sharding as jsh
out = {"rules": {}, "cells": {}, "hlo": {}}
names = {id(getattr(jsh, n)): n for n in (
    "DEFAULT_RULES", "LONG_CONTEXT_RULES", "SEQ_PARALLEL_RULES",
    "SERVE_RULES")}
devs = np.array(jax.devices())

class Picked(Exception):
    pass

def picked(mesh, rules):
    raise Picked(names[id(rules)])

prod = Mesh(devs[:256].reshape(16, 16), ("data", "model"))
dr.make_production_mesh = lambda multi_pod=False: prod
real_ctx, dr.sharding_context = dr.sharding_context, picked
for arch in GRID_ARCHS:
    for shape in dr.SHAPES:
        for opts in (False, True):
            try:
                dr.lower_cell(arch, shape, cfg_override=get_config(
                    arch).with_opts(opts))
            except Picked as e:
                out["rules"][f"{arch}|{shape}|{opts}"] = str(e)
dr.sharding_context = real_ctx

mesh = Mesh(devs[:8].reshape(4, 2), ("data", "model"))
dr.make_production_mesh = lambda multi_pod=False: mesh
base = reduce_config(get_config("qwen3-4b")).replace(vocab_pad_to=64)
for name, (shape, opts) in CELLS.items():
    compiled, rep = dr.lower_cell("qwen3-4b", shape,
                                  cfg_override=base.with_opts(opts))
    out["cells"][name] = {
        "chips": rep["chips"], "roofline": rep["roofline"],
        "memory": rep["memory_analysis"],
        "bytes": rep["cost_analysis"].get("bytes accessed")}
    if name == "train":
        with open(HLO, "w") as f:
            f.write(compiled.as_text())
        out["hlo"]["train"] = rf.collective_bytes(compiled.as_text())
for name, text in HLO_CASES.items():
    out["hlo"][name] = rf.collective_bytes(text)

# one matmul: the contraction split over model, the result replicated
x = jnp.ones((16, 64), jnp.float32)
w = jnp.ones((64, 32), jnp.float32)
mm = jax.jit(lambda a, b: a @ b,
             in_shardings=(NamedSharding(mesh, P(None, "model")),
                           NamedSharding(mesh, P("model", None))),
             out_shardings=NamedSharding(mesh, P()))
out["hlo"]["matmul"] = rf.collective_bytes(
    mm.lower(x, w).compile().as_text())
with open(OUT, "w") as f:
    json.dump(out, f)
"""

_PORT = """
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \\
    distribute_tensor
from repro_torch.configs.base import TRAIN_4K, TrainConfig
from repro_torch.kernels.softermax import softermax_op
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import fake_process_group
from repro_torch.launch.roofline import collective_bytes
from repro_torch.models.registry import get_config, model_fns, reduce_config
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.ring_attention import ring_attention_placed

out = {"cells": {}, "hlo": {}}
with open(HLO) as f:
    out["hlo"]["train"] = collective_bytes(f.read())
for name, text in HLO_CASES.items():
    out["hlo"][name] = collective_bytes(text)

def summary(rec, rep=None):
    d = {"collective_bytes": rec.collective_bytes,
         "collectives": rec.collectives, "bytes": rec.bytes_accessed,
         "kernel_calls": dict(rec.kernel_calls),
         "argument_bytes": rec.argument_bytes}
    if rep is not None:
        d.update(chips=rep["chips"], roofline=rep["roofline"],
                 memory=rep["memory_analysis"], rules=rep["rules"],
                 chip=rep["chip"])
    return d

with fake_process_group(8):
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    dr.make_production_mesh = lambda multi_pod=False, device=None: mesh
    base = reduce_config(get_config("qwen3-4b")).replace(vocab_pad_to=64)
    for name, (shape, opts) in CELLS.items():
        rec, rep = dr.lower_cell("qwen3-4b", shape,
                                 cfg_override=base.with_opts(opts))
        out["cells"][name] = summary(rec, rep)
    # the embedding table's and the logits' per-rank shapes at train_4k
    out["vocab"] = {"V": base.padded_vocab, "d": base.d_model,
                    "B": TRAIN_4K.global_batch, "S": TRAIN_4K.seq_len}

    with dr.Recorder() as mode:
        # one matmul: the contraction split over model, result replicated
        x = distribute_tensor(torch.ones(16, 64), mesh,
                              [Replicate(), Shard(1)])
        w = distribute_tensor(torch.ones(64, 32), mesh,
                              [Replicate(), Shard(0)])
        rec, _ = mode.record(lambda a, b: (a @ b).redistribute(
            mesh, [Replicate(), Replicate()]), x, w)
        out["matmul"] = summary(rec)

        # ring attention on the sequence-parallel placement
        B, H, S, D = 8, 4, 64, 16
        pl = [Shard(0), Shard(2)]
        q, k, v = (distribute_tensor(torch.ones(B, H, S, D), mesh, pl)
                   for _ in range(3))
        rec, o = mode.record(lambda *t: ring_attention_placed(
            *t, mesh, causal=True), q, k, v)
        out["ring"] = summary(rec)
        out["ring"]["local_kv_bytes"] = k.to_local().numel() * 4
        out["ring"]["out"] = [list(o.shape), repr(tuple(o.placements))]

        # K6 on a row-sharded DTensor, without and with its backward
        x = distribute_tensor(torch.ones(64, 128), mesh,
                              [Shard(0), Replicate()])
        rec, _ = mode.record(softermax_op, x)
        out["k6"] = summary(rec)
        out["k6"]["local_bytes"] = x.to_local().numel() * 4
        xg = x.detach().requires_grad_()
        rec, _ = mode.record(lambda t: softermax_op(t).sum().backward(),
                                xg)
        out["k6_grad"] = summary(rec)
with open(OUT, "w") as f:
    json.dump(out, f)
"""


def _consts(tmp):
    return (f"CELLS = {CELLS!r}\nHLO_CASES = {HLO_CASES!r}\n"
            f"HLO = {str(tmp / 'train.hlo')!r}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    ref = run_jax(_consts(tmp) + f"OUT = {str(tmp / 'ref.json')!r}\n"
                  + textwrap.dedent(_JAX))
    ref.wait()
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    code = _consts(tmp) + f"OUT = {str(tmp / 'port.json')!r}\n" + \
        textwrap.dedent(_PORT)
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with open(tmp / "ref.json") as f:
        want = json.load(f)
    with open(tmp / "port.json") as f:
        got = json.load(f)
    return {"ref": want, "port": got}


@pytest.mark.parametrize("arch", [
    "moonshot-v1-16b-a3b", "deepseek-v2-236b", "qwen3-4b", "granite-3-8b",
    "nemotron-4-15b", "llama3.2-3b", "hymba-1.5b", "whisper-base",
    "rwkv6-7b", "pixtral-12b"])
def test_rule_table_is_the_references(runs, arch):
    from repro_torch.launch.dryrun import SHAPES, select_rules
    from repro_torch.models.registry import get_config
    n = 0
    for shape in SHAPES:
        for opts in (False, True):
            want = runs["ref"]["rules"][f"{arch}|{shape}|{opts}"]
            got, _ = select_rules(get_config(arch).with_opts(opts),
                                  SHAPES[shape], 16)
            assert got == want, (shape, opts, got, want)
            n += 1
    assert n == 8


@pytest.mark.parametrize("cell", list(CELLS))
def test_chips_and_flops_are_the_references(runs, cell):
    got, want = runs["port"]["cells"][cell], runs["ref"]["cells"][cell]
    assert got["chips"] == want["chips"] == 8
    for key in ("model_flops", "analytic_flops"):
        assert got["roofline"][key] == want["roofline"][key], key
    assert got["chip"] == "H100 SXM"


@pytest.mark.parametrize("cell", list(CELLS))
def test_argument_bytes_are_the_references(runs, cell):
    got = runs["port"]["cells"][cell]["memory"]["argument_size_in_bytes"]
    want = runs["ref"]["cells"][cell]["memory"]["argument_size_in_bytes"]
    assert got == want and got > 0


def test_sharded_cache_argument_bytes(runs):
    cells = runs["port"]["cells"]
    ratio = (cells["decode"]["memory"]["argument_size_in_bytes"]
             / cells["decode_opts"]["memory"]["argument_size_in_bytes"])
    assert ratio > 2.0, ratio
    assert cells["decode"]["rules"] == "DEFAULT_RULES"
    assert cells["decode_opts"]["rules"] == "SERVE_RULES"


@pytest.mark.parametrize("case", ["while", "plain", "train", "matmul"])
def test_collective_bytes_reads_hlo_as_the_reference(runs, case):
    want = runs["ref"]["hlo"][case]
    if case != "matmul":
        assert runs["port"]["hlo"][case] == want
    if case == "train":
        assert sum(want.values()) > 0


def test_one_matmul_collective_bytes_equal(runs):
    want = runs["ref"]["hlo"]["matmul"]
    got = runs["port"]["matmul"]
    assert got["collective_bytes"] == want, (got["collective_bytes"], want)
    assert [c[0] for c in got["collectives"]] == ["all-reduce"]
    assert want["all-reduce"] == 16 * 32 * 4 * 2 * (2 - 1) / 2


@pytest.mark.parametrize("cell", list(CELLS))
def test_stated_tolerance_of_collectives_and_bytes(runs, cell):
    got, want = runs["port"]["cells"][cell], runs["ref"]["cells"][cell]
    g_coll = sum(got["roofline"]["collective_breakdown"].values())
    w_coll = sum(want["roofline"]["collective_breakdown"].values())
    assert set(got["roofline"]["collective_breakdown"]) == \
        set(want["roofline"]["collective_breakdown"])
    assert COLL_BAND[0] * w_coll <= g_coll <= COLL_BAND[1] * w_coll, \
        (g_coll, w_coll)
    assert BYTES_BAND[0] * want["bytes"] <= got["bytes"] <= \
        BYTES_BAND[1] * want["bytes"], (got["bytes"], want["bytes"])
    assert got["roofline"]["bytes_per_chip"] == got["bytes"]


def test_ring_attention_shifts_count_as_collective_permute(runs):
    ring = runs["port"]["ring"]
    n = 2                                  # the model axis
    sends = [c for c in ring["collectives"] if c[0] == "collective-permute"]
    # forward: K and V travel n - 1 steps
    assert len(sends) == 2 * (n - 1)
    assert all(c[1] == ring["local_kv_bytes"] and c[2] == n
               for c in sends), sends
    assert ring["collective_bytes"]["collective-permute"] == \
        2 * (n - 1) * ring["local_kv_bytes"]
    assert ring["out"] == [[8, 4, 64, 16], "(Shard(dim=0), Shard(dim=2))"]


def test_k6_counts_as_one_call(runs):
    k6 = runs["port"]["k6"]
    assert k6["kernel_calls"] == {"softermax_rows": 1}
    assert k6["bytes"] == 2 * k6["local_bytes"]          # in + out
    assert k6["collectives"] == []
    grad = runs["port"]["k6_grad"]
    assert grad["kernel_calls"] == {"softermax_rows": 1,
                                    "softermax_rows_bwd": 1}


def test_vocab_parallel_loss_and_embedding_gather_neither(runs):
    cell = runs["port"]["cells"]["train"]
    v = runs["port"]["vocab"]
    n_data, n_model = 4, 2
    logits = v["B"] // n_data * v["S"] * v["V"] * 4
    table = v["V"] * v["d"] * 4
    gathers = [c[1] for c in cell["collectives"] if c[0] == "all-gather"]
    # the embedding's FSDP gather of its vocab shard's columns is there;
    # a gather of the whole table or of every logit of a token is not
    assert v["V"] // n_model * v["d"] * 4 in gathers
    assert table not in gathers and logits not in gathers, \
        (sorted(set(gathers))[-3:], logits, table)
    # the log-sum-exp's max and sum and the label's logit: all-reduces
    # over the vocab's model axis of one value per local token
    tokens = v["B"] // n_data * v["S"] * 4
    reduces = [c for c in cell["collectives"]
               if c[0] == "all-reduce" and c[1] == tokens and c[2] == n_model]
    assert len(reduces) >= 3
