"""The port's durability layer against the JAX package's, on the CPU.

Weights: reduced qwen3-4b in float32 from the reference's
``model_fns(cfg).init`` bridged through numpy; block 8. Tolerances, per
check:

* Against the reference: both packages' engines driven to the same
  mid-COW state (``ManualClock`` time, f32 and int8 pools); the JSON
  sections of ``snapshot_state`` EXACT — ``meta``, ``pool_meta``,
  ``radix``, ``sched``, and ``engine`` but for the random state (the
  reference's JAX key, the port's ``torch.Generator`` state); int8 codes
  EXACT, scales within ``rtol`` 1e-5, f32 K/V within 1e-5 of each array's
  largest magnitude (the packages sum in other orders, as
  ``tests/test_torch_flash_decode.py`` holds them). ``restore_bench``'s
  ``case_workload`` and ``fresh_batch`` EXACT.
* The reference's behaviour tests (``tests/test_snapshot.py``), run
  against the port: journal durability (CRCs, torn tails, duplicates,
  anchors, compaction, fsync policies), the container (round trip,
  corruption, header tamper), engine snapshots (byte-identical
  continuation, mid-COW, purged pins, int8 scales, fingerprint mismatch,
  ``requeue_inflight``, cold fallback), the seeded and ``hypothesis``
  round-trip identity, warm and cold fleet resume; streams EXACT.
* A bf16 pool survives a snapshot round trip bit for bit with
  ``ml_dtypes`` unimportable.
* ``restore_bench``: its in-process pieces (``kill_condition``,
  ``recover``, ``corrupt_snapshot``) and its SIGKILL CLI at ``--smoke`` on
  the CPU (real child processes, ~15 s).
"""
import json
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as pserve
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import (ContinuousEngine, FleetSupervisor, Journal,
                               JournalCorrupt, ManualClock, Router, Snapshot,
                               SnapshotCorrupt, apply_snapshot,
                               check_invariants, engine_fingerprint,
                               leaked_blocks, replay, requeue_inflight,
                               restore_engine, snapshot_state, state_digest,
                               write_snapshot)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this module runs: its engines step through
    thousands of small ops, which several test workers sharing the CPU
    slow down many times over when each op fans out to every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_reduce_config(jax_get_config("qwen3-4b"))
    tcfg = reduce_config(get_config("qwen3-4b"))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def setup(qwen):
    """The port's (cfg, params), as the reference's tests name them."""
    return qwen[1], qwen[3]


def _engine(cfg, params, **kw):
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 48)
    kw.setdefault("retry_backoff_s", 0.0)
    eng = ContinuousEngine(cfg, params, device="cpu", **kw)
    eng.warmup()
    return eng


def _prompt(cfg, n, seed=23):
    return np.random.default_rng(seed + n).integers(
        1, cfg.vocab_size, (n,)).astype(np.int32)


def _shared_prompts(cfg, n_req, prefix_len=12, tail_len=6, seed=5):
    """Prompts sharing a non-block-aligned prefix: re-hits COW the
    partial tail block."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, (prefix_len,)).astype(np.int32)
    return [np.concatenate(
        [prefix, rng.integers(1, cfg.vocab_size, (tail_len,))
         .astype(np.int32)]) for _ in range(n_req)]


def _streams(finished):
    return {rid: (list(r.tokens), r.finish_reason)
            for rid, r in finished.items()}


def _bits(x):
    """A tensor's bytes as an integer tensor (bf16 by its bit pattern)."""
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _sections_equal(a: Snapshot, b: Snapshot):
    assert a.meta == b.meta
    assert set(a.sections) == set(b.sections)
    for name in a.sections:
        x, y = a.sections[name], b.sections[name]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert torch.equal(_bits(x), _bits(y)), name
        else:
            assert x == y, name


# ---------------------------------------------------------------------------
# Snapshot sections against the reference's
# ---------------------------------------------------------------------------

def _midcow(mod, cfg, params, **kw):
    """An engine (no warmup: the packages' warmups differ) driven to a
    mid-COW state: a published shared prefix, three re-hits sharing it."""
    clock = mod.ManualClock(tick=1e-4)
    eng = mod.ContinuousEngine(cfg, params, block_size=8, num_blocks=24,
                               max_batch=3, max_len=48, retry_backoff_s=0.0,
                               clock=clock, **kw)
    prompts = _shared_prompts(cfg, 4, seed=11)
    eng.submit(prompts[0], 4)
    eng.run()
    for p in prompts[1:]:
        eng.submit(p, 4)
    steps = 0
    while eng.pool.stats.cow_copies == 0 and steps < 50:
        eng.step()
        steps += 1
    return eng


@pytest.fixture(scope="module", params=[None, "int8"], ids=["f32", "int8"])
def both_snapshots(request, qwen):
    jcfg, tcfg, jparams, tparams = qwen
    je = _midcow(jserve, jcfg, jparams, kv_dtype=request.param)
    pe = _midcow(pserve, tcfg, tparams, kv_dtype=request.param, device="cpu")
    assert pe.pool.stats.cow_copies > 0
    return jserve.snapshot_state(je), snapshot_state(pe), request.param


def test_snapshot_json_sections_match_jax(both_snapshots):
    js, ps, _ = both_snapshots
    assert ps.meta == js.meta
    for name in ("pool_meta", "radix", "sched"):
        assert ps.sections[name] == js.sections[name], name
    a = {k: v for k, v in js.sections["engine"].items() if k != "key"}
    b = {k: v for k, v in ps.sections["engine"].items() if k != "gen_state"}
    assert b == a
    assert ps.sections["sched"]["running"]          # mid-flight state
    assert ps.sections["radix"]["nodes"]
    assert sorted(ps.sections) == sorted(js.sections)


def test_snapshot_arrays_match_jax(both_snapshots):
    js, ps, kv = both_snapshots
    for name in js.sections:
        if not name.startswith("pool."):
            continue
        x = np.asarray(js.sections[name])
        y = ps.sections[name].numpy()
        assert x.shape == y.shape and str(x.dtype) == str(y.dtype), name
        if kv == "int8" and name in ("pool.k", "pool.v"):
            np.testing.assert_array_equal(y, x)      # int8 codes EXACT
        elif name.endswith("_scale"):
            np.testing.assert_allclose(y, x, rtol=TOL, atol=0)
        else:
            assert np.abs(y - x).max() <= TOL * np.abs(x).max(), name


def test_restore_bench_workloads_match_jax():
    from benchmarks import restore_bench as jax_bench
    from repro_torch.benchmarks import restore_bench as rb
    for case in rb.KILL_CASES:
        a = jax_bench.case_workload(case, 151936, 41, 6)
        b = rb.case_workload(case, 151936, 41, 6)
        assert [t for t, _ in a] == [t for t, _ in b]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    arr = rb.case_workload("midcow", 151936, 41, 6)
    assert all(np.array_equal(x, y) for x, y in zip(
        jax_bench.fresh_batch(arr[:2], 151936, 41, 4),
        rb.fresh_batch(arr[:2], 151936, 41, 4)))
    for name in ("BLOCK_SIZE", "NUM_BLOCKS", "MAX_BATCH", "PREFIX_LEN",
                 "TAIL_LEN", "PREFILL_CHUNK", "KILL_CASES"):
        assert getattr(rb, name) == getattr(jax_bench, name), name


def test_bf16_pool_roundtrips_bit_for_bit_without_ml_dtypes(
        setup, tmp_path, monkeypatch):
    cfg, params = setup
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)   # unimportable
    eng = _engine(cfg, params, kv_dtype="bf16")
    for p in _shared_prompts(cfg, 3):
        eng.submit(p, 6)
    for _ in range(3):
        eng.step()
    assert eng.pool.k.dtype == torch.bfloat16
    path = str(tmp_path / "bf16.snap")
    write_snapshot(eng, path)
    snap = Snapshot.read(path)
    assert snap.sections["pool.k"].dtype == torch.bfloat16
    assert torch.equal(snap.sections["pool.k"].view(torch.int16),
                       eng.pool.k.view(torch.int16))
    fresh = _engine(cfg, params, kv_dtype="bf16")
    apply_snapshot(fresh, snap)
    for name in ("k", "v"):
        assert torch.equal(getattr(fresh.pool, name).view(torch.int16),
                           getattr(eng.pool, name).view(torch.int16))
    assert _streams(fresh.run()) == _streams(eng.run())


# ---------------------------------------------------------------------------
# Journal durability: CRCs, torn tails, anchors, compaction, fsync
# ---------------------------------------------------------------------------


def _journal(path, fsync="interval", **kw):
    j = Journal(path=str(path), clock=ManualClock(tick=0.25),
                fsync=fsync, **kw)
    j.append("submit", rid=0, prompt_len=3, max_new=4, prompt=[5, 6, 7])
    j.append("placement", rid=0, replica=0, engine_rid=0, attempt=0,
             reason="submit", resume_base=0)
    j.append("token", rid=0, replica=0, pos=0, toks=[11, 12])
    j.append("submit", rid=1, prompt_len=2, max_new=2, prompt=[8, 9])
    j.append("token", rid=0, replica=0, pos=2, toks=[13, 14])
    j.append("terminal", rid=0, reason="length", n_tokens=4)
    return j


class TestJournalDurability:
    def test_records_carry_seq_and_crc(self, tmp_path):
        p = tmp_path / "wal.jsonl"
        j = _journal(p)
        j.close()
        lines = [json.loads(x) for x in open(p) if x.strip()]
        assert [r["seq"] for r in lines] == list(range(len(lines)))
        assert all(isinstance(r["crc"], int) for r in lines)
        loaded = Journal.load(str(p))          # strict: everything valid
        assert loaded.tail_lost == 0 and loaded.dups_dropped == 0
        assert [r["kind"] for r in loaded.records] == \
            [r["kind"] for r in j.records]

    def test_bitflip_detected_by_crc(self, tmp_path):
        p = tmp_path / "wal.jsonl"
        _journal(p).close()
        lines = open(p).read().splitlines()
        # flip a token value in a middle record: still valid JSON+seq,
        # only the CRC can catch it
        lines[2] = lines[2].replace("11", "91", 1)
        (tmp_path / "evil.jsonl").write_text("\n".join(lines) + "\n")
        with pytest.raises(JournalCorrupt, match="line 3"):
            Journal.load(str(tmp_path / "evil.jsonl"))
        j = Journal.load(str(tmp_path / "evil.jsonl"), strict=False)
        # valid-prefix semantics: everything from the flipped record on
        # is dropped, not resurrected
        assert [r["kind"] for r in j.records] == ["submit", "placement"]
        assert j.tail_lost == 4
        j.replay()                             # prefix is a legal history

    def test_torn_and_garbage_tails(self, tmp_path):
        p = tmp_path / "wal.jsonl"
        _journal(p).close()
        for tail in ('{"kind": "tok',          # torn mid-record write
                     "\x00\x00garbage\n",      # preallocated junk
                     '{"kind": "token"}\n{"a"'):   # missing crc + torn
            q = tmp_path / "torn.jsonl"
            q.write_text(open(p).read() + tail)
            with pytest.raises(JournalCorrupt):
                Journal.load(str(q))
            j = Journal.load(str(q), strict=False)
            assert len(j.records) == 6
            assert j.tail_lost >= 1
            st = j.replay()
            assert st.requests[0].tokens == [11, 12, 13, 14]

    def test_duplicate_records_dropped(self, tmp_path):
        p = tmp_path / "wal.jsonl"
        _journal(p).close()
        lines = open(p).read().splitlines(keepends=True)
        dup = "".join(lines[:3] + [lines[2]] + lines[3:])   # replayed write
        q = tmp_path / "dup.jsonl"
        q.write_text(dup)
        with pytest.raises(JournalCorrupt, match="seq"):
            Journal.load(str(q))
        j = Journal.load(str(q), strict=False)
        assert j.dups_dropped == 1
        assert len(j.records) == 6             # the dup is dropped, the
        st = j.replay()                        # suffix after it is kept
        assert st.requests[0].tokens == [11, 12, 13, 14]

    def test_anchor_compaction_and_from_anchor(self, tmp_path):
        p = tmp_path / "wal.jsonl"
        j = _journal(p)
        full = state_digest(j.replay())
        j.anchor(note="mid")
        j.append("submit", rid=2, prompt_len=2, max_new=2, prompt=[3, 4])
        j.append("token", rid=2, replica=0, pos=0, toks=[5])
        # anchored replay == full replay
        assert state_digest(j.replay(from_anchor=True)) == \
            state_digest(j.replay())
        dropped = j.compact()
        assert dropped == 6                    # pre-anchor records gone
        assert j.records[0]["kind"] == "snapshot"
        j.close()
        loaded = Journal.load(str(p))          # compacted file stands alone
        st = loaded.replay()
        assert st.requests[0].tokens == [11, 12, 13, 14]
        assert st.requests[2].tokens == [5]
        assert full["requests"]["0"] == \
            state_digest(st)["requests"]["0"]

    def test_anchor_digest_mismatch_rejected(self, tmp_path):
        j = _journal(tmp_path / "wal.jsonl")
        j.anchor()
        j.records[-1]["digest"]["requests"]["0"]["tokens"] = [9, 9]
        with pytest.raises(JournalCorrupt, match="disagrees"):
            j.replay()

    def test_fsync_policies(self, tmp_path):
        for policy in ("none", "interval", "always"):
            j = _journal(tmp_path / f"{policy}.jsonl", fsync=policy)
            j.close()
            assert len(Journal.load(str(tmp_path / f"{policy}.jsonl"))
                       .records) == 6
        with pytest.raises(ValueError, match="fsync"):
            Journal(path=str(tmp_path / "x.jsonl"), fsync="sometimes")


# ---------------------------------------------------------------------------
# Snapshot container: checksums + corruption detection (no engine needed)
# ---------------------------------------------------------------------------


class TestSnapshotContainer:
    def _snap(self):
        return Snapshot(meta={"fingerprint": {"demo": 1}},
                        sections={"arr": torch.arange(24, dtype=torch.int32)
                                  .reshape(4, 6),
                                  "bf16": torch.linspace(
                                      -3, 3, 10).to(torch.bfloat16),
                                  "meta": {"free": [1, 2], "clock": 7}})

    def test_roundtrip_and_atomic_write(self, tmp_path):
        p = str(tmp_path / "s.snap")
        info = self._snap().write(p)
        assert info["sections"] == ["arr", "bf16", "meta"]
        assert os.path.getsize(p) == info["nbytes"]
        assert not [f for f in os.listdir(tmp_path)
                    if f.startswith(".snap.")]     # no temp litter
        _sections_equal(self._snap(), Snapshot.read(p))

    def test_container_bytes_match_the_reference(self, tmp_path):
        """The same sections write the reference's bytes, and either
        package reads the other's container."""
        arr = np.arange(24, dtype=np.int32).reshape(4, 6)
        meta = {"free": [1, 2], "clock": 7}
        a, b = str(tmp_path / "p.snap"), str(tmp_path / "j.snap")
        Snapshot(meta={"x": 1}, sections={
            "arr": torch.from_numpy(arr), "meta": meta}).write(a)
        jserve.Snapshot(meta={"x": 1}, sections={
            "arr": arr, "meta": meta}).write(b)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert torch.equal(Snapshot.read(b).sections["arr"],
                           torch.from_numpy(arr))
        assert np.array_equal(jserve.Snapshot.read(a).sections["arr"], arr)

    def test_corruption_is_detected(self, tmp_path):
        p = str(tmp_path / "s.snap")
        self._snap().write(p)
        blob = bytearray(open(p, "rb").read())
        for mutation, match in (
                (lambda b: b[-8:-4] == b"\x00" * 4 or
                 b.__setitem__(slice(-8, -4), b"\xff\xff\xff\xff"),
                 "checksum mismatch in section"),
                (lambda b: b.__setitem__(slice(0, 3), b"XXX"),
                 "bad magic"),
                (lambda b: b.__setitem__(slice(len(b) - 2, len(b)), b""),
                 "truncated"),):
            bad = bytearray(blob)
            mutation(bad)
            q = str(tmp_path / "bad.snap")
            open(q, "wb").write(bytes(bad))
            with pytest.raises(SnapshotCorrupt, match=match):
                Snapshot.read(q)

    def test_header_tamper_detected(self, tmp_path):
        p = str(tmp_path / "s.snap")
        self._snap().write(p)
        blob = open(p, "rb").read()
        nl = blob.find(b"\n")
        tampered = blob[:nl + 1] + \
            blob[nl + 1:].replace(b'"version": 1', b'"version": 9', 1)
        open(p, "wb").write(tampered)
        with pytest.raises(SnapshotCorrupt, match="header checksum"):
            Snapshot.read(p)


# ---------------------------------------------------------------------------
# Engine snapshot/restore: byte-identical continuation
# ---------------------------------------------------------------------------


class TestEngineSnapshot:
    def _mid_workload(self, cfg, params, **kw):
        """An engine a few steps into a shared-prefix workload, with
        requests in every interesting phase."""
        eng = _engine(cfg, params, **kw)
        for p in _shared_prompts(cfg, 3):
            eng.submit(p, 6)
        for _ in range(3):
            eng.step()
        return eng

    def test_restored_engine_continues_byte_identical(self, setup, tmp_path):
        cfg, params = setup
        eng = self._mid_workload(cfg, params)
        path = str(tmp_path / "mid.snap")
        write_snapshot(eng, path)

        fresh = _engine(cfg, params)
        apply_snapshot(fresh, Snapshot.read(path))
        check_invariants(fresh.pool, fresh.prefix_cache)
        # identical decode rows, queues, and generator stream -> identical
        assert _streams(fresh.run()) == _streams(eng.run())
        assert leaked_blocks(fresh.pool, fresh.prefix_cache) == 0

    def test_sampled_streams_continue_identically(self, setup, tmp_path):
        """The generator state travels: temperature-sampled requests
        continue with the same draws."""
        cfg, params = setup
        eng = _engine(cfg, params, seed=3)
        for p in _shared_prompts(cfg, 3, seed=8):
            eng.submit(p, 6, temperature=1.0)
        for _ in range(3):
            eng.step()
        path = str(tmp_path / "sampled.snap")
        write_snapshot(eng, path)
        fresh = _engine(cfg, params, seed=99)
        apply_snapshot(fresh, Snapshot.read(path))
        assert _streams(fresh.run()) == _streams(eng.run())

    def test_midcow_state_roundtrips(self, setup, tmp_path):
        cfg, params = setup
        eng = _engine(cfg, params)
        prompts = _shared_prompts(cfg, 4, seed=11)
        eng.submit(prompts[0], 4)
        eng.run()                        # publish the shared prefix
        for p in prompts[1:]:
            eng.submit(p, 4)             # re-hits COW the partial block
        steps = 0
        while eng.pool.stats.cow_copies == 0 and steps < 50:
            eng.step()
            steps += 1
        assert eng.pool.stats.cow_copies > 0
        path = str(tmp_path / "cow.snap")
        write_snapshot(eng, path)
        fresh = _engine(cfg, params)
        apply_snapshot(fresh, Snapshot.read(path))
        _sections_equal(snapshot_state(fresh), Snapshot.read(path))
        assert _streams(fresh.run()) == _streams(eng.run())

    def test_purged_pinned_nodes_snapshot_cleanly(self, setup, tmp_path):
        """purge() detaches tree nodes that other in-flight requests
        still pin (their pins unwind at release). The snapshot keeps only
        live-tree pins, so serializing a post-quarantine engine must
        neither crash nor restore an inconsistent tree."""
        cfg, params = setup
        eng = _engine(cfg, params)
        prompts = _shared_prompts(cfg, 3, seed=7)
        eng.submit(prompts[0], 4)
        eng.run()                        # publish the shared prefix
        victim = eng.submit(prompts[1], 4)
        eng.submit(prompts[2], 4)        # sibling pins the shared path
        eng.step()                       # admit + match both sharers
        assert eng.prefix_cache.purge(victim.req_id) > 0
        live = {id(n) for n in eng.prefix_cache._walk()}
        assert any(id(n) not in live
                   for pins in eng.prefix_cache._held.values()
                   for n in pins)        # a detached node IS still pinned
        path = str(tmp_path / "purged.snap")
        write_snapshot(eng, path)
        fresh = _engine(cfg, params)
        apply_snapshot(fresh, Snapshot.read(path))
        check_invariants(fresh.pool, fresh.prefix_cache)
        assert _streams(fresh.run()) == _streams(eng.run())
        assert leaked_blocks(fresh.pool, fresh.prefix_cache) == 0

    def test_int8_scale_siblings_roundtrip(self, setup, tmp_path):
        cfg, params = setup
        kw = dict(kv_dtype="int8")
        eng = self._mid_workload(cfg, params, **kw)
        path = str(tmp_path / "int8.snap")
        write_snapshot(eng, path)
        snap = Snapshot.read(path)
        assert "pool.k_scale" in snap.sections   # scales travel with KV
        assert "pool.v_scale" in snap.sections
        fresh = _engine(cfg, params, **kw)
        apply_snapshot(fresh, snap)
        _sections_equal(snapshot_state(fresh), snap)
        assert _streams(fresh.run()) == _streams(eng.run())

    def test_fingerprint_mismatch_rejected(self, setup, tmp_path):
        cfg, params = setup
        eng = self._mid_workload(cfg, params)
        path = str(tmp_path / "geom.snap")
        write_snapshot(eng, path)
        other = _engine(cfg, params, num_blocks=32)
        with pytest.raises(SnapshotCorrupt, match="fingerprint"):
            apply_snapshot(other, Snapshot.read(path))
        assert engine_fingerprint(other)["num_blocks"] == 32
        eng.run()

    def test_requeue_inflight_recompute_contract(self, setup, tmp_path):
        cfg, params = setup
        eng = self._mid_workload(cfg, params)
        reference = _streams(eng.run())  # uninterrupted oracle

        eng2 = self._mid_workload(cfg, params)   # same deterministic state
        path = str(tmp_path / "rq.snap")
        write_snapshot(eng2, path)

        fresh = _engine(cfg, params)
        apply_snapshot(fresh, Snapshot.read(path))
        specs = requeue_inflight(fresh)
        assert specs == sorted(specs, key=lambda s: s["rid"])
        assert leaked_blocks(fresh.pool, fresh.prefix_cache) == 0
        done = dict(fresh.pop_finished())        # finished-at-snapshot set
        emitted = {}
        for s in specs:                          # [prompt ‖ emitted] resume
            emitted[s["rid"]] = s["tokens"]
            h = fresh.submit(
                np.asarray(s["prompt"] + s["tokens"], np.int32),
                s["max_new"] - len(s["tokens"]),
                temperature=s["temperature"])
            emitted[h.req_id] = emitted.pop(s["rid"])
        for rid, req in fresh.run().items():
            done[rid] = req
        got = {}
        for rid, req in done.items():
            got[rid] = (emitted.get(rid, []) + list(req.tokens),
                        req.finish_reason)
        assert sorted(got.values()) == sorted(reference.values())
        assert leaked_blocks(fresh.pool, fresh.prefix_cache) == 0

    def test_restore_engine_cold_fallback_on_corruption(self, setup,
                                                        tmp_path):
        cfg, params = setup
        eng = self._mid_workload(cfg, params)
        path = str(tmp_path / "bad.snap")
        write_snapshot(eng, path)
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(path, "wb").write(bytes(blob))

        factory = lambda: _engine(cfg, params)   # noqa: E731
        restored, specs, info = restore_engine(factory, path)
        assert info["mode"] == "cold"
        assert "checksum" in info["reason"]
        assert specs == []
        # the fallback engine is pristine: no poisoned KV, no queues
        assert not restored.sched.running and not restored.sched.waiting
        assert leaked_blocks(restored.pool, restored.prefix_cache) == 0
        eng.run()

        restored2, _, info2 = restore_engine(
            factory, str(tmp_path / "nope.snap"))
        assert info2["mode"] == "cold" and "missing" in info2["reason"]


# ---------------------------------------------------------------------------
# Property: serialize -> deserialize is the identity on serving state
# ---------------------------------------------------------------------------

_OPS = ("submit_shared", "submit_fresh", "step", "step", "drain_one")


def _apply_ops(eng, cfg, ops, rng):
    for op in ops:
        try:
            if op == "submit_shared":
                eng.submit(_shared_prompts(cfg, 1, seed=3)[0]
                           if rng.random() < 0.5 else
                           _shared_prompts(cfg, 1, seed=4)[0], 4)
            elif op == "submit_fresh":
                eng.submit(rng.integers(1, cfg.vocab_size, (10,))
                           .astype(np.int32), 3)
            elif op == "step":
                eng.step()
            elif op == "drain_one":
                eng.drain()
                eng.pop_finished()
        except Exception:
            pass                         # capacity refusals are fine here


def _assert_roundtrip_identity(eng, spare, tmp_path, tag):
    """snapshot -> file -> snapshot must be the identity, and the restored
    state must satisfy every pool/radix invariant."""
    path = str(tmp_path / f"{tag}.snap")
    before = write_snapshot(eng, path)
    snap = Snapshot.read(path)
    requeue_inflight(spare)              # recycle the spare to idle
    spare.pop_finished()
    apply_snapshot(spare, snap)          # fsck: invariants on restore
    again = snapshot_state(spare)
    _sections_equal(snap, again)
    # and the re-serialized bytes index identically
    info = again.write(str(tmp_path / f"{tag}2.snap"))
    assert info["nbytes"] == before["nbytes"]


class TestSerializeDeserializeProperty:
    def test_seeded_roundtrip_identity(self, setup, tmp_path):
        """No-dependency fallback for the hypothesis property test below:
        a seeded sweep of random op schedules, checking at every prefix
        that serialize -> deserialize is the identity."""
        cfg, params = setup
        eng = _engine(cfg, params)
        spare = _engine(cfg, params)
        rng = np.random.default_rng(0)
        for i in range(6):
            _apply_ops(eng, cfg, rng.choice(_OPS, size=4), rng)
            _assert_roundtrip_identity(eng, spare, tmp_path, f"s{i}")

    def test_hypothesis_roundtrip_identity(self, setup, tmp_path):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st
        cfg, params = setup
        eng = _engine(cfg, params)
        spare = _engine(cfg, params)
        rng = np.random.default_rng(1)
        counter = iter(range(10 ** 6))

        @settings(max_examples=10, deadline=None)
        @given(st.lists(st.sampled_from(_OPS), min_size=1, max_size=6))
        def prop(ops):
            _apply_ops(eng, cfg, ops, rng)
            _assert_roundtrip_identity(eng, spare, tmp_path,
                                       f"h{next(counter)}")

        prop()


# ---------------------------------------------------------------------------
# Fleet warm restart
# ---------------------------------------------------------------------------


class TestFleetResume:
    def _run_and_abandon(self, cfg, params, tmp_path, ticks=4):
        """A supervised fleet some ticks into a workload, then simply
        dropped — the in-process stand-in for SIGKILL (restore_bench
        covers real process death)."""
        factory = lambda: _engine(cfg, params)   # noqa: E731
        prompts = _shared_prompts(cfg, 3, seed=9)

        ref = FleetSupervisor([factory()], router=Router("affinity"),
                              max_attempts=100)
        for p in prompts:
            ref.submit(p, 6)
        ref.run_until_drained()
        reference = {rid: (list(t.result.tokens), t.result.finish_reason)
                     for rid, t in ref.tracker.requests.items()}

        jpath = str(tmp_path / "wal.jsonl")
        sdir = str(tmp_path / "snaps")
        sup = FleetSupervisor(
            [factory()], router=Router("affinity"), max_attempts=100,
            journal=Journal(path=jpath, fsync="always"),
            snapshot_dir=sdir, snapshot_every=2)
        for p in prompts:
            sup.submit(p, 6)
        for _ in range(ticks):
            sup.tick()
        assert sup.has_work()            # died mid-flight, not drained
        assert int(sup.c_snapshots.value) >= 1
        return factory, jpath, sdir, reference

    def test_resume_warm_byte_identical(self, setup, tmp_path):
        cfg, params = setup
        factory, jpath, sdir, reference = self._run_and_abandon(
            cfg, params, tmp_path)
        newj = Journal(path=str(tmp_path / "wal2.jsonl"))
        sup = FleetSupervisor.resume(
            factory, 1, jpath, snapshot_dir=sdir, journal=newj,
            router=Router("affinity"), max_attempts=100)
        assert sup.restore_info[0]["mode"] == "warm"
        assert int(sup.tracker.c_recovered.value) == len(reference)
        sup.run_until_drained()
        got = {rid: (list(t.result.tokens), t.result.finish_reason)
               for rid, t in sup.tracker.requests.items()}
        assert got == reference
        eng = sup.replicas[0].engine
        assert leaked_blocks(eng.pool, eng.prefix_cache) == 0
        # the new journal replays to exactly the delivered streams
        st = replay(newj.records)
        assert {r: (list(v.tokens), v.finish_reason)
                for r, v in st.requests.items()} == reference

    def test_resume_without_snapshots_is_cold_but_correct(self, setup,
                                                          tmp_path):
        cfg, params = setup
        factory, jpath, _sdir, reference = self._run_and_abandon(
            cfg, params, tmp_path)
        sup = FleetSupervisor.resume(
            factory, 1, jpath, snapshot_dir=None,
            router=Router("affinity"), max_attempts=100)
        assert sup.restore_info[0]["mode"] == "cold"
        sup.run_until_drained()
        got = {rid: (list(t.result.tokens), t.result.finish_reason)
               for rid, t in sup.tracker.requests.items()}
        assert got == reference          # journal-only recompute suffices


# ---------------------------------------------------------------------------
# restore_bench: its in-process pieces, then its SIGKILL CLI
# ---------------------------------------------------------------------------


def test_restore_bench_pieces_in_process(setup, tmp_path):
    """Each kill case in process: serve to the kill condition with a
    snapshot a tick and a journal, abandon the supervisor, recover warm
    (fsck clean, no leak, the new journal equal to the streams) and match
    the uninterrupted run; a corrupted snapshot recovers cold to the same
    streams."""
    from repro_torch.benchmarks import restore_bench as rb
    cfg, params = setup
    for case in rb.KILL_CASES:
        adir = str(tmp_path / case)
        os.makedirs(adir)
        arrivals = rb.case_workload(case, cfg.vocab_size, 41, 4)
        factory = rb.make_factory(cfg, params, case, 6, device="cpu")
        ref = rb.streams_of(rb.drive(rb.build_fleet(factory, case),
                                     arrivals, 6))
        sup = rb.build_fleet(
            factory, case, journal=Journal(
                path=os.path.join(adir, "journal.jsonl"), fsync="always"),
            snapshot_dir=os.path.join(adir, "snaps"), snapshot_every=1)
        rb.drive(sup, arrivals, 6, kill_case=case, stop_at_kill=True)
        assert rb.kill_condition(case, sup)
        del sup                                  # abandoned unflushed
        got, info = rb.recover(
            factory, case, adir, arrivals, 6,
            snapshot_dir=os.path.join(adir, "snaps"),
            journal_out=os.path.join(adir, "recovered.jsonl"))
        assert info["mode"] == "warm" and info["leaked"] == 0
        assert info["journal_matches_streams"]
        assert rb.streams_of(got) == ref, case
        if case == "postquarantine":
            assert "quarantined" in {w for _, w in ref.values()}
    rb.corrupt_snapshot(str(tmp_path / "midcow" / "snaps" / "replica0.snap"))
    factory = rb.make_factory(cfg, params, "midcow", 6, device="cpu")
    arrivals = rb.case_workload("midcow", cfg.vocab_size, 41, 4)
    ref = rb.streams_of(rb.drive(rb.build_fleet(factory, "midcow"),
                                 arrivals, 6))
    got, info = rb.recover(factory, "midcow", str(tmp_path / "midcow"),
                           arrivals, 6, snapshot_dir=str(
                               tmp_path / "midcow" / "snaps"))
    assert info["mode"] == "cold" and "checksum" in info["reason"]
    assert rb.streams_of(got) == ref


def test_restore_bench_cli_smoke(tmp_path, capsys):
    """The CLI at --smoke on the CPU: three real SIGKILLed children, warm
    recovery, the corrupted snapshot's cold fallback, warm against cold;
    every gate met."""
    from repro_torch.benchmarks import restore_bench as rb
    assert rb.parse_args([]).device == "cuda"
    ratio = rb.main(["--smoke", "--device", "cpu", "--artifacts",
                     str(tmp_path / "art"), "--out",
                     str(tmp_path / "rec.json")])
    out = capsys.readouterr().out
    assert ratio > 1.0
    rec = json.load(open(tmp_path / "rec.json"))
    assert rec["gates_passed"] and rec["backend"] == "cpu"
    for case in rb.KILL_CASES:
        assert rec["kill_cases"][case]["child_rc"] == -signal.SIGKILL
        assert f"restore,{case},mode,warm" in out
    assert rec["corrupted_snapshot"]["mode"] == "cold"
