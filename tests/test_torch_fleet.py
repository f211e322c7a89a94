"""The port's fleet layer against the JAX package's, on the CPU.

Weights: reduced qwen3-4b in float32 from the reference's
``model_fns(cfg).init`` bridged through numpy; block 8, ``ManualClock``
time in both packages. Tolerances, per check:

* EXACT: ``Router.place`` decisions and the ``decisions`` log over a
  seeded sequence of replica states (guard states, loads, free and
  evictable blocks, prefix hits), both policies; journal records written
  by either package load and replay in the other (``state_digest``, CRCs,
  torn-tail and duplicate counts, anchors, ``compact``).
* EXACT, a lockstep fleet drive: a JAX fleet and a port fleet of 3
  replicas under ``canned_fleet_plan`` (a crash and a hang), the same
  arrivals, ``step_parallel=False``: the journal record for record (``t``,
  ``seq`` and ``crc`` included), streams and finish reasons, ticks,
  ``c_crashed``, ``c_hung``, failovers and retries, the tracker's registry
  text.
* The reference's behaviour tests (``tests/test_fleet.py``), run against
  the port: journal, front end, router, failover (crash, hang + rejoin,
  an organic engine death), migration stamps, collect under failover,
  shedding backoff; each greedy stream EXACTLY the single engine's.
* ``fleet_bench --smoke --device cpu``: its gates; the launcher's
  ``--replicas 2 --fleet-fault-plan canned --journal-out --snapshot-dir``,
  then ``--resume``: its ``fleet[...]`` and ``resume:`` lines equal the
  supervisor's counters.
"""
import asyncio
import dataclasses
import json
import logging
import re
import sys

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as pserve
from repro.serve import journal as jax_journal
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import (ContinuousEngine, EngineGuard,
                               EngineSheddingError, FaultInjector, FaultPlan,
                               FaultSpec, FleetSupervisor, GuardConfig,
                               GuardSignals, Journal, JournalCorrupt,
                               ManualClock, MetricRegistry, Router, Telemetry,
                               canned_fleet_plan, leaked_blocks, replay,
                               state_digest)
from repro_torch.serve import journal as port_journal
from repro_torch.serve import router as port_router
from repro_torch.serve.frontend import AsyncFrontend
from repro_torch.serve.guard import DEGRADED, HEALTHY, SHEDDING
from repro_torch.serve.supervisor import DEAD, SERVING

TICK = 1e-4


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
    """The reference test's engine geometry, on the CPU."""
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 48)
    kw.setdefault("retry_backoff_s", 0.0)
    return ContinuousEngine(cfg, params, device="cpu", **kw)


def _prompt(cfg, n, seed=41):
    return np.random.default_rng(seed + 7 * n).integers(
        1, cfg.vocab_size, (n,)).astype(np.int32)


def _prompts(cfg, count, n=8, seed=41):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
            for _ in range(count)]


def _reference_streams(cfg, params, prompts, max_new, **kw):
    """Greedy streams of an unfailed single-engine run (the byte-identity
    oracle: placement never changes greedy output)."""
    eng = _engine(cfg, params, **kw)
    handles = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    return [list(res[h.req_id].tokens) for h in handles]


# -- the router over a seeded sequence of replica states (host only) ---------

class _Guard:
    def __init__(self, state):
        self.state = state


class _Cache:
    def __init__(self, hit, evictable):
        self.hit, self.evictable = hit, evictable

    def lookup(self, prompt):
        return self.hit

    def evictable_blocks(self):
        return self.evictable


class _Replica:
    """What ``Router.place`` reads of a supervisor ``ReplicaHandle``."""

    def __init__(self, idx, accepting, guard, cache, num_free, load):
        self.idx, self.accepting = idx, accepting
        sched = type("S", (), {"waiting": [0] * load, "running": []})()
        pool = type("P", (), {"num_free": num_free})()
        self.engine = type("E", (), {"guard": guard, "prefix_cache": cache,
                                     "pool": pool, "sched": sched})()


def _replica_states(seed, steps=300, n=4):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield [_Replica(
            i, bool(rng.random() > 0.15),
            None if rng.random() < 0.3 else _Guard(
                (HEALTHY, DEGRADED, SHEDDING)[rng.integers(0, 3)]),
            None if rng.random() < 0.1 else _Cache(
                int(rng.integers(0, 4)) * 8, int(rng.integers(0, 5))),
            int(rng.integers(0, 6)), int(rng.integers(0, 3)))
            for i in range(n)]


@pytest.mark.parametrize("policy", ["affinity", "round-robin"])
def test_router_decisions_match_jax(policy):
    jr, pr = jserve.Router(policy), Router(policy)
    prompt = np.arange(1, 17, dtype=np.int32)
    picks = []
    for replicas in _replica_states(7 if policy == "affinity" else 8):
        a, b = jr.place(prompt, replicas), pr.place(prompt, replicas)
        assert (a is None) == (b is None)
        assert a is None or a.idx == b.idx
        picks.append(None if a is None else a.idx)
    assert [dataclasses.asdict(d) for d in jr.decisions] == \
        [dataclasses.asdict(d) for d in pr.decisions]
    # the walk reached every outcome: refusals, demotions and each replica
    assert None in picks and set(picks) >= {0, 1, 2, 3}
    assert any(d.demoted for d in pr.decisions)
    assert port_router.ROUTING_POLICIES == jserve.ROUTING_POLICIES


# -- the journal across the packages (host only) -----------------------------

def _write(mod, path, anchor=False):
    j = mod.Journal(path=str(path), clock=ManualClock(tick=0.25))
    j.append("submit", rid=0, prompt_len=3, max_new=4, prompt=[5, 6, 7])
    j.append("placement", rid=0, replica=0, engine_rid=0, attempt=0,
             reason="submit", resume_base=0)
    j.append("token", rid=0, replica=0, pos=0, toks=[11, 12])
    j.append("submit", rid=1, prompt_len=2, max_new=2, prompt=[8, 9])
    j.append("replica", replica=0, event="crash", tick=3)
    j.append("placement", rid=0, replica=1, engine_rid=2, attempt=1,
             reason="crash", resume_base=2)
    if anchor:
        j.anchor(tick=4, replicas=["r1"])
    j.append("token", rid=0, replica=1, pos=2, toks=[13, 14])
    j.append("terminal", rid=0, reason="length", n_tokens=4)
    j.close()
    return j


@pytest.mark.parametrize("anchor", [False, True], ids=["plain", "anchored"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_files_cross_load_and_replay(tmp_path, writer, anchor):
    w, r = (jserve, port_journal) if writer == "jax" else \
        (port_journal, jserve)
    jj = _write(jserve, tmp_path / "j.jsonl", anchor)
    pj = _write(port_journal, tmp_path / "p.jsonl", anchor)
    assert (tmp_path / "j.jsonl").read_bytes() == \
        (tmp_path / "p.jsonl").read_bytes()
    assert jj.records == pj.records
    path = tmp_path / ("j.jsonl" if writer == "jax" else "p.jsonl")
    loaded = r.Journal.load(str(path))
    assert loaded.records == w.Journal.load(str(path)).records
    assert r.state_digest(loaded.replay()) == \
        w.state_digest(w.Journal.load(str(path)).replay())
    assert r.state_digest(loaded.replay(from_anchor=True)) == \
        r.state_digest(loaded.replay())
    for rec in loaded.records:
        body = {k: v for k, v in rec.items() if k != "crc"}
        assert port_journal.record_crc(body) == \
            jax_journal.record_crc(body) == rec["crc"]
    if anchor:
        a, b = jj.compact(), pj.compact()
        assert a == b == 6 and jj.records == pj.records
        assert (tmp_path / "j.jsonl").read_bytes() == \
            (tmp_path / "p.jsonl").read_bytes()


@pytest.mark.parametrize("damage", ["torn", "garbage", "bitflip", "dup"])
def test_journal_recovery_counts_match_jax(tmp_path, damage):
    _write(jserve, tmp_path / "w.jsonl")
    lines = (tmp_path / "w.jsonl").read_text().splitlines(keepends=True)
    if damage == "torn":
        text = "".join(lines) + '{"kind": "tok'
    elif damage == "garbage":
        text = "".join(lines) + "\x00\x00garbage\n"
    elif damage == "bitflip":
        lines[2] = lines[2].replace("11", "91", 1)
        text = "".join(lines)
    else:
        text = "".join(lines[:3] + [lines[2]] + lines[3:])
    (tmp_path / "bad.jsonl").write_text(text)
    with pytest.raises(port_journal.JournalCorrupt):
        port_journal.Journal.load(str(tmp_path / "bad.jsonl"))
    a = jserve.Journal.load(str(tmp_path / "bad.jsonl"), strict=False)
    b = port_journal.Journal.load(str(tmp_path / "bad.jsonl"), strict=False)
    assert (a.records, a.tail_lost, a.dups_dropped) == \
        (b.records, b.tail_lost, b.dups_dropped)
    assert state_digest(b.replay()) == jserve.state_digest(a.replay())


# -- the lockstep fleet drive against the JAX package ------------------------

def _fleet_drive(mod, cfg, params, prompts, **kw):
    """Three replicas on one ManualClock under the canned fleet plan
    (replica 0 crashes at tick 3, replica 1 hangs at tick 5 for 3 ticks),
    a journal on the same clock, arrivals two a tick, one thread."""
    clock = mod.ManualClock(tick=TICK)
    engines = [mod.ContinuousEngine(
        cfg, params, block_size=8, num_blocks=24, max_batch=3, max_len=48,
        retry_backoff_s=0.0, clock=clock, telemetry=mod.Telemetry(clock=clock),
        **kw) for _ in range(3)]
    journal = mod.Journal(clock=clock)
    sup = mod.FleetSupervisor(
        engines, journal=journal, clock=clock, hang_grace_ticks=2,
        faults=mod.FaultInjector(mod.canned_fleet_plan(
            crash_tick=3, hang_tick=5, hang_ticks=3)),
        check_invariants_each_tick=True, step_parallel=False)
    treqs = []
    for i in range(0, len(prompts), 2):
        treqs += [sup.submit(p, 8) for p in prompts[i:i + 2]]
        sup.tick()
    sup.run_until_drained(max_ticks=500)
    return sup, treqs, journal


@pytest.fixture(scope="module")
def lockstep(qwen):
    jcfg, tcfg, jparams, tparams = qwen
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, jcfg.vocab_size, (9,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(
        1, jcfg.vocab_size, (n,)).astype(np.int32)]) if i % 2 else
        rng.integers(1, jcfg.vocab_size, (8 + n,)).astype(np.int32)
        for i, n in enumerate((1, 4, 2, 5, 3, 1, 4, 2))]
    return (_fleet_drive(jserve, jcfg, jparams, prompts),
            _fleet_drive(pserve, tcfg, tparams, prompts, device="cpu"))


def test_lockstep_fleet_journal_exact(lockstep):
    (_, _, jj), (_, _, pj) = lockstep
    assert len(pj.records) > 50
    assert pj.records == jj.records           # t, seq and crc included
    kinds = {r["kind"] for r in pj.records}
    assert kinds == {"submit", "placement", "token", "terminal", "replica"}
    events = [r["event"] for r in pj.records if r["kind"] == "replica"]
    assert events == ["crash", "hang", "resume"]


def test_lockstep_fleet_streams_and_counters_exact(lockstep):
    (js, jt, _), (ps, pt, _) = lockstep
    assert [(t.result.tokens, t.result.finish_reason, t.n_failovers,
             t.replicas) for t in pt] == \
        [(t.result.tokens, t.result.finish_reason, t.n_failovers,
          t.replicas) for t in jt]
    assert all(t.result.ok for t in pt)
    assert ps.ticks == js.ticks
    for name in ("c_crashed", "c_hung", "g_alive"):
        assert getattr(ps, name).value == getattr(js, name).value, name
    assert ps.c_crashed.value == 1 and ps.c_hung.value == 1
    for name in ("c_failovers", "c_retries", "c_completed", "c_tokens"):
        assert getattr(ps.tracker, name).value == \
            getattr(js.tracker, name).value, name
    assert ps.tracker.c_failovers.value > 0
    assert ps.tracker.registry.prometheus_text() == \
        js.tracker.registry.prometheus_text()
    assert [dataclasses.asdict(d) for d in ps.router.decisions] == \
        [dataclasses.asdict(d) for d in js.router.decisions]
    assert ps.collect_metrics().prometheus_text() == \
        js.collect_metrics().prometheus_text()


# ---------------------------------------------------------------------------
# The reference's behaviour tests (tests/test_fleet.py), on the port
# ---------------------------------------------------------------------------


class TestJournal:
    def test_append_validates_kind_and_file_roundtrip(self, tmp_path):
        p = tmp_path / "wal.jsonl"
        j = Journal(path=str(p), clock=ManualClock(tick=0.5))
        with pytest.raises(ValueError, match="unknown journal record"):
            j.append("telegram", rid=0)
        j.append("submit", rid=0, prompt_len=4, max_new=2, prompt=[1, 2, 3, 4])
        j.append("placement", rid=0, replica=1, engine_rid=0, attempt=0,
                 reason="submit", resume_base=0)
        j.append("token", rid=0, replica=1, pos=0, toks=[7, 8])
        j.append("terminal", rid=0, reason="length", n_tokens=2)
        j.close()
        loaded = Journal.load(str(p))
        assert loaded.records == j.records       # WAL is flushed per append
        st = loaded.replay()
        assert st.requests[0].tokens == [7, 8]
        assert st.requests[0].finish_reason == "length"
        assert st.requests[0].placements[0]["reason"] == "submit"
        assert st.terminal.keys() == {0}

    def test_replay_rejects_impossible_histories(self):
        base = [dict(kind="submit", rid=0, prompt_len=4, max_new=4, t=0.0)]
        with pytest.raises(JournalCorrupt, match="pos 2"):
            replay(base + [dict(kind="token", rid=0, replica=0, pos=2,
                                toks=[1], t=0.1)])
        with pytest.raises(JournalCorrupt, match="terminal claims"):
            replay(base + [dict(kind="terminal", rid=0, reason="length",
                                n_tokens=3, t=0.1)])
        with pytest.raises(JournalCorrupt, match="after its terminal"):
            replay(base
                   + [dict(kind="terminal", rid=0, reason="length",
                           n_tokens=0, t=0.1),
                      dict(kind="token", rid=0, replica=0, pos=0, toks=[1],
                           t=0.2)])
        with pytest.raises(JournalCorrupt, match="submitted twice"):
            replay(base + base)
        with pytest.raises(JournalCorrupt, match="unknown request"):
            replay([dict(kind="token", rid=9, replica=0, pos=0, toks=[1],
                         t=0.0)])

    def test_failover_count_from_placements(self):
        st = replay([
            dict(kind="submit", rid=0, prompt_len=2, max_new=4, t=0.0),
            dict(kind="placement", rid=0, replica=0, engine_rid=0,
                 attempt=0, reason="submit", resume_base=0, t=0.0),
            dict(kind="placement", rid=0, replica=1, engine_rid=1,
                 attempt=1, reason="crash", resume_base=2, t=0.2),
        ])
        assert st.requests[0].n_failovers == 1


class TestAsyncFrontend:
    def test_stream_and_typed_result(self, setup):
        cfg, params = setup
        prompt = _prompt(cfg, 8)
        ref = _reference_streams(cfg, params, [prompt], 4)[0]
        sup = FleetSupervisor([_engine(cfg, params) for _ in range(2)])
        fe = AsyncFrontend(sup)

        async def drive():
            stream = await fe.submit(prompt, 4)
            runner = asyncio.ensure_future(fe.run())
            got = [tok async for tok in stream]
            fe.close()
            await runner
            return got, stream.result()

        got, result = asyncio.run(drive())
        assert got == ref == result.tokens
        assert result.ok and result.finish_reason == "length"
        assert result.n_failovers == 0 and len(result.replicas) == 1

    def test_run_until_drained_sync_consumption(self, setup):
        cfg, params = setup
        prompts = _prompts(cfg, 3)
        ref = _reference_streams(cfg, params, prompts, 4)
        sup = FleetSupervisor([_engine(cfg, params) for _ in range(2)])
        fe = AsyncFrontend(sup)

        async def drive():
            streams = [await fe.submit(p, 4) for p in prompts]
            await fe.run_until_drained()
            return streams

        streams = asyncio.run(drive())
        assert [s.drain_nowait() for s in streams] == ref
        assert all(s.finished for s in streams)


class TestRouter:
    def _fleet(self, cfg, params, n=3):
        return FleetSupervisor([_engine(cfg, params) for _ in range(n)])

    def test_affinity_prefers_the_replica_holding_the_prefix(self, setup):
        cfg, params = setup
        sup = self._fleet(cfg, params)
        prompt = _prompt(cfg, 16)
        # serve the prompt once through replica 1 only, so only its radix
        # tree holds the prefix
        sup.replicas[1].engine.submit(prompt, 2)
        sup.replicas[1].engine.run()
        follow_up = np.concatenate([prompt, _prompt(cfg, 4)])
        r = Router("affinity")
        chosen = r.place(follow_up, sup.replicas)
        assert chosen.idx == 1
        assert r.decisions[-1].affinity_tokens >= 8   # >= one block

    def test_cold_fleet_falls_back_to_load_then_budget(self, setup):
        cfg, params = setup
        sup = self._fleet(cfg, params)
        # load replica 0 with queued work: the cold prompt must avoid it
        sup.replicas[0].engine.submit(_prompt(cfg, 8), 4)
        r = Router("affinity")
        chosen = r.place(_prompt(cfg, 9), sup.replicas)
        assert chosen.idx != 0
        assert r.decisions[-1].affinity_tokens == 0

    def test_degraded_is_demoted_shedding_and_dead_are_skipped(self, setup):
        cfg, params = setup
        guards = [EngineGuard(), EngineGuard(), EngineGuard()]
        engines = [_engine(cfg, params, guard=g) for g in guards]
        sup = FleetSupervisor(engines)
        prompt = _prompt(cfg, 16)
        # replica 0 holds the prefix but is DEGRADED: healthy replicas win
        engines[0].submit(prompt, 2)
        engines[0].run()
        guards[0].observe(GuardSignals(pool_util=0.9))
        r = Router("affinity")
        assert r.place(prompt, sup.replicas).idx != 0
        assert not r.decisions[-1].demoted
        # all healthy candidates gone: the degraded one is still usable
        guards[1].observe(GuardSignals(pool_util=1.0))   # SHEDDING
        sup.replicas[2].state = DEAD
        chosen = r.place(prompt, sup.replicas)
        assert chosen.idx == 0 and r.decisions[-1].demoted
        # nothing accepting at all -> None
        guards[0].observe(GuardSignals(pool_util=1.0))
        assert r.place(prompt, sup.replicas) is None

    def test_round_robin_cycles_over_accepting_replicas(self, setup):
        cfg, params = setup
        sup = self._fleet(cfg, params)
        r = Router("round-robin")
        order = [r.place(_prompt(cfg, 4), sup.replicas).idx
                 for _ in range(6)]
        assert order == [0, 1, 2, 0, 1, 2]
        sup.replicas[1].state = DEAD
        order = [r.place(_prompt(cfg, 4), sup.replicas).idx
                 for _ in range(4)]
        assert order == [0, 2, 0, 2]
        with pytest.raises(ValueError, match="unknown routing policy"):
            Router("dartboard")


class TestFailover:
    def test_crash_replaces_in_flight_requests_byte_identically(
            self, setup, tmp_path):
        cfg, params = setup
        prompts = _prompts(cfg, 6)
        ref = _reference_streams(cfg, params, prompts, 8)
        jr = Journal(path=str(tmp_path / "wal.jsonl"))
        sup = FleetSupervisor(
            [_engine(cfg, params) for _ in range(3)],
            journal=jr,
            faults=FaultInjector(canned_fleet_plan(crash_tick=2,
                                                   hang_tick=None)),
            check_invariants_each_tick=True)
        treqs = [sup.submit(p, 8) for p in prompts]
        sup.run_until_drained(max_ticks=500)
        assert [t.result.tokens for t in treqs] == ref
        assert all(t.result.ok for t in treqs)
        assert sup.replicas[0].state == DEAD
        assert sup.c_crashed.value == 1
        assert sup.g_alive.value == 2
        # the crash actually displaced work (the failover path ran)
        moved = [t for t in treqs if t.n_failovers]
        assert moved and all(0 in t.replicas and t.replicas[-1] != 0
                             for t in moved)
        assert sup.tracker.c_failovers.value == len(moved)
        # zero leaked blocks on every SURVIVING pool
        for r in sup.replicas:
            if r.state == SERVING:
                assert leaked_blocks(r.engine.pool,
                                     r.engine.prefix_cache) == 0
        # journal replay reconstructs the tracker's terminal state exactly
        st = Journal.load(str(tmp_path / "wal.jsonl")).replay()
        for t in treqs:
            assert st.requests[t.rid].tokens == t.result.tokens
            assert st.requests[t.rid].finish_reason == \
                t.result.finish_reason
            assert st.requests[t.rid].n_failovers == t.n_failovers
        assert [e["event"] for e in st.replica_events] == ["crash"]

    @pytest.mark.parametrize("step_parallel", [False, True],
                             ids=["one_thread", "threads"])
    def test_hang_watchdog_fails_over_then_replica_rejoins(
            self, setup, step_parallel):
        cfg, params = setup
        prompts = _prompts(cfg, 4, seed=43)
        ref = _reference_streams(cfg, params, prompts, 10)
        sup = FleetSupervisor(
            [_engine(cfg, params) for _ in range(2)],
            faults=FaultInjector(canned_fleet_plan(
                crash_tick=10_000,        # no crash in this test
                hang_tick=2, hang_ticks=8, hang_replica=1)),
            hang_grace_ticks=2, check_invariants_each_tick=True,
            step_parallel=step_parallel)
        treqs = [sup.submit(p, 10) for p in prompts]
        sup.run_until_drained(max_ticks=500)
        assert [t.result.tokens for t in treqs] == ref
        assert sup.c_hung.value == 1
        hung = sup.replicas[1]
        assert hung.state == SERVING and not hung.revoked
        # the revoked requests were cancelled on resume: no leaks, and the
        # replica is empty and placeable again
        assert leaked_blocks(hung.engine.pool, hung.engine.prefix_cache) == 0
        assert not hung.engine.sched.has_work()
        t_new = sup.submit(prompts[0], 2)
        sup.run_until_drained(max_ticks=100)
        assert t_new.result.ok
        sup.close()

    def test_threaded_steps_under_a_short_switch_interval(self, setup):
        """Stress: four replicas stepping in threads while the interpreter
        switches threads every microsecond, under a crash and a hang: the
        streams, ticks and journal (``t`` and ``crc`` excepted) equal a
        one-thread drive's, so no shared state lost an update."""
        cfg, params = setup
        prompts = _prompts(cfg, 8, seed=47)
        runs = []
        old = sys.getswitchinterval()
        try:
            sys.setswitchinterval(1e-6)
            for parallel in (True, False):
                journal = Journal()
                sup = FleetSupervisor(
                    [_engine(cfg, params) for _ in range(4)],
                    journal=journal, hang_grace_ticks=2,
                    faults=FaultInjector(canned_fleet_plan(
                        crash_tick=3, hang_tick=5, hang_ticks=3)),
                    check_invariants_each_tick=True,
                    step_parallel=parallel)
                treqs = [sup.submit(p, 8) for p in prompts]
                sup.run_until_drained(max_ticks=500)
                sup.close()
                assert sup.c_crashed.value == 1 and sup.c_hung.value == 1
                runs.append(([t.result.tokens for t in treqs], sup.ticks,
                             [{k: v for k, v in r.items()
                               if k not in ("t", "crc")}
                              for r in journal.records]))
        finally:
            sys.setswitchinterval(old)
        assert runs[0] == runs[1]

    def test_launch_counts_under_threads(self):
        """The kernel wrappers' launch counts, bumped from four threads
        while the interpreter switches threads every microsecond, lose no
        update."""
        import threading

        from repro_torch.kernels import build

        def wrapper():
            pass

        wrapper.launches = wrapper.launches_bulk = 0

        def bump():
            for i in range(5000):
                build.count(wrapper, "launches",
                            *(("launches_bulk",) if i % 2 else ()))

        old = sys.getswitchinterval()
        try:
            sys.setswitchinterval(1e-6)
            threads = [threading.Thread(target=bump) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            sys.setswitchinterval(old)
        assert (wrapper.launches, wrapper.launches_bulk) == (20000, 10000)

    def test_organic_engine_death_is_a_crash(self, setup):
        cfg, params = setup
        prompts = _prompts(cfg, 4, seed=44)
        ref = _reference_streams(cfg, params, prompts, 6)
        engines = [_engine(cfg, params, step_fault_retries=0)
                   for _ in range(2)]
        # replica 0's pool raises an unabsorbed TransientFault mid-serve:
        # the supervisor must treat the unhandled engine exception as a
        # replica crash and fail its work over
        engines[0].attach_faults(FaultInjector(FaultPlan(seed=0, specs=[
            FaultSpec("step_fault", step=1, duration=50)])))
        sup = FleetSupervisor(engines)
        treqs = [sup.submit(p, 6) for p in prompts]
        sup.run_until_drained(max_ticks=500)
        assert [t.result.tokens for t in treqs] == ref
        assert sup.replicas[0].state == DEAD
        assert sup.c_crashed.value == 1


class TestMigrationStamps:
    def test_ttft_once_and_e2e_from_original_submit(self, setup):
        cfg, params = setup
        clock = ManualClock(tick=0.001)
        tel_a = Telemetry(clock=clock)
        tel_b = Telemetry(clock=clock)
        eng_a = _engine(cfg, params, telemetry=tel_a, clock=clock)
        eng_b = _engine(cfg, params, telemetry=tel_b, clock=clock)
        prompt = _prompt(cfg, 8)
        ref = _reference_streams(cfg, params, [prompt], 6)[0]
        h = eng_a.submit(prompt, 6)
        t_submit = h.t_submit
        for _ in range(6):                  # until first token(s) stream
            eng_a.step()
            eng_a.drain()
            if h.tokens:
                break
        emitted = list(h.tokens)
        assert emitted and tel_a.registry.get("serve_ttft_seconds").count == 1
        # replica A dies; one second later the survivor takes the request
        # with the migration stamps
        clock.advance(1.0)
        h2 = eng_b.submit(
            np.concatenate([prompt, np.asarray(emitted, np.int32)]),
            6 - len(emitted), t_submit=t_submit, ttft_observed=True)
        assert h2.t_submit == t_submit       # deadline/E2E base survives
        res = eng_b.run()
        assert emitted + list(res[h2.req_id].tokens) == ref
        # fleet aggregation: exactly ONE TTFT sample across both replicas,
        # and the single E2E sample spans the migration gap (measured from
        # the ORIGINAL submit, not the re-placement)
        agg = MetricRegistry().collect(tel_a.registry, tel_b.registry)
        assert agg.get("serve_ttft_seconds").count == 1
        assert agg.get("serve_e2e_seconds").count == 1
        assert agg.get("serve_e2e_seconds").sum >= 1.0

    def test_fleet_ttft_counts_survive_crash(self, setup):
        cfg, params = setup
        clock = ManualClock(tick=0.001)
        tels = [Telemetry(clock=clock) for _ in range(3)]
        engines = [_engine(cfg, params, telemetry=t, clock=clock)
                   for t in tels]
        sup = FleetSupervisor(
            engines, clock=clock,
            faults=FaultInjector(canned_fleet_plan(crash_tick=2,
                                                   hang_tick=None)))
        prompts = _prompts(cfg, 6, seed=45)
        treqs = [sup.submit(p, 8) for p in prompts]
        sup.run_until_drained(max_ticks=500)
        assert any(t.n_failovers for t in treqs)
        # tracker-level (fleet truth): one TTFT + one E2E per request
        assert sup.tracker.h_ttft.count == len(prompts)
        assert sup.tracker.h_e2e.count == len(prompts)
        # replica-level via collect(): migrated requests were NOT observed
        # twice, and E2E samples exist only on the finishing replica
        agg = sup.collect_metrics()
        assert agg.get("serve_ttft_seconds").count == len(prompts)
        assert agg.get("serve_e2e_seconds").count == len(prompts)


class TestCollectUnderFailover:
    def test_fleet_aggregate_equals_per_replica_sum_with_a_dead_replica(
            self, setup):
        cfg, params = setup
        clock = ManualClock(tick=0.001)
        tels = [Telemetry(clock=clock) for _ in range(3)]
        engines = [_engine(cfg, params, telemetry=t, clock=clock)
                   for t in tels]
        sup = FleetSupervisor(
            engines, clock=clock,
            faults=FaultInjector(canned_fleet_plan(crash_tick=2,
                                                   hang_tick=None)))
        treqs = [sup.submit(p, 8) for p in _prompts(cfg, 6, seed=46)]
        sup.run_until_drained(max_ticks=500)
        assert sup.replicas[0].state == DEAD
        agg = sup.collect_metrics()
        # extensive metrics: the fleet aggregate is EXACTLY the sum over
        # per-replica registries — the dead replica's history included,
        # nothing lost, nothing double-counted
        for name in ("serve_requests_submitted_total",
                     "serve_requests_finished_total"):
            per = [t.registry.get(name).value
                   for t in tels if t.registry.get(name)]
            assert agg.get(name).value == sum(per) > 0, name
        for name in ("serve_ttft_seconds", "serve_e2e_seconds",
                     "serve_queue_wait_seconds"):
            per = [t.registry.get(name) for t in tels
                   if t.registry.get(name)]
            assert agg.get(name).count == sum(h.count for h in per), name
            assert agg.get(name).sum == pytest.approx(
                sum(h.sum for h in per)), name
        # engine-rid submissions: every successful placement (incl.
        # failovers) shows up on exactly one replica
        assert agg.get("serve_requests_submitted_total").value == \
            sum(len(t.replicas) for t in treqs)
        # completion count is fleet-wide exact despite the mid-window death
        assert agg.get("serve_requests_finished_total").value == len(treqs)
        # prefix restriction still works across the fleet
        only = sup.collect_metrics(prefix="fleet_")
        assert only.get("fleet_requests_completed_total").value == len(treqs)
        assert only.get("serve_ttft_seconds") is None


class TestSheddingBackoffHint:
    def test_guard_hint_tracks_the_clean_streak(self):
        g = EngineGuard(GuardConfig(recover_steps=3))
        g.observe(GuardSignals(pool_util=1.0))
        assert g.state == SHEDDING and g.retry_after_steps() == 3
        g.observe(GuardSignals())
        assert g.retry_after_steps() == 2
        g.observe(GuardSignals(pool_util=1.0))   # dirty: streak resets
        assert g.retry_after_steps() == 3

    def test_engine_raises_with_machine_readable_hint(self, setup):
        cfg, params = setup
        guard = EngineGuard(GuardConfig(pool_util_degraded=0.01,
                                        pool_util_shedding=0.02,
                                        recover_steps=4))
        eng = _engine(cfg, params, guard=guard, prefix_cache=False)
        eng.submit(_prompt(cfg, 8), 4)
        eng.step()
        assert guard.state == SHEDDING
        with pytest.raises(EngineSheddingError) as ei:
            eng.submit(_prompt(cfg, 8), 4)
        assert ei.value.retry_after_steps == 4
        assert "4 clean steps" in str(ei.value)

    def test_supervisor_backoff_rides_the_hint_then_rejects(self, setup):
        cfg, params = setup
        guard = EngineGuard(GuardConfig(recover_steps=5))
        guard.observe(GuardSignals(pool_util=1.0))    # SHEDDING, no work:
        eng = _engine(cfg, params, guard=guard)       # stays shedding
        sup = FleetSupervisor([eng], max_attempts=3)
        treq = sup.submit(_prompt(cfg, 8), 4)
        assert treq.state == "pending"
        assert treq.next_retry_tick > 0      # backoff armed
        assert sup.tracker.c_retries.value == 1
        sup.run_until_drained(max_ticks=200)
        assert treq.result.finish_reason == "rejected"
        assert not treq.result.ok
        assert sup.tracker.c_failed.value == 1

    def test_pending_deadline_enforced_by_the_supervisor(self, setup):
        cfg, params = setup
        clock = ManualClock(tick=0.001)
        guard = EngineGuard(GuardConfig(recover_steps=5))
        guard.observe(GuardSignals(pool_util=1.0))
        eng = _engine(cfg, params, guard=guard, clock=clock)
        sup = FleetSupervisor([eng], clock=clock, max_attempts=100)
        treq = sup.submit(_prompt(cfg, 8), 4, deadline_s=0.5)
        clock.advance(1.0)
        sup.tick()
        assert treq.result.finish_reason == "deadline"


# -- the bench and the launcher ----------------------------------------------

def test_fleet_bench_smoke_gates(capsys):
    from repro_torch.benchmarks import fleet_bench
    scaling = fleet_bench.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert scaling >= 1.6
    assert "replay_exact,True" in out and "mismatched,[]" in out
    args = fleet_bench.parse_args(["--smoke"])
    assert args.device == "cuda"
    assert (args.replicas, args.tenants, args.per_tenant, args.max_new,
            args.mean_gap, args.min_scaling) == (3, 4, 4, 24, 0.75, 1.6)


def test_fleet_bench_workload_matches_jax():
    from benchmarks import fleet_bench as jax_bench
    from repro_torch.benchmarks import fleet_bench
    a = jax_bench.make_workload(8, 6, 0.75, 151936, 0)
    b = fleet_bench.make_workload(8, 6, 0.75, 151936, 0)
    assert [t for t, _ in a] == [t for t, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))
    for name in ("BLOCK_SIZE", "NUM_BLOCKS", "MAX_BATCH", "PREFIX_LEN",
                 "TAIL_LEN", "HANG_GRACE_TICKS"):
        assert getattr(fleet_bench, name) == getattr(jax_bench, name), name


def _int(pattern, text):
    return [int(x) for x in re.search(pattern, text).groups()]


def test_launcher_fleet_then_resume_lines(tmp_path, caplog, monkeypatch):
    from repro_torch.launch import serve as launch_serve
    made = []

    class Recording(FleetSupervisor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(launch_serve, "FleetSupervisor", Recording)
    base = ["--engine", "paged", "--reduced", "--device", "cpu",
            "--arch", "qwen3-4b", "--batch", "4", "--prompt-len", "20",
            "--max-new", "12", "--block-size", "8", "--num-blocks", "24",
            "--replicas", "2", "--snapshot-dir", str(tmp_path / "snaps")]
    wal = str(tmp_path / "wal.jsonl")
    with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve"):
        launch_serve.main(base + ["--fleet-fault-plan", "canned",
                                  "--journal-out", wal])
    text = caplog.text
    sup = made[-1]
    tr = sup.tracker
    assert _int(r"fleet\[2x qwen3-4b, affinity router\]: (\d+) completed, "
                r"(\d+) failed, (\d+) failovers, (\d+) placement retries "
                r"in (\d+) ticks", text) == [
        int(tr.c_completed.value), int(tr.c_failed.value),
        int(tr.c_failovers.value), int(tr.c_retries.value), sup.ticks]
    assert _int(r"fleet health: crashed=(\d+) hung=(\d+) alive=(\d+)",
                text) == [int(sup.c_crashed.value), int(sup.c_hung.value),
                          int(sup.g_alive.value)]
    assert int(tr.c_completed.value) == 4 and sup.c_crashed.value == 1
    assert tr.c_failovers.value > 0
    assert sup.step_parallel    # threads on the CPU, one thread on a card
    assert (tmp_path / "snaps" / "replica1.snap").exists()
    records = [json.loads(x) for x in open(wal)]
    assert f"write-ahead journal ({len(records)} records, fsync=interval)" \
        in text

    caplog.clear()
    with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve"):
        launch_serve.main(base + ["--resume", wal, "--journal-out",
                                  str(tmp_path / "wal2.jsonl")])
    text = caplog.text
    sup = made[-1]
    tr = sup.tracker
    # replica 0 crashed before the drain's snapshot: it restarts cold
    assert [i["mode"] for i in sup.restore_info] == ["cold", "warm"]
    assert "replica 0 restore: cold (snapshot missing)" in text
    assert "replica 1 restore: warm (snapshot ok)" in text
    assert _int(r"resume: (\d+) requests adopted \((\d+) already "
                r"terminal\), (\d+) torn-tail records lost", text) == [
        int(tr.c_recovered.value), 4, int(tr.c_tail_lost.value)]
    assert int(tr.c_recovered.value) == 4
    assert _int(r"fleet\[2x qwen3-4b, affinity router\]: (\d+) completed",
                text) == [int(tr.c_completed.value)] == [4]
    with pytest.raises(ValueError, match="256 ranks"):
        launch_serve.main(["--production-mesh"])
