"""The port's resilience layer against the JAX package's, on the CPU.

Weights: reduced qwen3-4b in float32 from the reference's
``model_fns(cfg).init`` bridged through numpy, as the reference's
``tests/test_resilience.py`` uses it; block 8, float32 and int8 pools,
``ManualClock`` time. Tolerances, per check:

* EXACT: ``FaultInjector`` decisions (every consumption hook, every step)
  and its log over a 200-step probabilistic plan and the canned plans; a
  plan's JSON and replay artifact written by either package load in the
  other; ``EngineGuard`` states, transitions and effective knobs over a
  seeded random signal sequence; the typed submit errors (class and
  message); ``corrupt_block``'s pool bytes (f32, bf16 and int8, scales
  untouched; int8 -128 wraps to itself in both).
* Lockstep drive of both engines under ``canned_plan`` plus the guard,
  one-shot and chunked, f32 and int8 pools, compared by workload
  position: streams, finish reasons, the seven resilience counters and
  the preemptions, the guard's transitions (step and states EXACT; the
  logit error in a reason to the tolerance below), the fault log (kinds,
  steps, request positions, block ids EXACT), and the telemetry
  registry's counters EXACT.
* Within 1e-5 of each logit tensor's largest magnitude: the readback
  deltas of clean requests (the packages sum in other orders). The
  corrupted request's delta is over the quarantine bound in both.
* The reference's behaviour tests, run against the port: cancel (waiting;
  running with blocks and pins freed; mid-chunked-prefill and mid-decode
  with a token vector in flight, in lockstep with the JAX engine),
  deadline and TTFT budget, retry absorbing a fault window and retry
  exhausted, the shedding front door and recovery, quarantine purging the
  tree, a finish and a preempt in one step leaving no pins, ``reset``
  releasing injected pool pressure, terminal telemetry.
* ``resilience_bench --smoke --device cpu``: its stream, invariant and
  divergence gates; the tok/s ratio is printed, not asserted (a
  wall-clock gate under several test workers is noise). The launcher's
  ``--fault-plan canned --guard --deadline-ms``: the ``resilience:`` line
  equal to the engine's counters.
"""
import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import faults as jax_faults
from repro.serve import guard as jax_guard
from repro.serve.kv_pool import PagedKVCache as JaxPool
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.serve import (FAULT_KINDS, CapacityExceededError,
                               ContinuousEngine, DuplicateRequestError,
                               EmptyPromptError, EngineGuard,
                               EngineSheddingError,
                               FaultInjector, FaultPlan, FaultSpec,
                               GuardConfig, GuardSignals, ManualClock,
                               PagedKVCache, SubmitError, Telemetry,
                               TransientFault, canned_fleet_plan, canned_plan,
                               check_invariants, leaked_blocks,
                               parse_prometheus_text)
from repro_torch.serve import faults as port_faults
from repro_torch.serve import guard as port_guard
from repro_torch.serve.guard import DEGRADED, HEALTHY, SHEDDING

TOL = 1e-5
TICK = 1e-4
RESILIENCE_COUNTERS = ("cancelled", "deadline_misses", "quarantined", "shed",
                       "faults_injected", "transient_retries",
                       "readback_audits")


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


def _engine(cfg, params, **kw):
    """The reference test's engine geometry, on the CPU."""
    kw.setdefault("block_size", 8)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 24)
    kw.setdefault("retry_backoff_s", 0.0)
    return ContinuousEngine(cfg, params, device="cpu", **kw)


def _prompt(cfg, n, seed=31):
    return np.random.default_rng(seed + n).integers(
        1, cfg.vocab_size, (n,)).astype(np.int32)


# -- fault plans and the injector (host only) --------------------------------

def _probabilistic_specs(mod):
    S = mod.FaultSpec
    return [S("pool_pressure", prob=0.05, duration=3, magnitude=0.4),
            S("admit_stall", prob=0.1, duration=2),
            S("slow_step", prob=0.15, magnitude=0.01),
            S("hung_step", prob=0.03, magnitude=0.2),
            S("preempt_storm", prob=0.04, magnitude=2),
            S("step_fault", prob=0.06, duration=3),
            S("kv_corrupt", prob=0.05, duration=2),
            S("numerics_spike", prob=0.07, duration=2, magnitude=0.6),
            S("replica_crash", prob=0.02, magnitude=1),
            S("replica_hang", prob=0.03, duration=4, magnitude=2),
            S("slow_step", step=17, duration=5, magnitude=0.003)]


def _plan(mod, which):
    if which == "probabilistic":
        return mod.FaultPlan(seed=123, specs=_probabilistic_specs(mod))
    if which == "canned":
        return mod.canned_plan()
    return mod.canned_fleet_plan(hang_tick=30)


def _consume(mod, inj, step):
    """Every consumption hook of one step, in a fixed order."""
    inj.begin_step(step)
    out = [inj.pool_pressure_target(80), inj.admission_stalled(),
           inj.stall_seconds(), inj.hung(), inj.preempt_storm_count(),
           inj.numerics_spike(), sorted(inj.replica_hang_targets()),
           inj.take_replica_crashes()]
    for _ in range(2):                   # two block-growth attempts
        try:
            inj.on_append_block(step)
            out.append("ok")
        except mod.TransientFault as e:
            out.append(str(e))
    out.append(inj.take_kv_corrupt())
    if step % 7 == 0:
        inj.record("engine_detail", step=step, req_id=step % 5)
    return out


@pytest.mark.parametrize("which", ["probabilistic", "canned", "fleet"])
def test_injector_decisions_equal_jax_exactly(which):
    jinj = jax_faults.FaultInjector(_plan(jax_faults, which))
    tinj = FaultInjector(_plan(port_faults, which))
    for step in range(200):
        assert _consume(port_faults, tinj, step) == \
            _consume(jax_faults, jinj, step), step
    assert tinj.log == jinj.log and len(tinj.log) > 10
    assert tinj.faults_injected == jinj.faults_injected
    assert tinj.corrupted_req_ids() == jinj.corrupted_req_ids()
    fired = {e["kind"] for e in tinj.log}
    if which == "probabilistic":
        assert set(FAULT_KINDS) <= fired
    tinj.reset()
    assert tinj.log == [] and tinj.faults_injected == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_plan_json_and_replay_artifact_cross_packages(writer, tmp_path):
    mods = {"jax": jax_faults, "port": port_faults}
    src = mods[writer]
    dst = mods["port" if writer == "jax" else "jax"]
    plan = _plan(src, "probabilistic")
    path = tmp_path / "plan.json"
    plan.save(str(path))
    loaded = dst.FaultPlan.load(str(path))
    assert loaded.to_json() == plan.to_json()
    assert dataclasses.asdict(loaded) == dataclasses.asdict(plan)
    for mod in mods.values():
        assert mod.FaultPlan.from_json(src.canned_plan().to_json()) \
            .to_json() == mod.canned_plan().to_json()
    arts = []
    for mod, p in ((src, plan), (dst, loaded)):
        inj = mod.FaultInjector(p)
        for s in range(40):
            inj.begin_step(s)
        out = tmp_path / f"{mod.__name__}.json"
        inj.save_log(str(out))
        arts.append(out.read_text())
    assert arts[0] == arts[1]
    assert json.loads(arts[0])["injections"]


def test_fault_spec_validation_equals_jax():
    for kw in ({"kind": "meteor_strike", "step": 0}, {"kind": "slow_step"},
               {"kind": "slow_step", "step": 0, "duration": 0}):
        msgs = []
        for mod in (jax_faults, port_faults):
            with pytest.raises(ValueError) as e:
                mod.FaultSpec(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert port_faults.ENGINE_FAULT_KINDS == jax_faults.ENGINE_FAULT_KINDS
    assert port_faults.FLEET_FAULT_KINDS == jax_faults.FLEET_FAULT_KINDS
    assert port_faults.FAULT_REQ == jax_faults.FAULT_REQ
    assert {s.kind for s in canned_plan().specs} == \
        set(port_faults.ENGINE_FAULT_KINDS)
    assert {s.kind for s in canned_fleet_plan().specs} == \
        set(port_faults.FLEET_FAULT_KINDS)


# -- the degradation ladder (host only) --------------------------------------

GUARD_CONFIGS = {
    "default": {},
    "watchdogs": dict(queue_wait_degraded=0.5, queue_wait_shedding=2.0,
                      step_time_hung_s=0.05, recover_steps=2),
    "eager": dict(recover_steps=1, pool_util_degraded=0.5,
                  pool_util_shedding=0.8, prefill_budget_factor=0.25,
                  max_admit_factor=0.34, quarantine_error=2.0),
}


def _signals(rng):
    return dict(pool_util=float(rng.choice([rng.random(), 0.9, 0.97,
                                            0.5])),
                logit_error=float(rng.choice([0.0, rng.random() * 0.5,
                                              0.25])),
                queue_wait=float(rng.exponential(0.5)),
                queue_depth=int(rng.integers(0, 9)),
                step_seconds=float(rng.exponential(0.03)))


@pytest.mark.parametrize("name", list(GUARD_CONFIGS))
def test_guard_ladder_equals_jax_exactly(name):
    kw = GUARD_CONFIGS[name]
    jg = jax_guard.EngineGuard(jax_guard.GuardConfig(**kw))
    tg = EngineGuard(GuardConfig(**kw))
    assert dataclasses.asdict(tg.config) == dataclasses.asdict(jg.config)
    rng = np.random.default_rng(len(name))
    for step in range(400):
        sig = _signals(rng)
        got = tg.observe(GuardSignals(**sig), step=step)
        assert got == jg.observe(jax_guard.GuardSignals(**sig), step=step)
        for base in (0, 1, 3, 8):
            assert tg.effective_max_admit(base) == \
                jg.effective_max_admit(base)
            assert tg.effective_prefill_budget(base * 16) == \
                jg.effective_prefill_budget(base * 16)
        err = sig["logit_error"] * 4
        assert (tg.state, tg.level, tg.admit_allowed(), tg.submit_allowed(),
                tg.retry_after_steps(), tg.should_quarantine(err),
                tg.last_reason) == \
            (jg.state, jg.level, jg.admit_allowed(), jg.submit_allowed(),
             jg.retry_after_steps(), jg.should_quarantine(err),
             jg.last_reason)
    assert tg.transitions == jg.transitions
    assert {t[2] for t in tg.transitions} >= {DEGRADED, SHEDDING}
    assert any(t[3].startswith("recovered") for t in tg.transitions)
    tg.reset()
    assert tg.state == HEALTHY and tg.transitions == []
    assert port_guard.GUARD_STATES == jax_guard.GUARD_STATES
    assert str(EngineSheddingError("x", 4)) == \
        str(jax_guard.EngineSheddingError("x", 4))
    assert EngineSheddingError("x", 4).retry_after_steps == 4


# -- submit errors and the pool's corruption ---------------------------------

def _submit_errors(eng, cfg):
    """The reference test's rejected submissions; (class, message) each."""
    p4, p16, p20 = (_prompt(cfg, n) for n in (4, 16, 20))
    cases = [(np.zeros((0,), np.int32), 4, {}),
             (np.ones((2, 3), np.int32), 4, {}),
             (p4, 0, {}), (p20, 8, {}), (p16, 8, {}),
             (p4, 2, {"deadline_s": 0.0}), (p4, 2, {"ttft_budget_s": -1.0})]
    out = []
    for prompt, max_new, kw in cases:
        try:
            eng.submit(prompt, max_new, **kw)
            out.append(None)
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
    h = eng.submit(p4, 2)
    try:
        eng.submit(p4, 2, req_id=h.req_id)
    except ValueError as e:
        out.append((type(e).__name__, str(e)))
    out.append(len(eng.sched.waiting))
    return out


def test_typed_submit_errors_equal_jax_exactly(qwen):
    jcfg, tcfg, jparams, tparams = qwen
    kw = dict(block_size=8, num_blocks=2, max_batch=3, max_len=24)
    got = _submit_errors(ContinuousEngine(tcfg, tparams, device="cpu", **kw),
                         tcfg)
    want = _submit_errors(jserve.ContinuousEngine(jcfg, jparams, **kw), jcfg)
    assert got == want
    assert [c for c, _ in got[:-1]] == [
        "EmptyPromptError", "SubmitError", "SubmitError",
        "CapacityExceededError", "CapacityExceededError", "SubmitError",
        "SubmitError", "DuplicateRequestError"]
    for exc in (SubmitError, EmptyPromptError, DuplicateRequestError,
                CapacityExceededError):
        assert issubclass(exc, ValueError)


def _fill_pools(pool_t, pool_j, rng):
    """The same seeded payload in both pools (int8 codes span -128..127)."""
    for name in ("k", "v"):
        t = getattr(pool_t, name)
        if t.dtype == torch.int8:
            a = rng.integers(-128, 128, t.shape).astype(np.int8)
            a[..., 0] = -128
        else:
            a = rng.normal(size=t.shape).astype(np.float32)
            if t.dtype == torch.bfloat16:
                a = torch.from_numpy(a).bfloat16().float().numpy()
        t.copy_(torch.from_numpy(a).to(t.dtype))
        setattr(pool_j, name, jnp.asarray(a).astype(getattr(pool_j,
                                                             name).dtype))
    if pool_t.quantized:
        for name in ("k_scale", "v_scale"):
            a = rng.random(getattr(pool_t, name).shape).astype(np.float32)
            getattr(pool_t, name).copy_(torch.from_numpy(a))
            setattr(pool_j, name, jnp.asarray(a))


def _pool_bytes(pool):
    out = []
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(pool, name)
        if a is None:
            continue
        if isinstance(a, torch.Tensor):
            a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        else:
            a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                           else a)
        out.append(a.tobytes())
    return out


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_corrupt_block_bytes_equal_jax_exactly(qwen, kv):
    jcfg, tcfg, _, _ = qwen
    kv_dtype = {"f32": "auto", "bf16": "bf16", "int8": "int8"}[kv]
    tpool = PagedKVCache(tcfg, 6, 8, kv_dtype=kv_dtype, device="cpu")
    jpool = JaxPool(jcfg, 6, 8, kv_dtype=kv_dtype)
    _fill_pools(tpool, jpool, np.random.default_rng(7))
    before = _pool_bytes(tpool)
    assert before == _pool_bytes(jpool)
    for b in (2, 5, 2):
        tpool.corrupt_block(b)
        jpool.corrupt_block(b)
    after = _pool_bytes(tpool)
    assert after == _pool_bytes(jpool)
    assert after[:2] != before[:2] and after[2:] == before[2:]
    k = tpool.k
    if kv == "int8":                     # -128 wraps to itself
        assert torch.all(k[:, 5, ..., 0] == -128)
    for pool in (tpool, jpool):
        with pytest.raises(ValueError, match="garbage block"):
            pool.corrupt_block(0)
    assert tpool.refcount(2) == 0 and tpool.num_free == tpool.num_blocks


# -- the lockstep drive -------------------------------------------------------

def _workload(vocab, n_pairs=4, seed=0):
    """resilience_bench's two-wave twin-prefix workload, smaller."""
    from repro_torch.benchmarks.resilience_bench import make_workload
    return make_workload(n_pairs, vocab, seed)


def _lockstep(E, G, FI, plan, C, T, cfg, params, chunk, kv, check=None,
              **kw):
    tel = T(clock=C(tick=TICK))
    eng = E(cfg, params, block_size=8, num_blocks=80, max_batch=6,
            max_len=40, max_admit_per_step=2, guard=G(), telemetry=tel,
            retry_backoff_s=0.002, prefill_chunk=chunk, kv_dtype=kv, **kw)
    inj = FI(plan)
    eng.attach_faults(inj)
    audits = []
    audit = eng._readback_audit

    def recording_audit(req, lg):
        err = audit(req, lg)
        audits.append((req.req_id, err,
                       float(np.abs(np.asarray(lg, np.float32)).max())))
        return err

    eng._readback_audit = recording_audit
    handles = [eng.submit(p, 24) for p in _workload(cfg.vocab_size)]
    pos = {h.req_id: i for i, h in enumerate(handles)}
    steps = 0
    while eng.sched.has_work():
        eng.step()
        if check is not None:
            check(eng.pool, eng.prefix_cache)
        steps += 1
    eng.drain()
    done = eng.pop_finished()
    log = []
    for e in inj.log:
        e = dict(e)
        if "req_id" in e:
            e["req_id"] = pos[e["req_id"]]
        if "req_ids" in e:
            e["req_ids"] = [pos[r] for r in e["req_ids"]]
        log.append(e)
    return {
        "streams": [list(done[h.req_id].tokens) for h in handles],
        "reasons": [done[h.req_id].finish_reason for h in handles],
        "counters": {k: getattr(eng.metrics, k)
                     for k in RESILIENCE_COUNTERS + ("preemptions",)},
        "transitions": list(eng.guard.transitions),
        "log": log,
        "audits": [(pos[r], err, mag) for r, err, mag in audits],
        "snapshot": tel.registry.snapshot(), "steps": steps,
        "leaked": leaked_blocks(eng.pool, eng.prefix_cache),
    }


def _close(a, b, mag):
    return abs(a - b) <= TOL * mag


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("chunk", [0, 8], ids=["one-shot", "chunked"])
def test_canned_plan_drive_equals_jax(qwen, chunk, kv):
    jcfg, tcfg, jparams, tparams = qwen
    j = _lockstep(jserve.ContinuousEngine, jserve.EngineGuard,
                  jserve.FaultInjector, jserve.canned_plan(),
                  jserve.ManualClock, jserve.Telemetry, jcfg, jparams,
                  chunk, kv)
    t = _lockstep(ContinuousEngine, EngineGuard, FaultInjector,
                  canned_plan(), ManualClock, Telemetry, tcfg, tparams,
                  chunk, kv, check=check_invariants, device="cpu")
    assert t["streams"] == j["streams"]
    assert t["reasons"] == j["reasons"]
    assert t["reasons"].count("quarantined") == 1
    assert t["counters"] == j["counters"]
    assert t["counters"]["quarantined"] == 1 and \
        t["counters"]["transient_retries"] == 2
    assert t["steps"] == j["steps"] and t["leaked"] == j["leaked"] == 0
    # the audits: the same requests in the same order, clean deltas to the
    # tolerance, the corrupted one over the bound in both
    assert [a[0] for a in t["audits"]] == [a[0] for a in j["audits"]]
    bound = GuardConfig().quarantine_error
    mag = max(m for _, _, m in t["audits"] + j["audits"])
    victim = t["reasons"].index("quarantined")
    for (p, te, tm), (_, je, jm) in zip(t["audits"], j["audits"]):
        if p == victim:
            assert te >= bound and je >= bound
        else:
            assert te < bound and _close(te, je, max(tm, jm)), (p, te, je)
    # transitions: steps and states exactly; a logit error in a reason (3
    # decimals) to the tolerance plus its rounding
    assert len(t["transitions"]) == len(j["transitions"]) >= 2
    for (ts, to, tn, tr), (js, jo, jn, jr) in zip(t["transitions"],
                                                  j["transitions"]):
        assert (ts, to, tn) == (js, jo, jn)
        if tr.startswith("logit_error") and tr != jr:
            assert jr.startswith("logit_error")
            assert abs(float(tr.split()[1]) - float(jr.split()[1])) <= \
                1e-3 + TOL * mag
        else:
            assert tr == jr
    # the fault log: kinds, steps, positions and block ids exactly; the
    # quarantine's logit error to the tolerance
    assert len(t["log"]) == len(j["log"])
    for te, je in zip(t["log"], j["log"]):
        if te["kind"] == "quarantine":
            assert _close(te.pop("logit_error"), je.pop("logit_error"),
                          mag)
        assert te == je
    assert {e["kind"] for e in t["log"]} >= set(
        port_faults.ENGINE_FAULT_KINDS)
    # the registry: every counter exactly; the two latest-delta gauges to
    # the tolerance
    ts, js = t["snapshot"], j["snapshot"]
    assert set(ts) == set(js)
    for name in ts:
        if name in ("readback_logit_error", "numerics_logit_error"):
            assert abs(ts[name] - js[name]) <= TOL * mag
        else:
            assert ts[name] == js[name], name
    c = t["counters"]
    # the registry counts window openings and corruption hits; the engine's
    # counter every log entry (storm victims and quarantines too)
    hits = sum("duration" in e or "blocks" in e for e in t["log"])
    assert hits < c["faults_injected"] == len(t["log"])
    for name, want in (("fault_injected_total", hits),
                       ("requests_cancelled_total", c["cancelled"]),
                       ("requests_quarantined_total", c["quarantined"]),
                       ("step_transient_retries_total",
                        c["transient_retries"]),
                       ("readback_audits_total", c["readback_audits"]),
                       ("guard_transitions_total", len(t["transitions"]))):
        assert ts[name] == want, name


def test_serve_exports_the_references_resilience_names():
    import repro_torch.serve as tserve
    for name in ("FaultInjector", "FaultPlan", "FaultSpec", "TransientFault",
                 "canned_plan", "canned_fleet_plan", "FAULT_KINDS",
                 "FAULT_REQ", "ENGINE_FAULT_KINDS", "FLEET_FAULT_KINDS",
                 "GUARD_STATES", "EngineGuard", "EngineSheddingError",
                 "GuardConfig", "GuardSignals", "SubmitError",
                 "EmptyPromptError", "DuplicateRequestError",
                 "CapacityExceededError", "FINISH_LENGTH", "FINISH_CANCELLED",
                 "FINISH_DEADLINE", "FINISH_QUARANTINED", "FINISH_FAILOVER"):
        assert name in tserve.__all__ and name in dir(jserve), name


# -- cancellation inside the async pipeline (lockstep) -----------------------

def _cancel_drive(E, cfg, params, chunk, **kw):
    """Three requests: one cancelled mid-prefill (chunked) or right after
    its admission, one cancelled mid-decode with a token vector in
    flight; the third runs to its end."""
    eng = E(cfg, params, block_size=8, num_blocks=40, max_batch=3,
            max_len=48, prefill_chunk=chunk, **kw)
    ps = [_prompt(cfg, n, seed=5) for n in (30, 12, 9)]
    hs = [eng.submit(p, 10) for p in ps]
    eng.step()
    assert hs[0].state == ("prefill" if chunk else "decoding")
    assert eng.cancel(hs[0].req_id)
    eng.step()
    eng.step()
    assert hs[1].state == "decoding" and eng._pending
    assert eng.cancel(hs[1].req_id)
    rows = [r.req_id for r in eng._rows if r is not None]
    pins = {r: list(v) for r, v in eng.prefix_cache._held.items() if v}
    res = eng.run()
    out = [(res[h.req_id].finish_reason, list(res[h.req_id].tokens),
            res[h.req_id].n_generated) for h in hs]
    return out, sorted(pins), eng.metrics.cancelled, \
        leaked_blocks(eng.pool, eng.prefix_cache), rows


@pytest.mark.parametrize("chunk", [0, 8], ids=["one-shot", "chunked"])
def test_cancel_mid_prefill_and_mid_decode_equals_jax(qwen, chunk):
    jcfg, tcfg, jparams, tparams = qwen
    got = _cancel_drive(ContinuousEngine, tcfg, tparams, chunk, device="cpu")
    want = _cancel_drive(jserve.ContinuousEngine, jcfg, jparams, chunk)
    assert got[:4] == want[:4]
    reasons = [o[0] for o in got[0]]
    assert reasons == ["cancelled", "cancelled", "length"]
    assert got[2] == 2 and got[3] == 0
    assert got[4] == [2]                 # the cancelled rows vacated
    # the cancelled requests' pins went with them; no stale token landed
    assert {0, 1}.isdisjoint(got[1])
    assert len(got[0][1][1]) < got[0][1][2]


# -- the reference's behaviour tests, on the port -----------------------------

def test_cancel_waiting_is_idempotent(qwen):
    _, cfg, _, params = qwen
    eng = _engine(cfg, params)
    h = eng.submit(_prompt(cfg, 8), 4)
    assert eng.cancel(h.req_id)
    assert not eng.cancel(h.req_id)
    assert not eng.cancel(12345)
    assert h.finish_reason == "cancelled"
    assert eng.metrics.cancelled == 1
    assert not eng.sched.has_work()
    assert h.req_id in eng.pop_finished()


def test_cancel_running_frees_blocks_and_pins(qwen):
    _, cfg, _, params = qwen
    eng = _engine(cfg, params)
    ha = eng.submit(_prompt(cfg, 12), 8)
    hb = eng.submit(_prompt(cfg, 12, seed=3), 8)
    eng.step()
    assert ha.req_id in eng.pool._tables
    assert eng.cancel(ha.req_id)
    assert ha.req_id not in eng.pool._tables
    assert not eng.prefix_cache._held.get(ha.req_id)
    check_invariants(eng.pool, eng.prefix_cache)
    res = eng.run()
    assert res[hb.req_id].finish_reason == "length"
    assert len(res[hb.req_id].tokens) == 8
    assert leaked_blocks(eng.pool, eng.prefix_cache) == 0


def test_deadline_cancels_and_counts(qwen):
    _, cfg, _, params = qwen
    clock = ManualClock(tick=0.001)
    eng = _engine(cfg, params, clock=clock, deadline_s=10.0)
    h_doomed = eng.submit(_prompt(cfg, 8), 8, deadline_s=0.5)
    h_fine = eng.submit(_prompt(cfg, 8, seed=4), 2)
    clock.advance(1.0)
    res = eng.run()
    assert res[h_doomed.req_id].finish_reason == "deadline"
    assert res[h_fine.req_id].finish_reason == "length"
    assert eng.metrics.deadline_misses == 1
    assert eng.metrics.cancelled == 1
    assert leaked_blocks(eng.pool, eng.prefix_cache) == 0


def test_ttft_budget_cancels_before_first_token(qwen):
    _, cfg, _, params = qwen
    clock = ManualClock(tick=0.001)
    eng = _engine(cfg, params, clock=clock, ttft_budget_s=0.5)
    h = eng.submit(_prompt(cfg, 8), 4)
    clock.advance(1.0)
    eng.step()
    assert h.finish_reason == "deadline"
    assert eng.metrics.deadline_misses == 1


def test_ttft_budget_spares_streaming_requests(qwen):
    _, cfg, _, params = qwen
    clock = ManualClock(tick=0.001)
    eng = _engine(cfg, params, clock=clock)
    h = eng.submit(_prompt(cfg, 8), 4, ttft_budget_s=0.5)
    eng.step()
    assert h.t_first_token > 0.0
    clock.advance(1.0)
    res = eng.run()
    assert res[h.req_id].finish_reason == "length"
    assert eng.metrics.deadline_misses == 0


def test_retry_absorbs_the_fault_window(qwen):
    _, cfg, _, params = qwen
    eng = _engine(cfg, params)
    eng.attach_faults(FaultInjector(FaultPlan(seed=0, specs=[
        FaultSpec("step_fault", step=0, duration=2)])))
    h = eng.submit(_prompt(cfg, 8), 4)
    res = eng.run()
    assert res[h.req_id].finish_reason == "length"
    assert eng.metrics.transient_retries == 2
    assert eng.metrics.faults_injected >= 1


def test_retry_exhaustion_propagates(qwen):
    _, cfg, _, params = qwen
    eng = _engine(cfg, params, step_fault_retries=1)
    eng.attach_faults(FaultInjector(FaultPlan(seed=0, specs=[
        FaultSpec("step_fault", step=0, duration=5)])))
    h = eng.submit(_prompt(cfg, 8), 4)
    with pytest.raises(TransientFault):
        eng.step()
    check_invariants(eng.pool, eng.prefix_cache)
    eng.attach_faults(None)
    res = eng.run()
    assert res[h.req_id].finish_reason == "length"
    assert len(res[h.req_id].tokens) == 4


def test_block_growth_retry_grows_each_table_once(qwen):
    """A transient fault at the second request's block growth, after the
    first request's table grew: the retried ``ensure_decode_blocks`` skips
    the table that already grew, so each request gains exactly one
    block."""
    _, cfg, _, params = qwen
    eng = _engine(cfg, params)
    hs = [eng.submit(_prompt(cfg, 7, seed=s), 6) for s in (1, 2)]
    eng.step()                           # 7 prompt + 1 token: 8 cached
    assert all(h.n_cached == 8 for h in hs)
    before = [eng.pool.n_blocks_of(h.req_id) for h in hs]
    calls = []
    grow = eng.pool.append_block

    def flaky(rid):
        calls.append(rid)
        if len(calls) == 2:
            raise TransientFault("injected at the second growth")
        return grow(rid)

    eng.pool.append_block = flaky
    assert eng._with_retry(eng.sched.ensure_decode_blocks) == []
    assert eng.metrics.transient_retries == 1
    assert calls == [hs[0].req_id, hs[1].req_id, hs[1].req_id]
    assert [eng.pool.n_blocks_of(h.req_id) for h in hs] == \
        [b + 1 for b in before]
    check_invariants(eng.pool, eng.prefix_cache)


def test_shedding_front_door_and_recovery(qwen):
    _, cfg, _, params = qwen
    guard = EngineGuard(GuardConfig(pool_util_degraded=0.01,
                                    pool_util_shedding=0.02,
                                    recover_steps=1))
    eng = _engine(cfg, params, guard=guard, prefix_cache=False)
    h = eng.submit(_prompt(cfg, 8), 4)
    eng.step()
    assert guard.state == SHEDDING
    with pytest.raises(EngineSheddingError, match="shedding") as e:
        eng.submit(_prompt(cfg, 8), 4)
    assert e.value.retry_after_steps == 1
    assert eng.metrics.shed == 1
    res = eng.run()
    assert res[h.req_id].finish_reason == "length"
    eng.step()
    eng.step()
    assert guard.state == HEALTHY
    eng.submit(_prompt(cfg, 8), 2)
    eng.run()


def test_kv_corruption_is_quarantined_and_purged(qwen):
    _, cfg, _, params = qwen
    eng = _engine(cfg, params, guard=EngineGuard())
    eng.attach_faults(FaultInjector(FaultPlan(seed=0, specs=[
        FaultSpec("kv_corrupt", step=0, duration=1)])))
    ha = eng.submit(_prompt(cfg, 12), 6)
    hb = eng.submit(_prompt(cfg, 12, seed=3), 6)
    res = eng.run()
    assert res[ha.req_id].finish_reason == "quarantined"
    assert res[hb.req_id].finish_reason == "length"
    assert len(res[hb.req_id].tokens) == 6
    assert eng.metrics.quarantined == 1
    assert eng.metrics.readback_audits >= 2
    assert eng.prefix_cache.lookup(ha.prompt) == 0
    assert eng.faults.corrupted_req_ids() == [ha.req_id]
    check_invariants(eng.pool, eng.prefix_cache)
    assert leaked_blocks(eng.pool, eng.prefix_cache) == 0


def test_same_step_finish_and_preempt_leaves_no_pins(qwen):
    _, cfg, _, params = qwen
    eng = _engine(cfg, params)
    ha = eng.submit(_prompt(cfg, 8), 1)
    hb = eng.submit(_prompt(cfg, 8, seed=4), 6)
    eng.step()
    eng.sched.force_preempt(1)
    assert ha.finish_reason == "length"
    assert hb.n_preemptions == 1
    check_invariants(eng.pool, eng.prefix_cache)
    res = eng.run()
    assert len(res[hb.req_id].tokens) == 6
    assert not any(eng.prefix_cache._held.values())
    assert leaked_blocks(eng.pool, eng.prefix_cache) == 0
    eng.reset()
    assert eng.pool.num_free == eng.pool.num_blocks
    assert eng.prefix_cache.cached_blocks == 0


def test_reset_releases_injected_pool_pressure(qwen):
    _, cfg, _, params = qwen
    eng = _engine(cfg, params)
    inj = FaultInjector(FaultPlan(seed=0, specs=[
        FaultSpec("pool_pressure", step=0, duration=50, magnitude=0.5)]))
    eng.attach_faults(inj)
    h = eng.submit(_prompt(cfg, 8), 2)
    res = eng.run()
    assert res[h.req_id].finish_reason == "length"
    assert eng._fault_pressure_blocks > 0
    eng.reset()
    assert eng._fault_pressure_blocks == 0
    assert eng.pool.num_free == eng.pool.num_blocks
    assert inj.log == []


def test_terminal_traces_and_counters(qwen):
    _, cfg, _, params = qwen
    tel = Telemetry(clock=ManualClock(tick=0.001))
    eng = _engine(cfg, params, telemetry=tel)
    h_cancel = eng.submit(_prompt(cfg, 8), 4)
    h_doomed = eng.submit(_prompt(cfg, 8, seed=4), 4, deadline_s=0.5)
    h_done = eng.submit(_prompt(cfg, 8, seed=5), 2)
    eng.cancel(h_cancel.req_id)
    tel.clock.advance(1.0)
    eng.run()
    reasons = {tr.req_id: tr.finish_reason for tr in tel.finished_traces}
    assert reasons[h_cancel.req_id] == "cancelled"
    assert reasons[h_doomed.req_id] == "deadline"
    assert reasons[h_done.req_id] == "length"
    reg = tel.registry
    assert reg.get("requests_cancelled_total").value == 2
    assert reg.get("deadline_misses_total").value == 1
    assert reg.get("serve_e2e_seconds").count == 1


def test_fault_and_guard_metrics_exported(qwen):
    _, cfg, _, params = qwen
    tel = Telemetry(clock=ManualClock(tick=0.001))
    guard = EngineGuard(GuardConfig(pool_util_degraded=0.01,
                                    pool_util_shedding=0.02,
                                    recover_steps=1))
    eng = _engine(cfg, params, telemetry=tel, guard=guard)
    eng.attach_faults(FaultInjector(FaultPlan(seed=0, specs=[
        FaultSpec("slow_step", step=0, magnitude=0.25)])))
    eng.submit(_prompt(cfg, 8), 2)
    eng.run()
    reg = tel.registry
    assert reg.get("fault_injected_total").value >= 1
    assert reg.get("guard_transitions_total").value >= 1
    assert reg.get("guard_state") is not None
    fams = parse_prometheus_text(reg.prometheus_text())
    for name in ("fault_injected_total", "requests_cancelled_total",
                 "requests_shed_total", "deadline_misses_total",
                 "guard_state"):
        assert name in fams, name


# -- the bench and the launcher -----------------------------------------------

def test_resilience_bench_smoke_gates_on_cpu(qwen, capsys):
    """``resilience_bench --smoke --device cpu``'s functions: the stream,
    invariant and divergence gates hold; the tok/s ratio is printed."""
    from repro_torch.benchmarks import resilience_bench as rb
    from repro_torch.models.registry import init_lm_params
    args = rb.parse_args(["--smoke", "--device", "cpu"])
    assert (args.repeats, args.pairs, args.max_new, args.min_ratio) == \
        (2, 8, 96, 0.70)
    cfg = reduce_config(get_config(args.arch))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    prompts = rb.make_workload(args.pairs, cfg.vocab_size, args.seed)
    import sys
    sys.path.insert(0, ".")
    try:
        from benchmarks import resilience_bench as jrb
    finally:
        sys.path.pop(0)
    want = jrb.make_workload(args.pairs, cfg.vocab_size, args.seed)
    assert all(np.array_equal(a, b) for a, b in zip(prompts, want))
    engines = rb.build_engines(cfg, params, max_new=args.max_new,
                               device=torch.device("cpu"))
    eng_base, eng_guard, _, eng_plain, inj_plain = engines
    ratios, base, _, _ = rb.run_rounds(eng_base, eng_guard, prompts,
                                       args.max_new, args.repeats)
    v = rb.verify(eng_guard, eng_plain, inj_plain, prompts, args.max_new,
                  base)
    failures = rb.gate_failures(max(ratios), 0.0, v)
    assert not failures, failures
    assert v["victims"] and not v["mismatched"] and v["divergent"]
    assert v["checks"] > 0
    print(f"resilience_bench smoke on the CPU: guarded/fault-free tok/s "
          f"best-of {max(ratios):.3f} (read, not gated)")
    assert "resilience,guarded,victims" in capsys.readouterr().out


def test_launcher_resilience_line_equals_engine(monkeypatch, caplog,
                                                tmp_path):
    from repro_torch.launch import serve as launch
    made = []

    class Recording(ContinuousEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(launch, "ContinuousEngine", Recording)
    log_path = tmp_path / "faults.json"
    with caplog.at_level(logging.INFO, logger="repro_torch.launch.serve"):
        launch.main(["--engine", "paged", "--arch", "qwen3-4b", "--reduced",
                     "--device", "cpu", "--batch", "4", "--prompt-len",
                     "20", "--max-new", "24", "--block-size", "8",
                     "--num-blocks", "40", "--fault-plan", "canned",
                     "--guard", "--deadline-ms", "600000",
                     "--fault-log", str(log_path)])
    (eng,) = made
    m = eng.metrics
    assert eng.guard is not None and eng.faults is not None
    assert eng.default_deadline_s == 600.0
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("resilience:")]
    assert line == [
        f"resilience: {m.faults_injected} faults injected, "
        f"{m.transient_retries} retries, {m.cancelled} cancelled "
        f"({m.deadline_misses} deadline, {m.quarantined} quarantined), "
        f"{m.shed} shed, guard={eng.guard.state}"]
    assert m.faults_injected >= 8 and m.transient_retries == 2
    doc = json.loads(log_path.read_text())
    assert len(doc["injections"]) == m.faults_injected
    args = launch.parse_args(["--engine", "paged", "--fault-plan", "canned",
                              "--guard", "--deadline-ms", "5",
                              "--ttft-budget-ms", "2"])
    assert (args.fault_plan, args.guard, args.deadline_ms,
            args.ttft_budget_ms, args.device) == \
        ("canned", True, 5.0, 2.0, "cuda")
