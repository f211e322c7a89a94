"""The port's serving telemetry against the JAX package's, on the CPU.

Weights: reduced llama3.2-3b (and reduced qwen3-4b for the numerics
audit), float32, from the reference's ``model_fns(cfg).init`` bridged
through numpy. Tolerances, per check:

* Metric registry: the same seeded observations (NaN, negatives, +-inf,
  0, a value past the top bucket, custom ladders, ``collect`` of three
  replicas with a prefix filter) give EXACTLY equal ``prometheus_text()``,
  ``snapshot()``, ``write_jsonl`` lines, ``quantile`` at 0/0.5/0.9/0.99/1
  and ``parse_prometheus_text`` results in both packages.
* Engine: both engines get their own ``ManualClock(tick=1e-4)``, the same
  prompts and weights, per-step grid planning, one-shot or chunked
  prefill, a float32 or int8 pool, a preemption (pool pressure) and
  prefix hits. The registry snapshot and exposition, every timeline
  event (name, ts, dur, args), every finished ``RequestTrace.to_dict()``
  and the shared ``EngineMetrics`` fields are EXACTLY equal; greedy
  streams are EXACTLY the JAX engine's and the port's own with telemetry
  off.
* Run, ``reset()``, rerun: the reference's own test on the port (the
  rerun's ``wall_s`` to float rounding, everything else exact).
* ``paged_prefill_audit``: logits within 1e-5 of each tensor's largest
  magnitude; ``kv_amax_max`` within 1e-6 relative; the counts
  (``intmax_overflow_rows``, ``score_inp_clip_vals``,
  ``kv_scale_sat_rows``) and the ceil'd ``score_intmax_max`` EXACTLY
  equal, unless the test shows that a score row maximum, a score or a
  K/V row amax lies within 1e-5 (relative, at least 1e-5 absolute) of the
  integer or threshold it would cross: the packages sum in other orders.
* The engine's probe cadence (``numerics_every`` 1 and 2) and its no-op
  on an unquantized pool: probe counts and probed lengths EXACTLY the
  reference's, the logit-error gauge within 1e-4 absolute.
* ``GridPlanner(registry=...)``: decisions, counters, gauges and
  histograms EXACTLY equal over a seeded sequence of batches.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_config as jax_get_config
from repro.models.registry import model_fns
from repro.models.registry import reduce_config as jax_reduce_config
from repro.serve import ContinuousEngine as JaxEngine
from repro.serve import GridPlanner as JaxPlanner
from repro.serve import ManualClock as JaxClock
from repro.serve import Telemetry as JaxTelemetry
from repro.serve import metrics as jax_metrics
from repro.serve.paged_step import paged_prefill_audit as jax_audit
from repro_torch.bridge import params_from_numpy
from repro_torch.models.registry import get_config, reduce_config
from repro_torch.models.schema import unstack_layers
from repro_torch.serve import (ContinuousEngine, GridPlanner, ManualClock,
                               Telemetry, default_candidates)
from repro_torch.serve import metrics as port_metrics
from repro_torch.serve import paged_step

TICK = 1e-4
TOL = 1e-5


def _bridged(arch):
    jcfg = jax_reduce_config(jax_get_config(arch))
    tcfg = reduce_config(get_config(arch))
    jparams = model_fns(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def llama():
    return _bridged("llama3.2-3b")


@pytest.fixture(scope="module")
def qwen():
    return _bridged("qwen3-4b")


# -- metric registry --------------------------------------------------------

def _populate(mod, seed, path):
    """One registry of ``mod`` fed a seeded stream of observations."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricRegistry()
    c = reg.counter("req_total", "requests")
    for n in rng.integers(0, 5, 20):
        c.inc(float(n))
    g = reg.gauge("pool_util", "occupancy")
    for x in rng.random(10):
        g.set(x)
        g.max(x * 1.5)
    samples = np.concatenate([rng.lognormal(-4.0, 2.0, 300),
                              [np.nan, -1.0, np.inf, -np.inf, 0.0, 1e9,
                               1e-9, 1e-6]])
    rng.shuffle(samples)
    h = reg.histogram("lat_seconds", "latency")
    for x in samples:
        h.observe(x)
    wide = reg.histogram("launch_bytes", "bytes of one launch", lo=1024.0,
                         growth=1.6, n_buckets=64)
    for x in rng.lognormal(12.0, 3.0, 200):
        wide.observe(x)
    reg.histogram("idle_seconds", "never observed")
    reps = []
    for i in range(3):
        r = mod.MetricRegistry()
        r.counter("serve_req_total", "per replica").inc(i + 1)
        r.gauge("serve_pool_peak").set(10.0 * (i + 1))
        hh = r.histogram("serve_tpot_seconds", "token gaps")
        for x in rng.lognormal(-5.0, 1.0, 100):
            hh.observe(x)
        r.counter("other_total").inc(7)
        reps.append(r)
    agg = mod.MetricRegistry().collect(*reps, prefix="serve_")
    reg.collect(agg)
    reg.write_jsonl(str(path), extra={"run": seed})
    reg.counter("req_total").inc(2.5)
    reg.write_jsonl(str(path), extra={"run": seed + 1})
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_equals_jax_exactly(seed, tmp_path):
    jreg = _populate(jax_metrics, seed, tmp_path / "jax.jsonl")
    treg = _populate(port_metrics, seed, tmp_path / "port.jsonl")
    text = treg.prometheus_text()
    assert text == jreg.prometheus_text()
    assert treg.snapshot() == jreg.snapshot()
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "jax.jsonl").read_text()
    for jm in jreg:
        tm = treg.get(jm.name)
        assert type(tm).__name__ == type(jm).__name__ and tm.help == jm.help
        if isinstance(jm, jax_metrics.Histogram):
            assert tm.counts == jm.counts and tm.sum == jm.sum
            assert (tm.min, tm.max, tm.count) == (jm.min, jm.max, jm.count)
            assert [tm.upper_edge(i) for i in range(len(tm.counts))] == \
                [jm.upper_edge(i) for i in range(len(jm.counts))]
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                assert tm.quantile(q) == jm.quantile(q)
        else:
            assert tm.value == jm.value
    fams = port_metrics.parse_prometheus_text(text)
    assert fams == jax_metrics.parse_prometheus_text(text)
    assert fams["lat_seconds"]["type"] == "histogram"
    assert treg.get("serve_tpot_seconds").count == 300


def test_registry_rejects_what_the_reference_rejects():
    reg = port_metrics.MetricRegistry()
    with pytest.raises(ValueError):
        reg.counter("c_total").inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("c_total")
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError, match="ladder"):
        port_metrics.Histogram("h").merge(
            port_metrics.Histogram("h", lo=1e-3))
    for bad in ('# TYPE h histogram\nh_bucket{le="1.0"} 5\n'
                'h_bucket{le="+Inf"} 3\nh_count 3\n',
                '# TYPE h histogram\nh_bucket{le="+Inf"} 3\nh_count 4\n',
                "this is { not a sample\n"):
        with pytest.raises(ValueError):
            port_metrics.parse_prometheus_text(bad)


# -- the engine's hooks -----------------------------------------------------

ENGINE_KW = dict(block_size=8, num_blocks=40, max_batch=3, max_len=48,
                 autotune="per-step", kv_tile_blocks=2, decode_split_k=2)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    head = rng.integers(1, vocab, 20).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, vocab, n)])
            .astype(np.int32) for n in (4, 11, 7)]


def _serve(eng, prompts):
    """Two waves. The first runs under pool pressure from its second step
    until a preemption: before each step every evictable cached block is
    evicted and every free block held under request id -1, so the next
    decode step that crosses a block boundary preempts the youngest
    request through ``ensure_decode_blocks``; the held blocks go back
    after it. The second wave shares the first's prompt head (prefix
    hits, one full-prompt hit)."""
    hs = [eng.submit(p, 6) for p in prompts[:2]]
    held, step = False, 0
    while eng.sched.has_work():
        if step >= 1 and eng.metrics.preemptions == 0:
            eng.prefix_cache.evict(eng.prefix_cache.evictable_blocks())
            if eng.pool.num_free:
                eng.pool.alloc(-1, eng.pool.num_free)
                held = True
        elif held:
            eng.pool.free(-1)
            held = False
        eng.step()
        step += 1
    if held:
        eng.pool.free(-1)
    res = eng.run()
    hs2 = [eng.submit(p, 6) for p in prompts[1:]]
    res2 = eng.run()
    return [res[h.req_id].tokens for h in hs] + \
        [res2[h.req_id].tokens for h in hs2]


def _shared_metrics(tm, jm):
    td, jd = dataclasses.asdict(tm), dataclasses.asdict(jm)
    return td, {k: jd[k] for k in td}


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("chunk", [0, 16], ids=["one-shot", "chunked"])
def test_engine_telemetry_equals_jax_exactly(llama, chunk, kv, tmp_path):
    jcfg, tcfg, jparams, tparams = llama
    prompts = _prompts(tcfg.vocab_size)
    kw = dict(ENGINE_KW, prefill_chunk=chunk,
              kv_dtype=None if kv == "auto" else kv)
    jtel = JaxTelemetry(clock=JaxClock(tick=TICK))
    ttel = Telemetry(clock=ManualClock(tick=TICK))
    jeng = JaxEngine(jcfg, jparams, telemetry=jtel, **kw)
    teng = ContinuousEngine(tcfg, tparams, telemetry=ttel, device="cpu",
                            **kw)
    jstreams, tstreams = _serve(jeng, prompts), _serve(teng, prompts)
    assert tstreams == jstreams
    m = teng.metrics
    assert m.preemptions == jeng.metrics.preemptions == 1
    assert m.prefix_hit_tokens > 0 and (m.prefill_chunks > 0) == bool(chunk)
    td, jd = _shared_metrics(m, jeng.metrics)
    assert td == jd

    snap = ttel.registry.snapshot()
    assert snap == jtel.registry.snapshot()
    assert ttel.registry.prometheus_text() == \
        jtel.registry.prometheus_text()
    assert ttel.timeline.events == jtel.timeline.events
    assert ttel.timeline.to_chrome({"arch": tcfg.name}) == \
        jtel.timeline.to_chrome({"arch": jcfg.name})
    traces = [tr.to_dict() for tr in ttel.finished_traces]
    assert traces == [tr.to_dict() for tr in jtel.finished_traces]
    assert len(traces) == 4 and not ttel.traces
    assert sum(tr["n_preemptions"] for tr in traces) == 1

    # what phase 27 of chip_smoke.py holds on the card
    assert snap["serve_decode_steps"] == m.decode_steps
    assert snap["serve_prefill_chunks"] == m.prefill_chunks
    assert snap["serve_tokens_out"] == m.tokens_out
    assert snap["autotune_decisions_total"] == m.decode_steps
    assert snap["kernel_dma_bytes_total"] == sum(
        e["args"].get("dma_bytes", 0) for e in ttel.timeline.events)
    decodes = [e for e in ttel.timeline.events if e["name"] == "decode"]
    assert len(decodes) == m.decode_steps
    path = tmp_path / "trace.json"
    ttel.save_chrome_trace(str(path), meta={"arch": tcfg.name})
    assert json.loads(path.read_text())["traceEvents"][0]["args"] == \
        {"name": "engine"}

    # telemetry changes no token
    off = ContinuousEngine(tcfg, tparams, device="cpu", **kw)
    assert _serve(off, prompts) == tstreams


def test_run_reset_rerun_reports_identically(llama):
    _, tcfg, _, tparams = llama
    tel = Telemetry(clock=ManualClock(tick=TICK))
    eng = ContinuousEngine(tcfg, tparams, telemetry=tel, device="cpu",
                           block_size=8, num_blocks=32, max_batch=4,
                           max_len=48)

    def drive():
        rng = np.random.default_rng(3)
        for _ in range(3):
            eng.submit(rng.integers(1, 100, (16,)).astype(np.int32), 6)
        return eng.run()

    drive()
    first = dataclasses.asdict(eng.metrics)
    snap1 = tel.registry.snapshot()
    traces1 = [tr.to_dict() for tr in tel.finished_traces]
    eng.reset()
    assert eng.metrics.steps == 0 and eng.metrics.tokens_out == 0
    assert eng.metrics.kv_pool_bytes == eng.pool.hbm_bytes > 0
    assert eng.pool.stats.peak_in_use == 0 and eng.sched.n_preemptions == 0
    assert tel.c_finished.value == 0 and not tel.finished_traces
    assert tel.registry.snapshot()["serve_ttft_seconds"]["count"] == 0
    drive()
    second = dataclasses.asdict(eng.metrics)
    snap2 = tel.registry.snapshot()
    traces2 = [tr.to_dict() for tr in tel.finished_traces]
    # wall_s sums durations at another clock base the second time: equal
    # to float rounding; everything else exactly
    assert first.pop("wall_s") == pytest.approx(second.pop("wall_s"))
    assert first == second
    assert snap1.pop("serve_wall_seconds") == \
        pytest.approx(snap2.pop("serve_wall_seconds"))
    assert snap1 == snap2
    for a, b in zip(traces1, traces2):
        for k in ("prompt_len", "n_tokens", "queue_wait", "ttft", "e2e",
                  "tpot_mean", "n_preemptions"):
            assert a[k] == pytest.approx(b[k]), k


# -- the numerics monitor ---------------------------------------------------

class _Recorder:
    """Records the quantized branch's scores and K/V scales of one
    ``paged_prefill_audit`` call (the second ``_audit_attention`` call of
    each layer is the quantized branch's)."""

    def __init__(self, monkeypatch):
        self.att, self.scales = [], []
        attention, scale = paged_step._audit_attention, \
            paged_step.percentile_scale

        def rec_attention(q, k, v, intmax):
            out = attention(q, k, v, intmax)
            self.att.append(out)
            return out

        def rec_scale(x, *a):
            sc = scale(x, *a)
            self.scales.append((torch.amax(torch.abs(x), dim=-1), sc))
            return sc

        monkeypatch.setattr(paged_step, "_audit_attention", rec_attention)
        monkeypatch.setattr(paged_step, "percentile_scale", rec_scale)

    @staticmethod
    def _near(x, at):
        x = x.double()
        return torch.abs(x - at) <= TOL * torch.clamp(torch.abs(x), min=1.0)

    def margins(self):
        """Which stat may differ between the packages: the ones whose
        inputs lie within the tolerance of what they are compared with."""
        rows = [s.masked_fill(~valid, -np.inf).amax(-1)
                for _, _, s, valid in self.att[1::2]]
        ceil_edge = any(self._near(r, torch.round(r.double())).any()
                        for r in rows)
        fmt = paged_step.DEFAULT_BITWIDTHS
        ovf_edge = ceil_edge or any(
            self._near(r, fmt.localmax.max_value).any() for r in rows)
        clip_edge = any(
            (self._near(s, fmt.inp.max_value) | self._near(s, fmt.inp.min_value)
             )[valid.expand(s.shape)].any()
            for _, _, s, valid in self.att[1::2])
        sat_edge = any(self._near(a, 127.0 * sc.double()).any()
                       for a, sc in self.scales)
        return {"score_intmax_max": ceil_edge,
                "intmax_overflow_rows": ovf_edge,
                "score_inp_clip_vals": clip_edge,
                "kv_scale_sat_rows": sat_edge}


@pytest.mark.parametrize("n", [1, 16, 64])
@pytest.mark.parametrize("arch", ["llama", "qwen"])
def test_paged_prefill_audit_matches_jax(arch, n, request, monkeypatch):
    jcfg, tcfg, jparams, tparams = request.getfixturevalue(arch)
    toks = np.random.default_rng(n).integers(1, tcfg.vocab_size, (1, n)) \
        .astype(np.int32)
    jref, jq, jstats = jax_audit(jparams, jnp.asarray(toks),
                                 jnp.asarray([n - 1], jnp.int32), jcfg)
    rec = _Recorder(monkeypatch)
    tref, tq, tstats = paged_step.paged_prefill_audit(
        unstack_layers(tparams), torch.as_tensor(toks),
        torch.tensor([n - 1], dtype=torch.int32), tcfg)
    assert len(rec.att) == 2 * tcfg.n_layers
    for got, want in ((tref, jref), (tq, jq)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    assert set(tstats) == set(jstats)
    edges = rec.margins()
    for k, edge in edges.items():
        got, want = float(tstats[k]), float(jstats[k])
        assert got == want or edge, (k, got, want)
    assert float(tstats["kv_amax_max"]) == pytest.approx(
        float(jstats["kv_amax_max"]), rel=1e-6)


def _numerics_run(mod_engine, mod_tel, mod_clock, cfg, params, every, kv,
                  n_req, **kw):
    tel = mod_tel(clock=mod_clock(tick=TICK), numerics_every=every,
                  numerics_max_tokens=16)
    eng = mod_engine(cfg, params, telemetry=tel, kv_dtype=kv,
                     block_size=8, num_blocks=32, max_batch=4, max_len=48,
                     **kw)
    rng = np.random.default_rng(3)
    for _ in range(n_req):
        eng.submit(rng.integers(1, 100, (16,)).astype(np.int32), 6)
    eng.run()
    return tel, eng


@pytest.mark.parametrize("every, n_req, probes", [(1, 2, 2), (2, 3, 2)])
def test_numerics_probe_cadence_matches_jax(llama, every, n_req, probes):
    jcfg, tcfg, jparams, tparams = llama
    jtel, jeng = _numerics_run(JaxEngine, JaxTelemetry, JaxClock, jcfg,
                               jparams, every, "int8", n_req)
    ttel, teng = _numerics_run(ContinuousEngine, Telemetry, ManualClock,
                               tcfg, tparams, every, "int8", n_req,
                               device="cpu")
    assert teng.quantized
    assert ttel.c_probes.value == jtel.c_probes.value == probes
    get, jget = ttel.registry.get, jtel.registry.get
    assert get("numerics_probe_tokens").value == \
        jget("numerics_probe_tokens").value == 16
    assert get("numerics_logit_error_max").value == pytest.approx(
        jget("numerics_logit_error_max").value, abs=1e-4)
    assert get("numerics_logit_error_max").value > 0
    assert get("numerics_score_intmax_max").value > 0
    assert get("numerics_kv_amax_max").value > 0


def test_numerics_probe_noop_on_unquantized_pool(llama):
    jcfg, tcfg, jparams, tparams = llama
    for eng_cls, tel_cls, clock, cfg, params, kw in (
            (JaxEngine, JaxTelemetry, JaxClock, jcfg, jparams, {}),
            (ContinuousEngine, Telemetry, ManualClock, tcfg, tparams,
             {"device": "cpu"})):
        tel, eng = _numerics_run(eng_cls, tel_cls, clock, cfg, params, 1,
                                 "bf16", 2, **kw)
        assert not eng.quantized and tel.c_probes.value == 0
        assert tel.registry.get("numerics_logit_error") is None


# -- the planner's registry -------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_planner_registry_equals_jax_exactly(kv_dtype):
    cands = default_candidates(4, 2)
    shape = dict(n_q_heads=8, n_kv_heads=2, head_dim=64, block_size=16,
                 kv_dtype=kv_dtype)
    jreg, treg = jax_metrics.MetricRegistry(), port_metrics.MetricRegistry()
    jp = JaxPlanner(cands, registry=jreg, **shape)
    tp = GridPlanner(cands, registry=treg, **shape)
    rng = np.random.default_rng(len(kv_dtype))
    for _ in range(40):
        lengths = rng.integers(0, 2048, 8)
        w = 1 << int(np.ceil(np.log2(max(lengths.max() // 16 + 1, 1))))
        jd, td = jp.plan_decode(lengths, w), tp.plan_decode(lengths, w)
        assert (td.kv_tile_blocks, td.split_k, td.predicted_s) == \
            (jd.kv_tile_blocks, jd.split_k, jd.predicted_s)
        measured = float(rng.lognormal(-7.0, 1.0))
        jp.observe_measured(jd, measured)
        tp.observe_measured(td, measured)
    jp.observe_measured(jd, 0.0)       # a non-positive measurement is
    tp.observe_measured(td, 0.0)       # not recorded
    assert treg.snapshot() == jreg.snapshot()
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert tp.decisions == jp.decisions and tp.summary() == jp.summary()
    assert treg.get("autotune_decisions_total").value == 40
    assert treg.get("autotune_measured_step_seconds").count == 40
