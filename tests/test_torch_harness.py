"""The port's last harness files, on the CPU with stub entries:
``repro_torch.benchmarks.bench_trajectory`` (the record/check round trip,
a mode mismatch reported and not gated, a >10% regression failing, the
retries granted to timing entries only, the cross-referenced full
records), ``repro_torch.benchmarks.run`` (its sections called in the
reference's order) and ``repro_torch.examples.softermax_finetune`` (it
prints what ``table3_accuracy.report`` returns)."""
import json

import pytest

from repro_torch.benchmarks import bench_trajectory as bt
from repro_torch.benchmarks import run as run_mod


def _stub(values, mode="cpu-plain", kind="timing", full=None):
    """An entry whose successive runs return ``values`` (the last one
    repeated); ``calls`` counts them."""
    state = {"calls": 0}

    def run():
        v = values[min(state["calls"], len(values) - 1)]
        state["calls"] += 1
        return v
    return {"run": run, "metric": "ratio", "mode": mode, "kind": kind,
            "full": full, "state": state}


@pytest.fixture
def entries(monkeypatch):
    table = {}
    monkeypatch.setattr(bt, "_entries", lambda device: table)
    return table


def _args(tmp_path, *more):
    return ["--baseline", str(tmp_path / "BENCH_torch_trajectory.json"),
            "--device", "cpu", *more]


def test_record_then_check_round_trip(entries, tmp_path, capsys):
    entries.update(a=_stub([2.0]), b=_stub([1.0], mode="token-count",
                                           kind="deterministic"))
    assert bt.main(["--record"] + _args(tmp_path)) == 0
    with open(tmp_path / "BENCH_torch_trajectory.json") as f:
        rec = json.load(f)
    assert rec["bench"] == "trajectory-baselines"
    assert rec["provenance"]["measurement_mode"] == "smoke"
    assert rec["entries"]["a"] == {
        "metric": "ratio", "value": 2.0, "measurement_mode": "cpu-plain",
        "scale": "smoke", "kind": "timing", "direction": "higher"}
    report = tmp_path / "report.json"
    assert bt.main(["--check", "--report", str(report)]
                   + _args(tmp_path)) == 0
    with open(report) as f:
        rows = json.load(f)["entries"]
    assert {k: r["status"] for k, r in rows.items()} == {"a": "ok",
                                                         "b": "ok"}
    assert "bench_trajectory,ok" in capsys.readouterr().out


def test_only_rerecords_in_place(entries, tmp_path):
    entries.update(a=_stub([2.0]), b=_stub([1.0]))
    assert bt.main(["--record"] + _args(tmp_path)) == 0
    entries.update(a=_stub([5.0]), b=_stub([7.0]))
    assert bt.main(["--record", "--only", "b"] + _args(tmp_path)) == 0
    with open(tmp_path / "BENCH_torch_trajectory.json") as f:
        rec = json.load(f)["entries"]
    assert rec["a"]["value"] == 2.0 and rec["b"]["value"] == 7.0


def test_mode_mismatch_is_report_only(entries, tmp_path, capsys):
    entries.update(a=_stub([2.0], mode="cuda"))
    assert bt.main(["--record"] + _args(tmp_path)) == 0
    # the fresh run is another instrument and far lower: not gated
    entries.update(a=_stub([0.1], mode="cpu-plain"))
    assert bt.main(["--check"] + _args(tmp_path)) == 0
    out = capsys.readouterr().out
    assert "status,mode-mismatch-not-gated" in out
    assert entries["a"]["state"]["calls"] == 1


def test_regression_over_threshold_fails(entries, tmp_path, capsys):
    entries.update(a=_stub([1.0], kind="deterministic"))
    assert bt.main(["--record"] + _args(tmp_path)) == 0
    entries.update(a=_stub([0.89], kind="deterministic"))
    assert bt.main(["--check"] + _args(tmp_path)) == 1
    assert "bench_trajectory,FAIL,a: ratio 0.8900 vs baseline 1.0000" in \
        capsys.readouterr().out
    entries.update(a=_stub([0.91], kind="deterministic"))
    assert bt.main(["--check"] + _args(tmp_path)) == 0


@pytest.mark.parametrize("kind,calls,rc", [("timing", 3, 0),
                                           ("deterministic", 1, 1)])
def test_retries_for_timing_entries_only(entries, tmp_path, kind, calls,
                                         rc):
    entries.update(a=_stub([1.0], kind=kind))
    assert bt.main(["--record"] + _args(tmp_path)) == 0
    # two noisy runs, then a clean one: a timing entry's third try passes
    entries.update(a=_stub([0.5, 0.6, 0.99], kind=kind))
    assert bt.main(["--check"] + _args(tmp_path)) == rc
    assert entries["a"]["state"]["calls"] == calls


def test_no_baseline_is_an_error_and_a_new_bench_report_only(
        entries, tmp_path, capsys):
    entries.update(a=_stub([1.0]))
    assert bt.main(["--check"] + _args(tmp_path)) == 2
    assert bt.main(["--record"] + _args(tmp_path)) == 0
    entries.update(c=_stub([3.0]))
    assert bt.main(["--check"] + _args(tmp_path)) == 0
    assert "bench_trajectory,c,ratio,fresh,3.0,baseline,n/a,status," \
        "no-baseline" in capsys.readouterr().out


def test_full_records_are_cross_referenced_not_gated(entries, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    with open("BENCH_torch_full.json", "w") as f:
        json.dump({"ratio": 0.01,
                   "provenance": {"measurement_mode": "cuda"}}, f)
    entries.update(a=_stub([1.0], full=("BENCH_torch_full.json", "ratio")))
    assert bt.main(["--record"] + _args(tmp_path)) == 0
    assert bt.main(["--check", "--report", "r.json"] + _args(tmp_path)) == 0
    with open("r.json") as f:
        full = json.load(f)["full_records"]["a"]
    assert full == {"file": "BENCH_torch_full.json", "metric": "ratio",
                    "value": 0.01, "measurement_mode": "cuda",
                    "scale": "full", "gated": False}


def test_entries_name_the_references_benches_and_modes():
    table = bt._entries("cpu")
    assert list(table) == ["decode_paged", "prefill_paged", "kv_int8",
                           "prefix_cache", "serve_throughput", "autotune",
                           "resilience", "fleet", "restore"]
    assert {n: e["mode"] for n, e in table.items()
            if e["kind"] == "deterministic"} == {
        "autotune": "analytic-cost-model", "fleet": "tick-model",
        "restore": "token-count"}
    assert {e["mode"] for e in table.values() if e["kind"] == "timing"} \
        == {"cpu-plain"}
    assert {e["mode"] for e in bt._entries("cuda").values()
            if e["kind"] == "timing"} == {"cuda"}
    assert all(e["full"] is None or e["full"][0].startswith("BENCH_torch_")
               for e in table.values())


# the reference's benchmarks/run.py, section by section
RUN_ORDER = ["table4_efficiency", "fig5_sweep", "fig1_breakdown",
             "table1_bitwidth_ablation", "table3_accuracy",
             "serve_throughput", "prefix_cache_bench", "prefill_paged_bench",
             "kv_int8_bench", "decode_paged_bench", "autotune_bench",
             "resilience_bench", "fleet_bench", "restore_bench",
             "roofline_report"]


@pytest.mark.parametrize("fast", [True, False])
def test_run_calls_the_sections_in_the_references_order(monkeypatch, fast,
                                                        tmp_path, capsys):
    import importlib
    monkeypatch.chdir(tmp_path)          # no dry-run artifacts here
    calls = []
    for name in RUN_ORDER:
        mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
        monkeypatch.setattr(mod, "main", lambda *a, _n=name: calls.append(
            (_n, a[0] if a else None)))
    run_mod.main((["--fast"] if fast else []) + ["--device", "cpu"])
    want = [n for n in RUN_ORDER if not (fast and n == "table3_accuracy")]
    assert [c[0] for c in calls] == want
    flags = dict(calls)
    assert flags["table4_efficiency"] is None
    assert flags["fig5_sweep"] == ["--device", "cpu"]
    assert flags["serve_throughput"] == (
        ["--fast"] if fast else []) + ["--device", "cpu"]
    assert flags["restore_bench"] == (
        ["--smoke"] if fast else []) + ["--device", "cpu"]
    out = capsys.readouterr().out
    assert out.startswith("# provenance:") and "# total_bench_s," in out
    assert ("table3,skipped(fast)" in out) == fast


def test_softermax_finetune_prints_the_report(monkeypatch, capsys):
    from repro_torch.benchmarks import table3_accuracy
    from repro_torch.examples import softermax_finetune
    results = {"softmax": 2.5, "softermax": 2.51,
               "softermax_fixed_no_finetune": 2.9, "softermax_fixed": 2.52}
    seen = {}

    def run(pretrain_steps, finetune_steps, device):
        seen.update(p=pretrain_steps, f=finetune_steps, d=device)
        return results
    monkeypatch.setattr(softermax_finetune, "run", run)
    text = softermax_finetune.main(["--device", "cpu"])
    assert seen == {"p": 60, "f": 40, "d": "cpu"}
    assert text == table3_accuracy.report(results)
    assert capsys.readouterr().out == text + "\n"
    lines = text.splitlines()
    assert lines[-2:] == ["", "fixed-point drop-in penalty: +0.4000; "
                          "after softermax-aware finetuning: +0.0200"]


@pytest.mark.parametrize("chip", [None, "H100 SXM", "TPU v5e"])
def test_roofline_report_reads_the_artifacts_chip(chip):
    """An artifact's roofline is rebuilt at the rates of the chip it names
    (the TPU entry when it names none, as the reference's artifacts)."""
    from repro_torch.benchmarks.roofline_report import _upgrade
    from repro_torch.launch.roofline import H100_SXM, TPU_V5E
    art = {"arch": "qwen3-4b", "shape": "train_4k", "roofline": {
        "flops_per_chip": 1e12, "bytes_per_chip": 4e9,
        "collective_per_chip": 2e9, "chips": 256, "model_flops": 1e17,
        "analytic_flops": 2e17, "collective_breakdown": {}}}
    if chip:
        art["chip"] = chip
    rf = _upgrade(art)["roofline"]
    rates = H100_SXM if chip == "H100 SXM" else TPU_V5E
    assert rf["compute_s"] == 2e17 / 256 / rates.peak_flops
    assert rf["memory_s"] == 4e9 / rates.hbm_bw
    assert rf["collective_s"] == 2e9 / rates.link_bw
