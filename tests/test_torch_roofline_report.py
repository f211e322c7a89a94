"""The port's ``roofline_report`` and ``perf_compare`` against the JAX
package's on the same dry-run artifacts, in the reference's format: two
meshes, skipped cells, artifacts with and without ``analytic_flops`` (the
latter upgraded through each package's own ``analytic_flops`` and
``Roofline``), and an ``--optimized`` twin of most cells. The report lines,
the markdown table and ``perf_compare.main``'s output are EXACTLY the
reference's; with no artifacts ``roofline_report.main`` prints nothing in
either package."""
import importlib
import json
import os

import pytest

from benchmarks import perf_compare as jax_pc
from benchmarks import roofline_report as jax_rr
from repro.configs.base import ALL_SHAPES
from repro.launch import analytic as jax_analytic
from repro.launch import roofline as jax_roofline
from repro.models.registry import cell_supported, get_config
from repro_torch.benchmarks import perf_compare, roofline_report

MESHES = ("16x16", "2x16x16")
# (mesh, arch, shape, artifact carries analytic_flops, has an optimized twin)
CELLS = [
    ("16x16", "llama3.2-3b", "train_4k", True, True),
    ("16x16", "qwen3-4b", "decode_32k", False, True),
    ("16x16", "deepseek-v2-236b", "prefill_32k", False, True),
    ("16x16", "llama3.2-3b", "long_500k", None, True),
    ("16x16", "rwkv6-7b", "long_500k", True, True),
    ("16x16", "granite-3-8b", "prefill_32k", False, False),
    ("2x16x16", "whisper-base", "train_4k", False, True),
    ("2x16x16", "hymba-1.5b", "long_500k", True, True),
    ("2x16x16", "moonshot-v1-16b-a3b", "long_500k", None, True),
    ("2x16x16", "deepseek-v2-236b", "decode_32k", True, True),
]


def _record(mesh, arch, shape_name, analytic, seed, optimized):
    """One artifact as the reference's dry run writes it; ``analytic``
    False drops the key, as artifacts written before the count did."""
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    skip = cell_supported(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "skipped": skip}
    cfg = get_config(arch)
    if optimized:
        cfg = cfg.with_opts(True)
    chips = 256 if mesh == "16x16" else 512
    scale = 0.55 if optimized else 1.0
    coll = 3.1e9 * (seed + 1) * scale
    roof = jax_roofline.Roofline(
        flops_per_chip=2.3e13 * (seed + 1),
        bytes_per_chip=1.7e11 * (seed % 3 + 1) * scale,
        collective_per_chip=coll, chips=chips,
        model_flops=jax_roofline.model_flops(cfg, shape),
        collective_breakdown={"all-gather": coll * 0.75,
                              "all-reduce": coll * 0.25,
                              "reduce-scatter": 0.0, "all-to-all": 0.0,
                              "collective-permute": 0.0},
        analytic_flops=(jax_analytic.analytic_flops(cfg, shape)
                        if analytic else 0.0))
    rf = roof.to_dict()
    if not analytic:
        del rf["analytic_flops"]
    return {"arch": arch, "shape": shape_name, "mesh": mesh,
            "chips": chips, "lower_s": 1.5, "compile_s": 20.25,
            "roofline": rf, "optimized": optimized}


def _write(root, rec):
    path = os.path.join(root, rec["mesh"])
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"{rec['arch']}__{rec['shape']}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """The artifacts under ``tmp_path``, the working directory; both
    report modules read the reference's default folders from there."""
    monkeypatch.chdir(tmp_path)
    assert roofline_report.ART == jax_rr.ART
    assert (perf_compare.BASE, perf_compare.OPT) == (jax_pc.BASE, jax_pc.OPT)
    for mod in (roofline_report, jax_rr):
        monkeypatch.setattr(mod, "ART", jax_pc.BASE)
    for seed, (mesh, arch, shape, analytic, twin) in enumerate(CELLS):
        _write(jax_pc.BASE, _record(mesh, arch, shape, analytic, seed,
                                    False))
        if twin:
            _write(jax_pc.OPT, _record(mesh, arch, shape, not analytic,
                                       seed, True))
    return tmp_path


@pytest.mark.parametrize("mesh", MESHES)
def test_render_matches_reference(artifacts, mesh):
    lines = roofline_report.render(mesh)
    assert lines == jax_rr.render(mesh)
    n = sum(c[0] == mesh for c in CELLS)
    assert len(lines) == n and sum(",SKIP" in x for x in lines) == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_markdown_table_matches_reference(artifacts, mesh):
    assert roofline_report.markdown_table(mesh) == jax_rr.markdown_table(mesh)


@pytest.mark.parametrize("mesh", MESHES)
def test_upgrade_matches_reference(artifacts, mesh):
    """Every loaded record, upgraded or not, is the reference's."""
    assert roofline_report.load(mesh) == jax_rr.load(mesh)
    assert all(r.get("skipped") or r["roofline"]["analytic_flops"] > 0
               for r in roofline_report.load(mesh))


@pytest.mark.parametrize("mesh", MESHES)
def test_perf_compare_matches_reference(artifacts, mesh, capsys):
    perf_compare.main(mesh)
    got = capsys.readouterr().out
    jax_pc.main(mesh)
    want = capsys.readouterr().out
    assert got == want
    assert got.count("\nperf,") == sum(
        c[0] == mesh and c[3] is not None and c[4] for c in CELLS)


def test_roofline_report_main_prints_the_rows(artifacts, capsys):
    """``main`` prints a provenance header, then every mesh's rows."""
    roofline_report.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# provenance: ")
    header = json.loads(out[0].removeprefix("# provenance: "))
    assert header["measurement_mode"] == "dryrun-artifacts"
    assert out[1:] == jax_rr.render("16x16") + jax_rr.render("2x16x16")


def test_main_prints_nothing_without_artifacts(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.chdir(tmp_path)
    for mod in (roofline_report, jax_rr):
        monkeypatch.setattr(mod, "ART", jax_pc.BASE)
    roofline_report.main()
    jax_rr.main()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("mod", [roofline_report, jax_rr],
                         ids=["port", "reference"])
def test_art_honours_dryrun_art(mod, tmp_path, monkeypatch):
    monkeypatch.setenv("DRYRUN_ART", str(tmp_path / "elsewhere"))
    try:
        assert importlib.reload(mod).ART == str(tmp_path / "elsewhere")
    finally:
        monkeypatch.delenv("DRYRUN_ART")
        assert importlib.reload(mod).ART == "artifacts/dryrun"
