"""The port stands alone: nothing under ``src/repro_torch/``, and not
``chip_smoke.py``, imports JAX, the JAX package or ``ml_dtypes`` (which
comes with JAX, and the card's machine has none); its entry points default
to the CUDA card and never to the CPU."""
import ast
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import (autotune_bench, decode_paged_bench,
                                    fleet_bench, restore_bench,
                                    serve_throughput, table3_accuracy)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_walk_covers_the_telemetry_modules():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/serve/metrics.py",
            "src/repro_torch/serve/telemetry.py"} <= names


def test_the_walk_covers_the_fleet_and_durability_modules():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"src/repro_torch/serve/{m}.py" for m in (
        "router", "journal", "frontend", "supervisor", "snapshot")} | {
        "src/repro_torch/benchmarks/fleet_bench.py",
        "src/repro_torch/benchmarks/restore_bench.py"} <= names


def test_the_walk_covers_the_family_modules():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"src/repro_torch/models/{m}.py"
            for m in ("mla", "hymba", "rwkv6", "whisper")} <= names


def test_the_walk_covers_the_parallel_modules():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {f"src/repro_torch/parallel/{m}.py" for m in (
        "sharding", "collectives", "ring_attention", "pipeline")} | {
        "src/repro_torch/launch/mesh.py",
        "src/repro_torch/utils/tree.py"} <= names


def test_the_parallel_entry_points_take_the_card():
    """``make_host_mesh`` defaults to the card (and, without one, raises
    rather than falling back to the CPU); the ring runs where its mesh is
    and refuses tensors on another device type."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.ring_attention import ring_attention
    assert inspect.signature(make_host_mesh).parameters["device"] \
        .default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
    mesh = make_host_mesh(device="cpu")
    assert mesh.device_type == "cpu"
    q = torch.zeros(1, 2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="mesh over cpu"):
        ring_attention(q, q, q, mesh)
    x = torch.randn(1, 2, 8, 4)
    assert ring_attention(x, x, x, mesh).device.type == "cpu"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_default_to_the_card():
    for engine in (ContinuousEngine, ServeEngine):
        assert inspect.signature(engine).parameters["device"] \
            .default is None
    assert launch_serve.parse_args([]).device == "cuda"
    assert launch_serve.parse_args([]).engine == "static"
    for engine in ("static", "paged"):
        assert launch_serve.parse_args(["--engine", engine]).device == "cuda"
    tel = launch_serve.parse_args(["--engine", "paged", "--telemetry",
                                   "--metrics-out", "m.prom", "--trace-out",
                                   "t.json", "--numerics-every", "1"])
    assert tel.device == "cuda" and tel.telemetry is True
    assert serve_throughput.parse_args([]).device == "cuda"
    assert serve_throughput.parse_args([]).no_overhead_check is False
    assert launch_train.parse_args([]).device == "cuda"
    assert table3_accuracy.parse_args([]).device == "cuda"
    assert decode_paged_bench.parse_args([]).device == "cuda"
    assert autotune_bench.parse_args([]).device == "cuda"
    assert fleet_bench.parse_args([]).device == "cuda"
    assert restore_bench.parse_args([]).device == "cuda"
    assert launch_serve.parse_args(["--engine", "paged", "--replicas",
                                    "2"]).device == "cuda"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
