"""The port stands alone: nothing under ``src/repro_torch/``, and not
``chip_smoke.py``, imports JAX or the JAX package; its entry points default
to the CUDA card and never to the CPU."""
import ast
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import table3_accuracy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


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
    assert launch_train.parse_args([]).device == "cuda"
    assert table3_accuracy.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
