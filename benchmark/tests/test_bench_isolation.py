"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Modules are compared by their
whole top-level name (the part before the first dot): the program's name
begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "pixelsplat_tpu"}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _loaded_after(code: str) -> set[str]:
    """Top-level names in sys.modules of a fresh process after `code`."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py") if "tests" not in p.parts))
def test_no_benchmark_file_names_jax(path):
    assert not _top_level_imports(BENCH / path) & JAX


@pytest.mark.parametrize("path", sorted(p.name for p in (BENCH / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(BENCH / "reference" / path)
    assert "pixelsplat_tpu_torch" not in names and not names & JAX
    assert names <= {"__future__", "math", "dataclasses", "functools", "numpy", "torch"}


def test_harness_process_loads_no_jax():
    loaded = _loaded_after(
        "import benchmark.harness, benchmark.loops, benchmark.check, benchmark.port\n"
        "from benchmark import spec\n"
        "[spec.metric_reader(p.stem) for p in sorted((spec.HERE / 'metrics').glob('*.py'))]\n"
        "import pixelsplat_tpu_torch.training.model_wrapper, pixelsplat_tpu_torch.config"
    )
    assert not loaded & JAX, loaded & JAX
    assert "pixelsplat_tpu_torch" in loaded


def test_reference_process_loads_nothing_of_the_program():
    """Every module under `reference/`, those added later too."""
    modules = sorted(f"benchmark.reference.{p.stem}" for p in (BENCH / "reference").glob("*.py") if p.stem != "__init__")
    assert "benchmark.reference.encoder" in modules
    loaded = _loaded_after("import " + ", ".join(modules))
    assert not loaded & (JAX | {"pixelsplat_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "pixelsplat_tpu_torch_fake", object())
    assert "pixelsplat_tpu" not in harness.forbidden_modules() or "pixelsplat_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
