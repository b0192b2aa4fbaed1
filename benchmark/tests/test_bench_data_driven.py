"""A later change adds a traffic mix, a metric, a cell or a configuration
with a reference model of its own as new files and entries, and the harness
runs them without an edit to any file that is there."""

from __future__ import annotations

import ast
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec as spec_module

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_mix_metric_and_cell_need_no_edit(tmp_path):
    checkout = tmp_path / "checkout"
    shutil.copytree(BENCH, checkout / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", checkout / "BENCHMARK.json")
    before = _digests(checkout / "benchmark")

    bench = checkout / "benchmark"
    mix = json.loads((bench / "traffic" / "eval.json").read_text())
    mix.update(targets=5, pool=2, check_scenes=1, trace_scenes=1)
    (bench / "traffic" / "eval_five.json").write_text(json.dumps(mix))
    (bench / "metrics" / "views_per_scene.py").write_text(
        '"""Target views of a scene."""\n\n\ndef read(run):\n    return float(run.views)\n'
    )
    (bench / "limits" / "re10k.eval_five.json").write_text((bench / "limits" / "re10k.eval.json").read_text())
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "re10k.eval_five", "config": "re10k", "traffic": "eval_five", "chips": 1,
                              "why": "five target views"})
    spec["end_to_end"].append({"name": "views_per_scene", "unit": "views", "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": ["re10k.eval_five"]})
    next(m for m in spec["end_to_end"] if m["name"] == "scene_ms")["workloads"].append("re10k.eval_five")
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))

    script = f"""
import json, sys, time
sys.path.insert(0, {str(checkout)!r}); sys.path.insert(1, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark import harness, spec
assert spec.HERE == __import__('pathlib').Path({str(bench)!r})
cell = spec.load_cell("re10k.eval_five", {str(checkout / "BENCHMARK.json")!r})
cell.config = json.loads(open({str(BENCH / "tests" / "tiny_config.json")!r}).read())
harness.work.flops_of = lambda name: {{"eval_scene": 1.0}}
print(json.dumps(harness.run_cell(cell, 5, 0.2, False, "cpu", time.perf_counter())))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=checkout, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["metrics"]["views_per_scene"]["value"] == 5.0
    assert "scene_ms" in result["metrics"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_configuration_needs_no_edit(tmp_path):
    """A configuration whose reference model is a module of its own, added
    with its limits, FLOP count and cell as new files and entries; the
    module has no `settle_draws`, so the checked scenes' draws stay as
    made."""
    checkout = tmp_path / "checkout"
    shutil.copytree(BENCH, checkout / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", checkout / "BENCHMARK.json")
    before = _digests(checkout / "benchmark")

    bench = checkout / "benchmark"
    config = json.loads((BENCH / "tests" / "tiny_config.json").read_text())
    config.update(name="tiny_alias", reference="epipolar_alias")
    (bench / "configs" / "tiny_alias.json").write_text(json.dumps(config))
    (bench / "reference" / "epipolar_alias.py").write_text(
        '"""pixelSplat\'s epipolar encoder, its draws left as made."""\n\n'
        "from .encoder import Encoder, apply_shims  # noqa: F401\n"
    )
    (bench / "limits" / "tiny_alias.eval.json").write_text((bench / "limits" / "re10k.eval.json").read_text())
    out = subprocess.run([sys.executable, "-m", "benchmark.work", "tiny_alias"], cwd=checkout,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads((bench / "flops" / "tiny_alias.json").read_text())["eval_scene"] > 0
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_alias", "source": "https://arxiv.org/abs/2312.12337",
                            "file": "benchmark/configs/tiny_alias.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_alias.eval", "config": "tiny_alias", "traffic": "eval", "chips": 1,
                              "why": "a configuration with a reference module of its own"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))

    script = f"""
import json, sys, time
sys.path.insert(0, {str(checkout)!r}); sys.path.insert(1, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark import check, generator, harness, spec
assert spec.HERE == __import__('pathlib').Path({str(bench)!r})
cell = spec.load_cell("tiny_alias.eval", {str(checkout / "BENCHMARK.json")!r})
cell.traffic.update(pool=4, check_scenes=2)
module = spec.reference_module(cell.config)
assert module.__name__ == "benchmark.reference.epipolar_alias" and not hasattr(module, "settle_draws")
seen = {{}}
compare = check.CHECKS["eval"]
def spy(cell, run, seed, device):
    seen.update(units=run.outputs["units"], checked=[s["unit"] for s in run.outputs["scenes"]])
    return compare(cell, run, seed, device)
check.CHECKS["eval"] = spy
result = harness.run_cell(cell, 2**31 + 5, 0.2, False, "cpu", time.perf_counter())
made = generator.make_units(cell.traffic, cell.config, 2**31 + 5, "cpu")
result["as_made"] = [torch.equal(seen["units"][i].u, made[i].u) for i in seen["checked"]]
print(json.dumps(result))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=checkout, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["as_made"] and all(result["as_made"])
    assert "setup_s" in result["metrics"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("name", ["re10k", "re10k_3_view"])
def test_configurations_find_their_reference(name):
    config = spec_module.load_json(BENCH / "configs" / f"{name}.json")
    assert Path(spec_module.reference_module(config).__file__) == BENCH / "reference" / "encoder.py"


@pytest.mark.parametrize(("name", "message"), [("../x", "not a module name"), ("rasterizer", "lacks")])
def test_reference_lookup_refuses(name, message):
    with pytest.raises(ValueError, match=message):
        spec_module.reference_module({"name": "x", "reference": name})


def _names_reference_encoder(node: ast.AST) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name.endswith("reference.encoder") for a in node.names)
    if isinstance(node, ast.ImportFrom):
        module = node.module or ""
        return module.endswith("reference.encoder") or (
            module.split(".")[-1] == "reference" and any(a.name == "encoder" for a in node.names)
        )
    return False


def test_harness_names_no_reference_model():
    """Only the lookup (`spec.reference_module`) says which reference model
    a cell runs."""
    for path in sorted(p for p in BENCH.rglob("*.py") if not {"reference", "tests"} & set(p.relative_to(BENCH).parts)):
        tree = ast.parse(path.read_text())
        assert not any(_names_reference_encoder(node) for node in ast.walk(tree)), path
