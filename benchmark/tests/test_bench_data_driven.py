"""A later change adds a traffic mix, a metric and a cell as new files and
entries, and the harness runs them without an edit to any file that is
there."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

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
