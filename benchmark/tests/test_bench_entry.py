"""The entry point refuses to run without the GPUs a cell asks for, and
prints no result then."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def test_no_result_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "re10k.eval", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
