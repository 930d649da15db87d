"""On the card: one short run of each one-GPU cell through the command of
BENCHMARK.json, its last line as the contract has it.

    python -m pytest -m cuda perfbench/tests/test_perfbench_cuda.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
ONE_GPU = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_GPU)
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_on_the_card(cell, traced):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, *SPEC["command"][1:], "--workload", cell, "--seed",
         "2147483659", "--seconds", "3", "--trace", str(traced)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    cellobj = harness.Cell(cell)
    want = {m["name"] for m in (cellobj.per_layer() if traced
                                else cellobj.end_to_end())}
    assert set(line["metrics"]) == want
