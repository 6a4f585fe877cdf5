"""On the card: each cell of BENCHMARK.json runs briefly through the command
and comes out correct, with its end-to-end and traced per-layer metrics.
Skips where there is no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_portbench_cell_on_card(card, cell, trace):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
                           "--seconds", "2", "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["metrics"]
