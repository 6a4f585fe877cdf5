"""The harness on the CPU: cells, mixes and metrics found by name from files
alone; the trace's reduction; no card, no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import REPO


def run(root, cell, seconds=0.4, trace=False, seed=2**31 + 77):
    return harness.run_cell(harness.find_cell(cell, root), seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


def test_portbench_new_files_only(small_root):
    """A configuration, a mix, an entry's cell and a metric added as new files
    and entries of BENCHMARK.json: the harness runs them, edits nowhere."""
    (small_root / "portbench/metrics/calls_per_s.py").write_text(
        "def read(run):\n    return run.window.calls / run.window.seconds\n")
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["small.photo"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run(small_root, "small.photo")
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"mpx_s", "setup_s", "calls_per_s"}
    assert list(res)[-1] == "checks" and res["checks"] == {"edges_off": {"value": 0, "limit": 0},
                                                           "skeletons_off": {"value": 0, "limit": 0}}
    assert res["built"] == []  # the plain versions: nothing to build


def test_portbench_traced_run_on_cpu_reads_no_device(small_root):
    res = run(small_root, "small.poster", trace=True, seed=-5)
    assert res["correct"] and res["metrics"] == {}  # no device trace on the CPU: every per-layer reader is silent
    assert res["device"]["busy_s"] == 0.0


def test_portbench_trace_reduction():
    ms = 1_000_000
    events = [("Memcpy HtoD (Pageable -> Device)", True, 0, ms),  # the primer
              ("kernelA_edge_tiles", True, 60 * ms, 61 * ms), ("cudaLaunchKernel", False, 61 * ms, 62 * ms),
              ("zs_cluster_run", True, 62 * ms, 64 * ms), ("kernelA_edge_tiles", True, 63 * ms, 65 * ms),
              ("cudaStreamSynchronize", False, 65 * ms, 70 * ms), ("Memcpy DtoH (Device -> Pageable)", True, 69 * ms,
                                                                       70 * ms)]
    t = harness.summarize(events)
    assert (t.window_s, t.busy_s) == pytest.approx((0.010, 0.005))
    assert t.gaps == pytest.approx({"cudaLaunchKernel": 0.001, "cudaStreamSynchronize": 0.004})
    assert t.seconds(("edge_tiles",)) == (0.003, 2) and t.seconds(("Memcpy",)) == (0.001, 1)


def test_portbench_sample_is_drawn_from_the_seed():
    picks = []
    for _ in range(2):
        s = harness.Sample(4, 123)
        for i in range(1000):
            s.offer(i, i)
        picks.append(sorted(i for i, _ in s.items))
    assert picks[0] == picks[1] and len(picks[0]) == 4 and max(picks[0]) >= 4


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "a4-2000.photo", "--seed", "5",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_portbench_no_card_no_result():
    proc = _command(REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_portbench_needs_the_program(small_root):
    """In a directory of BENCHMARK.json and portbench/ alone the run fails:
    the harness brings no copy of the program."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, time, torch; sys.path[0] = '.'; from portbench import harness; "
            "harness.run_cell(harness.find_cell('small.photo'), 1, 0.2, False, torch.device('cpu'), time.perf_counter())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=small_root, capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0 and "plotweave_torch" in proc.stderr
