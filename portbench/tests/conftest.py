"""Fixtures of portbench's tests: a small checkout (``small_root``) whose
BENCHMARK.json adds 48 x 80 and 300 x 417 cells of both traffic mixes, run
on the CPU through the port's plain versions; the ``card`` marker for tests that
need a CUDA card, which skip here."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; run on the chip with `python -m pytest portbench/tests -m card`")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: portbench's card tests run on the chip")
    return torch.device("cuda", 0)


SIZES = {"small": (48, 80), "mid": (300, 417)}
MIXES = ("photo", "poster")


def make_root(tmp: Path) -> Path:
    """A checkout with BENCHMARK.json and portbench/, plus cells
    ``<size>.<mix>`` for each of :data:`SIZES` and :data:`MIXES`: two images
    a call, a ring of four."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for size, (h, w) in SIZES.items():
        config = json.loads((root / "portbench/configs/a4-2000.json").read_text())
        config.update(name=size, image_height=h, image_width=w)
        (root / f"portbench/configs/{size}.json").write_text(json.dumps(config))
        bench["configs"].append({"name": size, "source": "https://example.org", "file": f"portbench/configs/{size}.json",
                                 "reduced": [], "why": "a test size"})
        for mix in MIXES:
            params = json.loads((root / f"portbench/traffic/{mix}.json").read_text())
            params.update(call_images=2, ring_images=4)
            (root / f"portbench/traffic/{mix}-{size}.json").write_text(json.dumps(params))
            cell = f"{size}.{mix}"
            bench["workloads"].append({"name": cell, "config": size, "traffic": f"{mix}-{size}", "chips": 1,
                                       "why": "a test cell"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if "workloads" in m and f"a4-2000.{mix}" in m["workloads"]:
                    m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path)
