"""What decides ``correct`` fails where it must: the control (the reference
in the program's place with Lab in bfloat16) and the program broken
underneath a whole run, on the CPU at a small size."""

from __future__ import annotations

import time

import pytest
import torch

import plotweave_torch.ops.frontend as frontend_mod
import plotweave_torch.ops.thinning as thinning_mod
from portbench import harness
from portbench.tests.conftest import MIXES
from portbench.tools.control import control_readings


def run(root, cell, seed=11):
    return harness.run_cell(harness.find_cell(cell, root), seed, 0.3, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("mix", MIXES)
def test_portbench_sound_run_is_correct(small_root, mix):
    res = run(small_root, f"mid.{mix}")
    assert res["correct"] and all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("mix,seed", [("photo", 1), ("photo", 2**33 + 5), ("poster", 1), ("poster", 3)])
def test_portbench_control_is_not_correct(small_root, mix, seed):
    off = control_readings(f"mid.{mix}", seed, torch.device("cpu"), small_root)
    assert sum(off.values()) > 0


def _unchanged(packed, max_iter=120, rotated=True):
    return packed


def _half(real):
    def half(image, centers, **kw):
        b = image.shape[0] // 2
        edges, skels = real(image[:b], centers, **kw)
        pad = torch.zeros((image.shape[0] - b, *edges.shape[1:]), dtype=edges.dtype)
        return torch.cat([edges, pad]), torch.cat([skels, pad])
    return half


def _altered(real):
    def altered(*a, **kw):
        edges, skels = real(*a, **kw)
        edges.view(-1)[edges.numel() // 2] ^= 255
        return edges, skels
    return altered


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("fault", ["state unchanged", "half the batch", "answer altered"])
def test_portbench_fault_is_not_correct(small_root, monkeypatch, mix, fault):
    if fault == "state unchanged":  # the thinning returns its input
        monkeypatch.setattr(thinning_mod, "zhang_suen_packed_plain", _unchanged)
    else:
        wrap = {"half the batch": _half, "answer altered": _altered}[fault]
        monkeypatch.setattr(frontend_mod, "raster_frontend", wrap(frontend_mod.raster_frontend))
    res = run(small_root, f"mid.{mix}")
    assert not res["correct"] and res["failed"] > 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
