"""Whole runs of the harness with the timed path broken underneath, on the
CPU at a tiny size (the look for a chip skipped): the sound run is
correct, and each fault that a cell of this benchmark can have makes
`correct` false. The control (the reference in bfloat16 in the program's
place) is held at the tiny size here and at the cells' own size on the
card, where that test skips without one.

The faults: a step that returns its state unchanged (the tracking step
hands back the pose it was given); half of the batch left out (half of
each frame's descriptors never computed); an answer altered where it is
produced (the pose a frame returns, moved by 10 cm on every fifth frame;
the keypoint depths 10 % long; the keyframe step's new keyframe and
points moved by 10 cm).
There is no exchange between chips: every cell runs on one. The faults
are `slambench/faults.py`'s, which `python -m slambench.limits` also
plants on the card at the cells' own size.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from slambench import faults, run
from slambench.test_slambench_harness import ROOT, _tiny_root

# limits for the tiny cell only (320x240, 400 features, 8 frames a pass)
TINY_LIMITS = {"desc_bits_pct": 0.5, "depth_gap_m": 0.0, "pose_gap_mm": 60.0,
               "rot_gap_deg": 1.0, "kf_gap_mm": 60.0, "lost": 0.0}


@pytest.fixture
def tiny(tmp_path):
    root = _tiny_root(tmp_path)
    (root / "slambench" / "limits").mkdir()
    (root / "slambench" / "limits" / "tiny-rgbd.mini.json").write_text(json.dumps(TINY_LIMITS))
    return root


def _run(root: Path) -> dict:
    return run.run_cell(root, "tiny-rgbd.mini", 2**31 + 99, 30.0, False, device="cpu")["result"]


def test_sound_run_is_correct(tiny):
    r = _run(tiny)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault,number,above", [
    ("unchanged", "pose_gap_mm", TINY_LIMITS["pose_gap_mm"]),
    ("half", "desc_bits_pct", 10.0),
    ("altered_pose", "pose_gap_mm", 90.0),
    ("altered_depth", "depth_gap_m", 0.1),
    ("altered_map", "kf_gap_mm", TINY_LIMITS["kf_gap_mm"]),
])
def test_planted_fault_fails(tiny, fault, number, above):
    with faults.plant(fault):
        r = _run(tiny)
    assert not r["correct"]
    assert r["checks"][number]["value"] > above


def test_control_reference_in_bfloat16_fails(tiny):
    out = run.run_cell(tiny, "tiny-rgbd.mini", 2**31 + 99, 3.0, False, device="cpu",
                       control="bf16")
    r = out["result"]
    assert not r["correct"]
    assert r["checks"]["desc_bits_pct"]["value"] > TINY_LIMITS["desc_bits_pct"]
    assert r["checks"]["depth_gap_m"]["value"] > TINY_LIMITS["depth_gap_m"]
    # the same window's own numbers pass
    assert out["sound"]["desc_bits_pct"] <= TINY_LIMITS["desc_bits_pct"]


@pytest.mark.cuda
def test_control_in_lower_precision_fails_on_the_card():
    """The control at each cell's own size: the reference in bfloat16 put in
    the program's place fails the cell's frame-build limits, so the run is
    not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    run.set_process_env()
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        out = run.run_cell(ROOT, w["name"], 2**31 + 3, 12.0, False, control="bf16")
        r = out["result"]
        assert not r["correct"], r["checks"]
        limits = json.loads((ROOT / "slambench" / "limits" / f"{w['name']}.json").read_text())
        assert all(out["sound"][n] <= lim for n, lim in limits.items()), out["sound"]
        assert r["checks"]["desc_bits_pct"]["value"] > limits["desc_bits_pct"]
        if "depth_gap_m" in limits:
            assert r["checks"]["depth_gap_m"]["value"] > limits["depth_gap_m"]
