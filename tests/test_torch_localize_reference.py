"""Localization mode against its plain reference
(`slambench/reference_localize.py`), and the benchmark's localization
configuration against its mix.

The session is the `loc_sessions` pattern of
`tests/test_torch_session_features.py` on the port alone: map a forward
sequence at the tests' 640x480 configuration, enter localization mode,
yaw away from the map in even steps until the odometry (mbVO) takes over,
and back until relocalization re-anchors. `tools/localize_parity.Capture`
records what each localization frame started from and what the port
returned; the reference recomputes each frame from those inputs.

Tolerances (the chip run's, `tools/localize_parity.py`): the same decision
(map / VO / LOST) on every frame that does not relocalize; camera centres
within 1e-4 m and rotations within 0.01 degrees; inlier counts equal on
99 % of the frames and within 2 on the rest.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from slambench import cell, reference_localize as ref, render
from tests.test_e2e_rgbd import small_cfg
from tests.torch_config import port_config
from tests.torch_threads import share_cores
from tools import localize_parity

share_cores()

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def session():
    """The yawed localization session on the CPU, compared frame by frame."""
    return localize_parity.yaw_session(port_config(small_cfg()), "cpu")


def test_port_matches_the_reference_frame_by_frame(session):
    """Every localization frame captured; the map, the hand-over to the
    odometry and the odometry's own frames all met; the decisions, poses
    and inliers within the tolerances."""
    rows = session["rows"]
    assert len(rows) == session["n"]
    kinds = {(r["kind"], r["port"]) for r in rows}
    assert ("step", "map") in kinds and ("step", "VO") in kinds and ("vo", "VO") in kinds, kinds
    v = localize_parity.verdict(rows)
    assert v["decisions_equal"] == v["compared"], [r for r in rows if r["port"] != r["ref"]]
    assert v["poses_ok"], (v["dt_max_m"], v["drot_max_deg"])
    assert v["inliers_equal_share"] >= localize_parity.INLIER_SHARE, rows
    assert v["inliers_max_gap"] <= localize_parity.INLIER_SLACK, rows


def test_accepted_frames_hand_on_their_reference_keyframe(session):
    """Each frame accepted on the map hands the next frame its reference
    keyframe: the keyframe that observes most of its tracked points once
    the reference observes fewer than half as many (ORB-SLAM2's
    UpdateLocalKeyFrames): the frozen map makes no keyframe that would take
    over, and a reference left behind loses the camera."""
    recs = session["records"]
    pairs = [(a, b) for a, b in zip(recs, recs[1:])
             if a["kind"] == b["kind"] == "step" and a["decision"] == "map"]
    assert len(pairs) >= 5
    assert all(b["prev"].ref_kf == a["local_ref"] >= 0 for a, b in pairs)


def test_reference_keyframe_hands_over_below_half():
    """The rule itself, in the port and in the reference alike: the
    reference keyframe stays while it observes at least half as many of the
    tracked points as the keyframe observing most of them, and hands over
    to that keyframe below half; -1 when nothing is tracked."""
    import torch

    from orbslam2_tpu_torch.pipeline import tracking as trk
    from orbslam2_tpu_torch.slam_map import map_state as ms

    cfg = port_config(small_cfg())
    m = ms.allocate(cfg.map, cfg.orb, torch.device("cpu"))
    m.kf_valid[:3] = True
    m.mp_valid[:10] = True
    m.mp_obs_kf[:10, 0] = 1              # keyframe 1 observes all ten points
    m.mp_obs_kf[:4, 1] = 2               # keyframe 2 four of them
    bind = torch.full((cfg.orb.feature_slots,), -1, dtype=torch.int32)
    bind[:10] = torch.arange(10, dtype=torch.int32)
    none = torch.full_like(bind, -1)
    assert int(trk.reference_keyframe(m, bind, 2)) == ref.next_reference(m, bind, 2) == 1
    assert int(trk.reference_keyframe(m, bind, 1)) == ref.next_reference(m, bind, 1) == 1
    m.mp_obs_kf[4, 1] = 2                # five of ten: kept
    assert int(trk.reference_keyframe(m, bind, 2)) == ref.next_reference(m, bind, 2) == 2
    assert int(trk.reference_keyframe(m, none, 2)) == ref.next_reference(m, none, 2) == -1


def test_relocalized_frames_end_their_comparison(session):
    """The frames on which relocalization won are reported, not compared."""
    rows = session["rows"]
    won = [r for r in rows if r["port"] == "reloc"]
    assert won and all(r["ref"] == "reloc" and r["dt_m"] is None for r in won)
    assert session["taken"]["counters"]["localization.reloc_won"] == len(won)


def test_the_map_is_frozen(session):
    """The map's structure bit-equal across the localization frames (the
    visibility counters exempt), no keyframe made, every frame counted."""
    slam = session["slam"]
    assert localize_parity.map_changes(session["before"], slam.map) == []
    assert slam.num_keyframes() == session["n_kf"]
    counters = session["taken"]["counters"]
    assert counters.get("mapping.keyframes", 0) == 0
    assert counters["localization.frames"] == session["n"]
    # left in mbVO: the hand-overs, and the odometry path's frames that
    # relocalization did not win
    rows = session["rows"]
    vo = sum(r["kind"] == "step" and r["port"] == "VO" or r["kind"] == "vo" and r["port"] != "reloc"
             for r in rows)
    assert counters["localization.vo"] == vo


def test_bfloat16_pose_optimisation_fails_the_pose_tolerance(session):
    """The control: the reference's pose optimisation rounded to bfloat16
    on the fused-step frames moves the poses beyond the tolerance."""
    steps = [r for r in session["records"] if r["kind"] == "step"]
    import torch

    v = localize_parity.verdict(localize_parity.compare(steps, session["slam"].map,
                                                        session["settings"],
                                                        precision=torch.bfloat16))
    assert not v["poses_ok"], v


def test_localization_spans(session):
    """Each odometry-path frame's `tracking.localization_vo` span holds the
    relocalization attempt and, where relocalization failed, `tracking.vo`."""
    spans = session["taken"]["spans"]
    loc = [i for i, s in enumerate(spans) if s.name == "tracking.localization_vo"]
    assert len(loc) == sum(r["kind"] == "vo" for r in session["rows"])
    for i in loc:
        assert spans[spans[i].parent].name == "frame"
        names = [s.name for s in spans if s.parent == i]
        assert names[0] == "tracking.relocalize", names
    vo = [s for s in spans if s.name == "tracking.vo"]
    assert vo and all(spans[s.parent].name == "tracking.localization_vo" for s in vo)
    assert len(vo) == sum(r["kind"] == "vo" and r["port"] != "reloc" for r in session["rows"])


# -- the configuration and its mix --------------------------------------------

def _settings(name):
    return cell.parse_settings((ROOT / "slambench" / "configs" / f"{name}.yaml").read_text())


def test_localize_configuration_states_the_deployment():
    s = _settings("tum3-rgbd-localize")
    assert s["reduced"] == [] and s["Benchmark.sensor"] == "RGBD"
    text = " ".join(s["deployment"])
    assert "Localization" in text and "no keyframe or map point is added, moved or removed" in text
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}["tum3-rgbd-localize"]
    assert conf["file"] == "slambench/configs/tum3-rgbd-localize.yaml" and conf["reduced"] == []
    w = {w["name"]: w for w in bench["workloads"]}["tum3-rgbd-localize.fr3-localize"]
    assert (w["config"], w["traffic"], w["chips"]) == ("tum3-rgbd-localize", "fr3-localize", 1)


def test_localize_configuration_builds_the_tum3_session():
    """The same program configuration as `tum3-rgbd`, and the same camera
    keys; the mix switches localization on."""
    bench = cell.load_cell(ROOT, "tum3-rgbd-localize.fr3-localize")
    office = cell.load_cell(ROOT, "tum3-rgbd.fr3-office")
    assert bench.slam_config() == office.slam_config()
    a, b = _settings("tum3-rgbd-localize"), _settings("tum3-rgbd")
    for k, v in b.items():
        if k.startswith(("Camera.", "ORBextractor.", "ThDepth", "DepthMapFactor", "Port.")):
            assert a[k] == v, k
    assert bench.mix["localization"] is True and bench.mix["loop_closing"] is True
    assert bench.mix["pipeline_depth"] == 0
    assert ref.Settings.from_settings(bench.settings).fx == 535.4


def test_localize_mix_joins_without_a_jump():
    """Set-up, the window's first pass, then its last pass twice (the
    driver repeats the last): every frame handed over lies within one
    frame's travel and turn of the one before it, and no frame repeats."""
    c = cell.load_cell(ROOT, "tum3-rgbd-localize.fr3-localize")
    gt = render.trajectory(c.mix, c.fps)
    passes = c.mix["window"]
    assert all(p["map"] == "continue" for p in passes)
    order = cell.frame_order(c.mix["setup"])
    for p in passes + [passes[-1]]:
        order += cell.frame_order(p["segments"])
    centres = np.einsum("nji,nj->ni", gt[:, :3, :3], -gt[:, :3, 3])
    step = np.linalg.norm(np.diff(centres[order], axis=0), axis=1)
    speed = c.mix["path"]["speed_m_s"] / c.fps
    assert step.max() <= 1.01 * speed and step.min() > 0.5 * speed, (step.min(), step.max())
    R = gt[order, :3, :3]
    cos = (np.einsum("nij,nij->n", R[1:], R[:-1]) - 1) / 2
    turn = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    # the pan's peak rate: its mean rate times pi / 2
    assert turn.max() <= 1.01 * c.mix["path"]["pan_deg_s"] * np.pi / 2 / c.fps, turn.max()
    n_setup = len(cell.frame_order(c.mix["setup"]))
    assert order[n_setup - 1] == 1292 and min(order[n_setup:]) == 1293
