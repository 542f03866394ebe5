"""The map-scale stress: the port's counterpart of `stress_scale.py`.

    python -m orbslam2_tpu_torch.scale [--device cuda|cpu]

Builds a 1024-keyframe, 98304-point map directly from a seeded numpy
generator (a forward trajectory, each point observed by the 8 keyframes
behind it, keypoints its projections; `stress_scale.py:43-106`) and times,
each with the device synchronised before and after, the structures a long
session leans on (`:108-143`): the observation tables and the covisibility
matrix rebuilt from the bindings, the essential graph's edges (at most
4K), 3 PCG pose-graph iterations of 64 CG steps over that graph, and the
global BA problem with 2 Levenberg-Marquardt iterations. Prints one JSON
line with `stress_scale.py`'s keys, plus `pipeline_depth` (0; no
session runs), the card's `power_limit`, `peak_device_bytes` and the BA
cost before its iterations. Runs on the card unless `--device cpu` is
given, and fails without one.
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import numpy as np
import torch

from orbslam2_tpu_torch import config as c
from orbslam2_tpu_torch import drive, profiling
from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.pipeline import local_mapping as lm
from orbslam2_tpu_torch.pipeline import loop_closing as lc
from orbslam2_tpu_torch.slam_map import map_state as ms
from orbslam2_tpu_torch.solvers import ba, pose_graph

KEYFRAMES, POINTS, SLOTS, OBS = 1024, 98304, 256, 8
CAMERA = c.CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
SEED = 0


def build_arrays(K: int, P: int, S: int, O: int, seed: int) -> dict:
    """`stress_scale.py:55-87`'s arrays: a forward trajectory 0.25 m a
    keyframe, P points in the corridor ahead, each observed by the O
    keyframes behind it at a random feature slot, keypoints, right
    coordinates and depths their projections."""
    rng = np.random.default_rng(seed)
    zs = 0.25 * np.arange(K)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    Tcw[:, 2, 3] = -zs
    pts = np.c_[rng.uniform(-4, 4, P), rng.uniform(-3, 3, P),
                rng.uniform(0.0, zs[-1] + 12.0, P)].astype(np.float32)
    base_kf = np.clip(((pts[:, 2] - 6.0) / 0.25).astype(np.int32), 0, K - O)
    obs_kf = base_kf[:, None] + np.arange(O)[None, :]
    feat = rng.integers(0, S, size=(P, O)).astype(np.int32)
    kf_point_idx = np.full((K, S), -1, np.int32)
    kf_point_idx[obs_kf.reshape(-1), feat.reshape(-1)] = np.repeat(np.arange(P, dtype=np.int32), O)
    kf_xy = np.zeros((K, S, 2), np.float32)
    kf_ur = np.full((K, S), -1.0, np.float32)
    kf_depth = np.full((K, S), -1.0, np.float32)
    for o in range(O):
        k_ids = obs_kf[:, o]
        z = pts[:, 2] + Tcw[k_ids, 2, 3]
        u = 480.0 * pts[:, 0] / np.maximum(z, 0.1) + 319.5
        v = 480.0 * pts[:, 1] / np.maximum(z, 0.1) + 239.5
        kf_xy[k_ids, feat[:, o], 0] = u
        kf_xy[k_ids, feat[:, o], 1] = v
        kf_ur[k_ids, feat[:, o]] = u - 48.0 / np.maximum(z, 0.1)
        kf_depth[k_ids, feat[:, o]] = z
    return dict(kf_Tcw=Tcw, kf_xy=kf_xy, kf_ur=kf_ur, kf_depth=kf_depth,
                kf_point_idx=kf_point_idx,
                kf_parent=np.concatenate([[-1], np.arange(K - 1)]).astype(np.int32),
                mp_pos=pts, mp_ref_kf=base_kf)


def build_state(K: int, P: int, S: int, O: int, seed: int, device) -> ms.MapState:
    """The map of `build_arrays` in a MapState with K keyframe slots (all
    valid) and P + 1024 point slots (the first P valid), as
    `stress_scale.py:89-105` fills it."""
    a = build_arrays(K, P, S, O, seed)
    state = ms.allocate(c.MapConfig(max_keyframes=K, max_points=P + 1024),
                        c.OrbConfig(feature_slots=S), device, obs_slots=O)
    for name in ("kf_Tcw", "kf_xy", "kf_ur", "kf_depth", "kf_point_idx", "kf_parent"):
        getattr(state, name).copy_(torch.from_numpy(a[name]))
    state.kf_valid.fill_(True)
    state.kf_frame_id.copy_(torch.arange(K, dtype=torch.int32))
    state.kf_feat_valid.fill_(True)
    state.mp_pos[:P] = torch.from_numpy(a["mp_pos"]).to(device)
    state.mp_valid[:P] = True
    state.mp_ref_kf[:P] = torch.from_numpy(a["mp_ref_kf"]).to(device)
    state.mp_first_kf[:P] = torch.from_numpy(a["mp_ref_kf"]).to(device)
    state.num_kf.fill_(K)
    state.num_mp.fill_(P)
    return state


def _seconds(timer: profiling.StageTimer) -> dict:
    return {name: times[0] for name, times in timer.times.items()}


def graph_stages(state: ms.MapState, device) -> dict:
    """`stress_scale.py:108-127`'s stages on `state`, in place: the
    observation tables and covisibility rebuilt, the essential edges, 3
    PCG pose-graph iterations. Returns each stage's seconds and what it
    computed: the observations dropped, the edge count and edges, the
    optimised vertices."""
    K = state.capacity_kf
    timer = profiling.StageTimer(device)
    with timer.stage("reconcile_s"):
        truncated = ms.rebuild_observations(state)
        lc.rebuild_covisibility(state)
    with timer.stage("edges_s"):
        ei, ej, meas, evalid, n_total = lc.build_essential_edges(
            state, essential_threshold=100, max_edges=4 * K)
    with timer.stage("pose_graph_3it_s"):
        prob = pose_graph.PoseGraphProblem(
            vertices=pose_graph.se3_to_pack(state.kf_Tcw), vertex_valid=state.kf_valid,
            vertex_fixed=torch.arange(K, device=device) == 0, edge_i=ei, edge_j=ej,
            edge_meas=meas, edge_valid=evalid, edge_weight=torch.where(evalid, 1.0, 0.0))
        packs = pose_graph.optimize_pose_graph_pcg(prob, iters=3, cg_iters=64)
    return dict(obs_truncated=int(truncated), edges_total=int(n_total),
                edges=(ei, ej, meas, evalid), packs=packs, seconds=_seconds(timer))


def ba_stage(state: ms.MapState, device) -> dict:
    """`stress_scale.py:129-143`: the global BA problem over every point
    slot and 2 Levenberg-Marquardt iterations. Returns its seconds and the
    cost after the iterations and before them."""
    timer = profiling.StageTimer(device)
    K = Intrinsics.from_config(CAMERA, device)
    with timer.stage("global_ba_2it_s"):
        gprob, *_ = lm.build_global_ba_problem(state, torch.ones(8, device=device),
                                               max_points=state.capacity_mp,
                                               obs_slots=state.obs_slots)
        cost = float(ba.bundle_adjust(gprob, K, iters=2, use_kernel=True).cost)
    start = float(ba.bundle_adjust(gprob, K, iters=0).cost)
    return dict(gba_cost=cost, gba_cost_start=start, seconds=_seconds(timer))


def run_stages(state: ms.MapState, device) -> dict:
    """`graph_stages`, then `ba_stage`; their results in one dict."""
    g, b = graph_stages(state, device), ba_stage(state, device)
    return {**g, **b, "seconds": {**g["seconds"], **b["seconds"]}}


def run(device) -> dict:
    """The stress at KEYFRAMES keyframes and POINTS points; returns the
    JSON record."""
    K, P = KEYFRAMES, POINTS
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_all = time.perf_counter()
    timer = profiling.StageTimer(device)
    with timer.stage("build_s"):
        state = build_state(K, P, SLOTS, OBS, SEED, device)
    res = run_stages(state, device)
    secs = {**_seconds(timer), **res["seconds"]}
    return {
        "metric": "scale_stress_1024kf",
        "value": time.perf_counter() - t_all,
        "unit": "s total",
        "vs_baseline": 1.0,
        "pipeline_depth": 0,
        "extra": {
            "K": K, "P": P, "obs_slots": OBS,
            "edges_total": res["edges_total"],
            "obs_truncated": res["obs_truncated"],
            **{k: secs[k] for k in ("build_s", "reconcile_s", "edges_s", "pose_graph_3it_s",
                                    "global_ba_2it_s")},
            "gba_cost": res["gba_cost"],
            "gba_cost_start": res["gba_cost_start"],
            "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
            "peak_device_bytes": drive.peak_device_bytes(device),
            **drive.device_fields(device),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the stages run (default: the CUDA device)")
    args = ap.parse_args(argv)
    print(json.dumps(run(drive.require_device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
