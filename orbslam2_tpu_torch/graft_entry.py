"""Entry points: the per-frame compute on one device, and a dry run of the
sharded solvers over a group of ranks.

Port of the repository's `__graft_entry__.py`. `entry()` returns the
tracking hot path as one function (ORB extraction, projection search of
the local map points, robust pose optimisation), which launches K1 in the
search and K2 in the pose optimisation on a CUDA device.
`dryrun_multichip(n)` runs one sharded global-BA step and one sharded
pose-graph solve over `n` spawned ranks.

    python -m orbslam2_tpu_torch.graft_entry [--device cuda|cpu]

runs both, the dry run over one rank per card (8 ranks on the CPU, the
reference tests' device count). Everything runs on the card unless the
caller asks for the CPU; without a card a CUDA request raises, and a
group asks for at most one rank per card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from orbslam2_tpu_torch.config import CameraConfig, OrbConfig
from orbslam2_tpu_torch.geometry import camera, se3, sim3
from orbslam2_tpu_torch.geometry.camera import Intrinsics
from orbslam2_tpu_torch.ops import match
from orbslam2_tpu_torch.ops.orb import OrbExtractor
from orbslam2_tpu_torch.parallel import group, sharded_ba, sharded_pose_graph
from orbslam2_tpu_torch.solvers import ba, pose_graph
from orbslam2_tpu_torch.solvers.cuda_pose_opt import pose_optimize_fast
from orbslam2_tpu_torch.solvers.pose_opt import PoseObservations

LOCAL_POINTS = 2048


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def entry(device="cuda"):
    """Returns (fn, example_args): `fn(image, mp_pos, mp_desc, mp_valid,
    Tcw0)` tracks one 640x480 frame against `LOCAL_POINTS` map points and
    returns (Tcw [4, 4], num_inliers, the frame's descriptors [1024, 8]);
    the example arguments, made from seed 0 as the reference's are, lie on
    `device`."""
    dev = _device(device)
    ocfg = OrbConfig(num_features=1000, feature_slots=1024)
    K = Intrinsics.from_config(CameraConfig(), dev)
    extractor = OrbExtractor(ocfg).to(dev)

    def track_step(image, mp_pos, mp_desc, mp_valid, Tcw0):
        """image -> ORB features -> the local points projected and matched
        (K1) -> robust pose optimisation (K2)."""
        feats = extractor(image)
        P, S = mp_pos.shape[0], feats.xy.shape[0]
        pc = se3.apply(Tcw0, mp_pos)
        uv = camera.project(pc, K)
        vis = mp_valid & (pc[:, 2] > 0.1)
        res = match.search_by_projection(
            mp_desc, uv, torch.zeros(P, dtype=torch.int32, device=dev), vis,
            feats.desc, feats.xy, feats.octave, feats.valid,
            radius=torch.full((P,), 8.0, device=dev),
        )
        bound = torch.where(res.assigned >= 0, res.assigned, 0)
        obs = PoseObservations(
            pw=mp_pos[bound], uv=feats.xy, ur=torch.full((S,), -1.0, device=dev),
            inv_sigma2=torch.ones(S, device=dev), mask=(res.assigned >= 0) & feats.valid,
        )
        out = pose_optimize_fast(Tcw0, obs, K)
        return out.Tcw, out.num_inliers, feats.desc

    cam = CameraConfig()
    rng = np.random.default_rng(0)
    P = LOCAL_POINTS
    image = rng.uniform(0, 255, (cam.height, cam.width)).astype(np.float32)
    mp_pos = np.c_[rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                   rng.uniform(2, 10, P)].astype(np.float32)
    mp_desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32).view(np.int32)
    args = (image, mp_pos, mp_desc, np.ones(P, bool), np.eye(4, dtype=np.float32))
    return track_step, tuple(torch.from_numpy(a).to(dev) for a in args)


def _dryrun_problems(n_ranks: int, kitti_scale: bool = False):
    """The dry run's problems on the CPU, as the reference builds them: a
    BA problem of C cameras along x, P = 1024 n points (with
    `kitti_scale`, C = 512 and P = 12288 n) seen by O = 8 cameras each,
    noiseless observations and perturbed points; a pose graph of the first
    16 cameras with 8 n chain edges. Returns (BAProblem, Intrinsics,
    PoseGraphProblem)."""
    K = Intrinsics.from_config(CameraConfig(fx=480.0, fy=480.0, bf=240.0), "cpu")
    rng = np.random.default_rng(0)
    C, Pn, O = (512, 12288 * n_ranks, 8) if kitti_scale else (64, 1024 * n_ranks, 8)
    cams = np.stack([se3.exp_se3(torch.tensor([0.3 * i, 0, 0, 0, 0.01 * i, 0])).numpy()
                     for i in range(C)]).astype(np.float32)
    pts = np.c_[rng.uniform(-3, 4, Pn), rng.uniform(-2, 2, Pn),
                rng.uniform(5, 12, Pn)].astype(np.float32)
    obs_cam = np.stack([rng.permutation(C)[:O] for _ in range(Pn)]).astype(np.int64)
    Ts = cams[obs_cam]
    pc = np.einsum("poij,pj->poi", Ts[..., :3, :3], pts) + Ts[..., :3, 3]
    uv = np.stack([480.0 * pc[..., 0] / pc[..., 2] + 319.5,
                   480.0 * pc[..., 1] / pc[..., 2] + 239.5], axis=-1).astype(np.float32)
    prob = ba.BAProblem(
        cam_Tcw=torch.from_numpy(cams),
        cam_free=torch.from_numpy(np.arange(C) >= 2),
        points=torch.from_numpy(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        point_valid=torch.ones(Pn, dtype=torch.bool),
        obs_cam=torch.from_numpy(obs_cam),
        obs_uv=torch.from_numpy(uv),
        obs_ur=torch.full((Pn, O), -1.0),
        obs_inv_sigma2=torch.ones((Pn, O)),
        obs_valid=torch.from_numpy(pc[..., 2] > 0.5),
    )
    Kv, Ev = 16, 8 * n_ranks
    verts = pose_graph.se3_to_pack(torch.from_numpy(cams[:Kv]))
    ei = torch.arange(Ev, dtype=torch.int32) % (Kv - 1)
    ej = ei + 1
    # S_ji = S_j o S_i^-1 (cam i -> cam j)
    meas = sim3.pack(sim3.compose(sim3.unpack(verts[ej.long()]),
                                  sim3.inverse(sim3.unpack(verts[ei.long()]))))
    gprob = pose_graph.PoseGraphProblem(
        vertices=verts, vertex_valid=torch.ones(Kv, dtype=torch.bool),
        vertex_fixed=torch.arange(Kv) == 0, edge_i=ei, edge_j=ej, edge_meas=meas,
        edge_valid=torch.ones(Ev, dtype=torch.bool), edge_weight=torch.ones(Ev),
    )
    return prob, K, gprob


def dryrun_multichip(n_devices: int, device="cuda", kitti_scale: bool = False) -> None:
    """One sharded global-BA step (two LM iterations, the direct camera
    solve) and one sharded pose-graph solve (two GN iterations, eight CG
    steps) over `n_devices` spawned ranks on `device`; prints one line."""
    group.check_device(n_devices, device)
    prob, K, gprob = _dryrun_problems(n_devices, kitti_scale)
    with group.Group(n_devices, device) as g:
        cam, pts, cost = g.run(sharded_ba.sharded_bundle_adjust, prob, K, iters=2)
        verts = g.run(sharded_pose_graph.sharded_optimize_pose_graph, gprob, iters=2,
                      cg_iters=8)
    if not torch.isfinite(cost):
        raise RuntimeError("sharded BA produced a non-finite cost")
    if not torch.isfinite(verts).all():
        raise RuntimeError("sharded pose graph produced non-finite vertices")
    print(f"dryrun_multichip OK: {n_devices} rank(s) on {torch.device(device).type}, "
          f"cost={float(cost):.3f}, cams {tuple(cam.shape)}, points {tuple(pts.shape)}, "
          f"pose-graph verts {tuple(verts.shape)}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args()
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry OK:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(torch.cuda.device_count() if args.device == "cuda" else 8, args.device)


if __name__ == "__main__":
    main()
