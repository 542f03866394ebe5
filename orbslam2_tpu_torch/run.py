"""Command-line runner of the port (the counterpart of `orbslam2_tpu.run`):
a dataset directory, or the synthetic sequence, through `System` on the
card, then the trajectory files and one JSON line.

Usage:
    python -m orbslam2_tpu_torch.run --dataset tum --root /data/fr1_xyz \\
        --settings tum1.yaml --out traj.txt
    python -m orbslam2_tpu_torch.run --dataset synthetic --frames 40 --device cpu

The session runs on the CUDA device unless `--device cpu` is given; with
`--device cuda` (the default) and no CUDA device it fails. The JSON line
has the reference's keys plus `device` (the card's name, or "cpu") and
`decoder`: "native" when the dataset's images went through the native
decoder (`orbslam2_tpu_torch/native`), else "pil", with `decoder_error`
saying why the native one could not be built (null for the synthetic
sequence, which decodes no file).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ORB-SLAM2-class SLAM on PyTorch / CUDA")
    ap.add_argument("--dataset", choices=["tum", "kitti", "euroc", "synthetic"],
                    required=True)
    ap.add_argument("--root", help="dataset root directory")
    ap.add_argument("--settings", help="ORB-SLAM2-style YAML settings file")
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"], default=None)
    ap.add_argument("--out", default="trajectory.txt", help="TUM-format output")
    ap.add_argument("--kf-out", default=None, help="keyframe trajectory output")
    ap.add_argument("--kitti-out", default=None, help="KITTI-format output")
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--viz", default=None, help="directory for PNG snapshots")
    ap.add_argument("--frames", type=int, default=0, help="limit frame count")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--log", default=None,
                    help="stream per-frame events as JSONL to this file")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the session runs (default: the CUDA device)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2

    from orbslam2_tpu_torch.config import SlamConfig, Sensor, load_yaml_settings
    from orbslam2_tpu_torch.pipeline.system import System

    sensor_map = {"mono": Sensor.MONOCULAR, "stereo": Sensor.STEREO, "rgbd": Sensor.RGBD}
    default_sensor = {"tum": "rgbd", "kitti": "stereo", "euroc": "stereo",
                      "synthetic": "rgbd"}[args.dataset]
    sensor = sensor_map[args.sensor or default_sensor]

    if args.settings:
        cfg = load_yaml_settings(args.settings, sensor)
    else:
        cfg = SlamConfig(sensor=sensor)

    # build the frame source
    if args.dataset == "synthetic":
        from orbslam2_tpu_torch import synthetic
        from orbslam2_tpu_torch.config import CameraConfig, TrackingConfig

        cfg = dataclasses.replace(
            cfg,
            camera=CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=240.0),
            tracking=TrackingConfig(th_depth=100.0),
        )
        n = args.frames or 40
        seq = synthetic.default_sequence(n_frames=n, kind="forward", cam=cfg.camera)

        def frames():
            for i in range(n):
                img, depth = seq.frame(i)
                yield ("rgbd", img, depth, i / 30.0)
    elif args.dataset == "tum":
        from orbslam2_tpu_torch.datasets import TumRgbdDataset

        # DepthMapFactor is applied exactly once (ORB-SLAM2 Tracking.cc:
        # 128-133): the dataset converts raw uint16 counts to meters, so the
        # pipeline must see factor 1.0, not divide a second time.
        ds = TumRgbdDataset(args.root, depth_factor=cfg.tracking.depth_map_factor or 5000.0)
        cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(cfg.tracking, depth_map_factor=1.0)
        )
        n = min(len(ds), args.frames) if args.frames else len(ds)

        def frames():
            for i in range(n):
                img, depth, t = ds[i]
                yield ("rgbd", img, depth, t)
    else:
        from orbslam2_tpu_torch.datasets import EurocDataset, KittiOdometryDataset

        ds = (KittiOdometryDataset if args.dataset == "kitti" else EurocDataset)(args.root)
        n = min(len(ds), args.frames) if args.frames else len(ds)

        def frames():
            for i in range(n):
                left, right, t = ds[i]
                yield ("stereo", left, right, t)

    slam = System(cfg, device=args.device, enable_loop_closing=not args.no_loop,
                  log_path=args.log)
    viewer = None
    if args.viz:
        from orbslam2_tpu_torch.viz.drawers import Viewer

        viewer = Viewer(cfg, args.viz)

    t0 = time.perf_counter()
    count = 0
    for kind, a, b, ts in frames():
        if cfg.sensor == Sensor.MONOCULAR:
            slam.track_monocular(a, timestamp=ts)
        elif kind == "rgbd":
            slam.track_rgbd(a, b, timestamp=ts)
        else:
            slam.track_stereo(a, b, timestamp=ts)
        if viewer is not None:
            t = slam.tracker
            tracked = (t.last_point_idx.cpu().numpy() >= 0 if t.last_point_idx is not None
                       else np.zeros(1, bool))
            xy = t.last_frame.xy.cpu().numpy() if t.last_frame is not None else np.zeros((1, 2))
            viewer.update(slam, a, xy, tracked)
        count += 1
        if count % 25 == 0:
            print(f"frame {count}/{n} state={slam.get_tracking_state().name} "
                  f"kfs={slam.num_keyframes()} pts={slam.num_points()}",
                  file=sys.stderr)
    dt = time.perf_counter() - t0

    slam.save_trajectory_tum(args.out)
    if args.kf_out:
        slam.save_keyframe_trajectory_tum(args.kf_out)
    if args.kitti_out:
        slam.save_trajectory_kitti(args.kitti_out)
    if args.save_map:
        slam.save_map(args.save_map)
    decoder, decoder_error = None, None
    if args.dataset != "synthetic":
        from orbslam2_tpu_torch.native import build_error, native_available

        decoder = "native" if native_available() else "pil"
        decoder_error = build_error()
    print(json.dumps({
        "frames": count,
        "fps": round(count / dt, 2),
        "state": slam.get_tracking_state().name,
        "keyframes": slam.num_keyframes(),
        "points": slam.num_points(),
        "loops_closed": slam.loop_closer.loops_closed if slam.loop_closer else 0,
        "events": slam.log.counts(),
        "trajectory": args.out,
        "device": torch.cuda.get_device_name(slam.device) if slam.device.type == "cuda" else "cpu",
        "decoder": decoder,
        "decoder_error": decoder_error,
    }))
    slam.log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
