"""The port's outcomes of the orbit sessions that `chip_smoke.py` drives,
through the smoke's own driver (`chip_smoke.run_orbit_session`), printed
as `tools/loop_reference_targets.py` prints the reference's, so the two
can be set side by side.

    python tools/loop_port_sessions.py orbit640|orbit320 [cuda|cpu] [OUT.json]

The session runs on the card unless `cpu` is given. One JSON line: loops
closed and the frame of each correction, frames lost and which, ATE over
the tracked frames, over all frames and over the orbit's frames alone,
keyframes and their frames, points, the Sim3 verifications and the wall
time. With OUT.json, the whole record goes there as well: every keyframe
decision with its inputs, every verification, the per-frame poses and
seconds, so two runs (the card and the CPU) can be compared decision by
decision, and against the reference's record of the 640x480 orbit
(`tools/orbit_reference_decisions.py compare`): `tracked_poses` are the
poses `track_rgbd` returned, before any later correction.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

CONFIGS = {"orbit640": chip_smoke.orbit640_config, "orbit320": chip_smoke.orbit320_config}


def main():
    name = sys.argv[1]
    device = torch.device(sys.argv[2] if len(sys.argv) > 2 else "cuda")
    out_path = sys.argv[3] if len(sys.argv) > 3 else None
    chip_smoke.start_render_pool()
    try:
        rec = chip_smoke.run_orbit_session(CONFIGS[name](), device)
    finally:
        chip_smoke.stop_render_pool()
    out = chip_smoke.orbit_outcome(rec)
    summary = dict(session=name, device=str(device), frames=len(rec["secs"]), **out,
                   verifications=rec["verifications"], warmup_s=rec["warmup_s"],
                   wall_s=float(np.sum(rec["secs"])))
    print(json.dumps(summary), flush=True)
    if out_path:
        _, poses, tracked = rec["slam"].frame_poses()
        with open(out_path, "w") as f:
            json.dump(dict(summary, decisions=rec["decisions"], secs=rec["secs"],
                           slice_frames=rec["slice_frames"], poses=poses.tolist(),
                           tracked=tracked.tolist(),
                           tracked_poses=[r.Tcw.tolist() for r in rec["slam"].results],
                           gt_poses=rec["seq"].poses.tolist()), f)


if __name__ == "__main__":
    main()
