"""Faults planted under the timed path, to show that `correct` fails:
the program's functions rebound for the duration of a `with plant(name):`
block and restored after it. The program's files are not edited.

* `unchanged`: the tracking step returns its state unchanged (the pose it
  was handed);
* `half`: half of the batch left out (every other keypoint's descriptor
  never computed);
* `altered_pose`: an answer altered where it is produced (the pose a
  frame returns moved by 10 cm on every fifth frame);
* `altered_depth`: the frame build's keypoint depths 10 % long;
* `altered_map`: the keyframe step's answers moved 10 cm where it
  produces them (the new keyframe's pose and the points it made).

Cells run on one chip, so there is no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered_pose", "altered_depth", "altered_map")


@contextlib.contextmanager
def plant(name: str):
    from orbslam2_tpu_torch.ops.orb import OrbExtractor
    from orbslam2_tpu_torch.pipeline import fused
    from orbslam2_tpu_torch.pipeline.system import System

    restore = []

    def rebind(owner, attr, new):
        restore.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    if name == "unchanged":
        step = fused.track_step

        def unchanged(*args, **kwargs):
            return step(*args, **kwargs)._replace(Tcw=args[7].clone())

        rebind(fused, "track_step", unchanged)
    elif name == "half":
        forward = OrbExtractor.forward

        def half(self, image):
            out = forward(self, image)
            desc = out.desc.clone()
            desc[1::2] = 0
            return out._replace(desc=desc)

        rebind(OrbExtractor, "forward", half)
    elif name == "altered_pose":
        calls = [0]
        for attr in ("track_rgbd", "track_stereo"):
            track = getattr(System, attr)

            def altered(self, a, b, timestamp=0.0, _track=track):
                pose = _track(self, a, b, timestamp).copy()
                calls[0] += 1
                if calls[0] % 5 == 0:
                    pose[0, 3] += 0.1
                return pose

            rebind(System, attr, altered)
    elif name == "altered_depth":
        for attr in ("rgbd_frame", "stereo_frame"):
            build = getattr(fused, attr)

            def longer(*args, _build=build, **kwargs):
                f = _build(*args, **kwargs)
                return f._replace(depth=f.depth * 1.1)

            rebind(fused, attr, longer)
    elif name == "altered_map":
        step = fused.keyframe_full_step

        def moved(state, *args, **kwargs):
            out = step(state, *args, **kwargs)
            kf_id, new_pids = out[0], out[1]
            state.kf_Tcw[kf_id, 0, 3] += 0.1
            made = new_pids[new_pids >= 0].long()
            state.mp_pos[made, 0] += 0.1
            return out

        rebind(fused, "keyframe_full_step", moved)
    else:
        raise ValueError(f"unknown fault {name!r} (one of {FAULTS})")
    try:
        yield
    finally:
        while restore:
            owner, attr, old = restore.pop()
            setattr(owner, attr, old)
