"""frame_build.ms: host ms per frame inside the frame-build spans (ORB
extraction, depth seeding or the stereo match, undistortion) of the
traced run's span pass."""


def read(t):
    ns = t.span_ns.get("frame_build")
    return ns / 1e6 / t.frames if ns and t.frames else None
