"""local_ba.ms: host ms per keyframe inside `fused.local_ba_step` spans
of the traced run's span pass (a keyframe whose step runs no BA counts
with 0)."""


def read(t):
    ns = t.span_ns.get("local_ba")
    return ns / 1e6 / t.keyframes if ns and t.keyframes else None
