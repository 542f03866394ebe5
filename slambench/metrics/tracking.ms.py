"""tracking.ms: host ms per frame inside `fused.track_step` spans of the
traced run's span pass."""


def read(t):
    ns = t.span_ns.get("tracking")
    return ns / 1e6 / t.frames if ns and t.frames else None
