"""mapping.keyframe_ms: host ms per keyframe inside the mapping spans
(`fused.keyframe_full_step`, local BA included, and
`LocalMapper.after_keyframe`) of the traced run's span pass."""


def read(t):
    ns = t.span_ns.get("mapping")
    return ns / 1e6 / t.keyframes if ns and t.keyframes else None
