"""localize.track_step_share: the span pass's `fused.track_step` calls (the
benchmark's `tracking` span) over its window frames, in %: the share of
frames the frozen map held on the fused step. The rest took the
localization-mode odometry (mbVO) or relocalization, which do not run
the track step."""


def read(t):
    if not t.frames:
        return None
    return 100.0 * t.span_count.get("tracking", 0) / t.frames
