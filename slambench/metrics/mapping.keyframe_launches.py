"""mapping.keyframe_launches: CUDA launch calls inside the program's
`mapping.keyframe` (`fused.keyframe_full_step`, local BA included) and
`mapping.after_keyframe` spans in the traced run's profiled pass, per
keyframe step there; nothing where the pass made no keyframe."""

from slambench import program_trace


def read(t):
    return program_trace.launches_per(t, ("mapping.keyframe", "mapping.after_keyframe"),
                                      "mapping.keyframe")
