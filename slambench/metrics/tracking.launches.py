"""tracking.launches: CUDA launch calls inside the program's
`tracking.step` spans (`fused.track_step`: the coarse stages and the
local-map passes) in the traced run's profiled pass, per profiled
frame."""

from slambench import program_trace


def read(t):
    return program_trace.launches_per(t, ("tracking.step",), "frame")
