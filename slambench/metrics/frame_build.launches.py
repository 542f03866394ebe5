"""frame_build.launches: CUDA launch calls the host made inside the
program's `frame.build` spans (ORB extraction, depth seeding or the
stereo match) in the traced run's profiled pass, per profiled frame. A
launch call counts in the innermost program span whose interval holds
its start (`slambench/program_trace.py`)."""

from slambench import program_trace


def read(t):
    return program_trace.launches_per(t, ("frame.build",), "frame")
