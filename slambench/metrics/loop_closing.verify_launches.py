"""loop_closing.verify_launches: CUDA launch calls inside the program's
`loop.verify` spans (one candidate's Sim3 chain, dispatched) in the
traced run's profiled pass, per verification there; nothing where the
pass verified no candidate."""

from slambench import program_trace


def read(t):
    return program_trace.launches_per(t, ("loop.verify",), "loop.verify")
