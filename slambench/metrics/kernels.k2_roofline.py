"""kernels.k2_roofline: K2's (`csrc/pose_gn.cu`) share (%) of its
roofline over the profiled pass: the least time for every launch at its
slots, real observations and iterations (`slambench/roofline.py`) over the
kernel's device time in the trace, scaled as K1's where the trace holds
fewer kernels than were launched."""

from slambench import roofline


def read(t):
    traced, ns = t.kernel("k2")
    if not t.k2 or not traced or not ns:
        return None
    bound = sum(roofline.k2_bound_s(n, e, r, i) for n, e, r, i in t.k2)
    bound *= min(1.0, traced / len(t.k2))
    return 100.0 * bound / (ns / 1e9)
