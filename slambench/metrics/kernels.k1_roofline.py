"""kernels.k1_roofline: K1's (`csrc/hamming.cu`) share (%) of its
roofline over the profiled pass: the least time the card could take for
every launch at its shapes (`slambench/roofline.py`) over the kernel's
device time in the trace. Where the trace holds fewer kernels than the
wrapper launched, the bound is scaled to the traced share."""

from slambench import roofline


def read(t):
    traced, ns = t.kernel("k1")
    if not t.k1 or not traced or not ns:
        return None
    bound = sum(roofline.k1_bound_s(n, m) for n, m in t.k1) * min(1.0, traced / len(t.k1))
    return 100.0 * bound / (ns / 1e9)
