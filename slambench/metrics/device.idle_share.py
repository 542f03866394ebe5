"""device.idle_share: 1 minus the union of every device operation's
interval over the profiled pass's window (its first frame's hand-off to
its last frame's pose), in %."""


def read(t):
    if t.profile is None or t.window is None or not t.profile["device"]:
        return None
    lo, hi = t.window
    return 100.0 * (1.0 - t.busy_ns() / (hi - lo))
