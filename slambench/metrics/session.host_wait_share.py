"""session.host_wait_share: the share (%) of the profiled pass's frame
time that the host spent inside CUDA calls that wait for the device
(stream, device and event synchronisation, memory copies), each call
counted in the frame its start falls in (`bench.host_wait`'s arithmetic)."""

import bisect


def read(t):
    prof = t.profile
    if prof is None or t.device_type != "cuda":
        return None
    frames = prof["ranges"].get("frame", [])
    if not frames:
        return None
    starts = [s for s, _ in frames]
    wait = 0
    for start, dur in prof["waits"]:
        j = bisect.bisect_right(starts, start) - 1
        if j >= 0 and start < frames[j][1]:
            wait += dur
    total = sum(e - s for s, e in frames)
    return 100.0 * wait / total if total else None
