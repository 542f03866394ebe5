"""loop_closing.verify_ms: host ms per Sim3 verification of a loop
candidate (`loop_closing._verify_candidate`, the whole ComputeSim3 chain
dispatched on one frame) in the traced run's span pass; nothing where
the pass verified no candidate."""


def read(t):
    ns = t.span_ns.get("loop_closing")
    n = t.span_count.get("loop_closing", 0)
    return ns / 1e6 / n if ns and n else None
