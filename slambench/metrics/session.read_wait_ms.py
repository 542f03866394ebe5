"""session.read_wait_ms: host ms per frame of the traced run's span pass
inside the program's read spans (`session.decision_read`,
`tracking.coarse_read`, `mapping.outputs_read`, `loop.detect_read`,
`loop.verify_read`: every span named `*_read`), where the host waits for
the card's work by design."""

from slambench import program_trace


def read(t):
    return program_trace.read_wait_ms(t)
